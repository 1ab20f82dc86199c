"""Falcon byte-level BPE tokenizer (copies of ggllm_tpu/tokenizer/bpe.py,
unicode.py and _class_overrides.py; the LLaMA SentencePiece path is not
ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

from ggllm_tpu_torch.tokenizer import bpe


@dataclass
class Tokenizer:
    vocab: bpe.Vocab

    bos_id = bpe.BOS_ID
    eos_id = bpe.EOS_ID

    def tokenize(self, text: str, bos: bool = False) -> list[int]:
        return bpe.tokenize(self.vocab, text, bos=bos)

    def piece(self, tok: int) -> bytes:
        return self.vocab.id_to_token[tok]

    def detokenize(self, ids) -> bytes:
        return bpe.detokenize(self.vocab, ids)


def for_model(mf) -> Tokenizer:
    """ModelFile -> Tokenizer. Only Falcon (GGCC) files are ported."""
    if mf.arch != "falcon":
        raise NotImplementedError(f"tokenizer for arch {mf.arch!r} is not ported")
    return Tokenizer(vocab=mf.vocab)
