"""Tokenizer facade: one interface over the two tokenizer families (copies
of ggllm_tpu/tokenizer/: bpe.py, unicode.py, _class_overrides.py, spm.py).

* Falcon GGCC files carry a GPT-2 byte-level BPE vocab + ranked merges
  (tokenizer/bpe.py, libfalcon.cpp:2622-3016);
* LLaMA files carry a SentencePiece-style scored vocab
  (tokenizer/spm.py, llama.cpp:1788-1930).
"""

from __future__ import annotations

from dataclasses import dataclass

from ggllm_tpu_torch.tokenizer import bpe, spm


@dataclass
class Tokenizer:
    vocab: bpe.Vocab
    arch: str = "falcon"

    @property
    def _family(self):
        return spm if self.arch == "llama" else bpe

    @property
    def bos_id(self) -> int:
        return self._family.BOS_ID

    @property
    def eos_id(self) -> int:
        return self._family.EOS_ID

    def tokenize(self, text: str, bos: bool = False) -> list[int]:
        return self._family.tokenize(self.vocab, text, bos=bos)

    def piece(self, tok: int) -> bytes:
        return self.vocab.id_to_token[tok]

    def detokenize(self, ids) -> bytes:
        return self._family.detokenize(self.vocab, ids)


def nl_id(arch: str) -> int:
    """Newline token id of a family's vocabulary: Falcon's BPE 193 ("Ċ",
    falcon_token_nl), LLaMA's byte token <0x0A> = 13 (llama_token_nl)."""
    return (spm if arch == "llama" else bpe).NL_ID


def for_model(mf) -> Tokenizer:
    """ModelFile -> Tokenizer matching its architecture."""
    return Tokenizer(vocab=mf.vocab, arch=mf.arch)
