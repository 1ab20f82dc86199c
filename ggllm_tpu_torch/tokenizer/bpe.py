"""Falcon GPT-2-style byte-level BPE tokenizer.

Re-implements the reference tokenizer's observable behavior exactly
(libfalcon.cpp:2622-3016): the hand-rolled GPT-2 pretokenizer state machine,
byte->unicode encoding, rank-ordered bigram merging with (rank, left-position)
priority, special-token interception, and byte-level fallback for unknown
tokens. Quirks of the reference are replicated on purpose (tokenizer drift
changes perplexity):

* the 3-byte contraction test uses OR where GPT-2's regex implies AND, so
  ``'`` followed by r/v/l (next) or e/l (next-next) splits as a 3-char token
  (libfalcon.cpp:2822-2828);
* a word's trailing character is appended before the final split, so e.g.
  ``"ab "`` pretokenizes to one word including the trailing space
  (libfalcon.cpp:2924-2940);
* special tokens are matched at every character position, interrupting any
  word in progress (libfalcon.cpp:2787-2817).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
import heapq

from ggllm_tpu_torch.tokenizer import unicode as ucls

# Falcon uses <|endoftext|> (id 11) for both BOS and EOS
# (libfalcon.cpp:4684-4692); newline token is 193, CR is 195.
BOS_ID = 11
EOS_ID = 11
NL_ID = 193
CR_ID = 195


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """Standard GPT-2 byte -> unicode-char mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


@dataclass
class Vocab:
    """Token vocabulary + BPE merge ranks.

    Tokens are raw byte strings (the GGCC vocab stores real 0x20 spaces);
    merges are in byte-encoded (Ġ/Ċ) form, as stored in the model file.
    """

    id_to_token: list[bytes]
    scores: list[float]
    merges: list[tuple[str, str]]
    token_to_id: dict[bytes, int] = field(default_factory=dict)
    bpe_ranks: dict[tuple[str, str], int] = field(default_factory=dict)
    special_tokens: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.token_to_id:
            # last one wins on duplicates, matching std::map::operator[] insertion
            self.token_to_id = {tok: i for i, tok in enumerate(self.id_to_token)}
        if not self.bpe_ranks:
            # first rank wins on duplicates (std::map::emplace keeps existing)
            for i, pair in enumerate(self.merges):
                self.bpe_ranks.setdefault(pair, i)
        if not self.special_tokens:
            # ids 0-11 plus any id >= 65024 are special (libfalcon.cpp:322-328)
            for i in range(min(12, len(self.id_to_token))):
                self.special_tokens[self.id_to_token[i].decode("utf-8", "replace")] = i
            for i in range(65024, len(self.id_to_token)):
                self.special_tokens[self.id_to_token[i].decode("utf-8", "replace")] = i

    @property
    def n_vocab(self) -> int:
        return len(self.id_to_token)


def _find_bpe_rank(vocab: Vocab, left: str, right: str) -> int:
    # the reference normalizes literal space/newline to Ġ/Ċ before lookup
    lt = left.replace(" ", "Ġ").replace("\n", "Ċ")
    rt = right.replace(" ", "Ġ").replace("\n", "Ċ")
    return vocab.bpe_ranks.get((lt, rt), -1)


def pretokenize(text: str, special_tokens: dict[str, int]) -> list[str]:
    """Split text into pre-tokens, byte-encoded (the GPT-2 regex emulation)."""
    enc = bytes_to_unicode()
    words: list[str] = []
    token = ""
    # state machine flags
    collecting = False
    col_letter = col_digit = col_special = col_ws_la = False

    # specials sorted lexicographically: std::map iteration order, first match wins
    specials = sorted(special_tokens.keys())
    min_special = min((len(s) for s in specials), default=0)

    chars = text
    n = len(chars)
    cls = [ucls.char_class(c) for c in chars]

    def reset_flags():
        nonlocal collecting, col_letter, col_digit, col_special, col_ws_la
        collecting = col_letter = col_digit = col_special = col_ws_la = False

    i = 0
    while i < n:
        ch = chars[i]
        ct = cls[i]
        nxt = chars[i + 1] if i + 1 < n else ""
        nct = cls[i + 1] if i + 1 < n else None
        nnxt = chars[i + 2] if i + 2 < n else ""

        # special-token interception at any position
        if specials and n - i >= min_special:
            matched = None
            for sp in specials:
                if chars.startswith(sp, i):
                    matched = sp
                    break
            if matched is not None:
                if token:
                    words.append(token)
                    token = ""
                    reset_flags()
                words.append(matched)
                i += len(matched)
                continue

        # contractions: 's 't 'm 'd
        if ch == "'" and i + 1 < n and nxt in "stmd":
            if token:
                words.append(token)
            words.append(ch + nxt)
            token = ""
            reset_flags()
            i += 2
            continue
        # 're 've 'll — with the reference's OR-condition quirk
        if (
            ch == "'"
            and i + 2 < n
            and (nxt in ("r", "v", "l") or nnxt in ("e", "l"))
        ):
            if token:
                words.append(token)
            words.append(ch + nxt + nnxt)
            token = ""
            reset_flags()
            i += 3
            continue

        split = False
        if not collecting:
            if ct == ucls.LETTER or (not token and ch == " " and nct == ucls.LETTER):
                col_letter = True
                collecting = True
            elif ct == ucls.DIGIT or (not token and ch == " " and nct == ucls.DIGIT):
                col_digit = True
                collecting = True
            elif (ct not in (ucls.LETTER, ucls.DIGIT, ucls.WHITESPACE)) or (
                not token
                and ch == " "
                and nct is not None
                and nct not in (ucls.LETTER, ucls.DIGIT, ucls.WHITESPACE)
            ):
                col_special = True
                collecting = True
            elif ct == ucls.WHITESPACE and nct == ucls.WHITESPACE:
                col_ws_la = True
                collecting = True
            elif ct == ucls.WHITESPACE:
                split = True
        else:
            if col_letter and ct != ucls.LETTER:
                split = True
            elif col_digit and ct != ucls.DIGIT:
                split = True
            elif col_special and ct in (ucls.LETTER, ucls.DIGIT, ucls.WHITESPACE):
                split = True
            elif col_ws_la and nct != ucls.WHITESPACE:
                split = True

        if i + 1 >= n:  # final char is appended before the split flush
            split = True
            token += ch

        if split:
            if token:
                words.append(token)
            token = ch
            reset_flags()
        else:
            token += ch
        i += 1

    # byte-encode every word (specials are ASCII, unchanged by the mapping)
    out = []
    for w in words:
        out.append("".join(enc[b] for b in w.encode("utf-8")))
    return out


def _bpe_word(word: str, vocab: Vocab) -> list[str]:
    """Merge one byte-encoded word into BPE tokens (rank-ordered)."""
    symbols = list(word)
    n = len(symbols)
    if n == 0:
        return []
    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    alive = [True] * n

    heap: list[tuple[int, int, int, str]] = []
    counter = 0

    def add_bigram(left: int, right: int):
        nonlocal counter
        if left == -1 or right == -1:
            return
        rank = _find_bpe_rank(vocab, symbols[left], symbols[right])
        if rank < 0:
            return
        heap.append((rank, left, counter, symbols[left] + symbols[right]))
        counter += 1

    for i in range(1, n):
        add_bigram(i - 1, i)
    heapq.heapify(heap)

    while heap:
        rank, left, _, text = heapq.heappop(heap)
        right = nxt[left]
        if not alive[left] or right == -1 or not alive[right]:
            continue
        if symbols[left] + symbols[right] != text:
            continue  # outdated entry
        symbols[left] = text
        alive[right] = False
        nxt[left] = nxt[right]
        if nxt[right] >= 0:
            prv[nxt[right]] = left
        ab = []
        if prv[left] != -1:
            ab.append((prv[left], left))
        if nxt[left] != -1:
            ab.append((left, nxt[left]))
        for l, r in ab:
            rk = _find_bpe_rank(vocab, symbols[l], symbols[r])
            if rk >= 0:
                heapq.heappush(heap, (rk, l, counter, symbols[l] + symbols[r]))
                counter += 1

    return [symbols[i] for i in range(n) if alive[i]]


def decode_token(token: str) -> bytes:
    """Byte-encoded token string -> raw bytes."""
    dec = unicode_to_bytes()
    return bytes(dec[c] for c in token)


def tokenize(vocab: Vocab, text: str, bos: bool = False) -> list[int]:
    """Text -> token ids (falcon_tokenize equivalent, libfalcon.cpp:3018)."""
    if not text:
        return []
    out: list[int] = []
    if bos:
        out.append(BOS_ID)
    for word in pretokenize(text, vocab.special_tokens):
        if word in vocab.special_tokens:
            pieces = [word]
        else:
            pieces = _bpe_word(word, vocab)
        for piece in pieces:
            raw = decode_token(piece)
            tid = vocab.token_to_id.get(raw)
            if tid is not None:
                out.append(tid)
            else:
                for b in raw:  # byte-level fallback
                    bid = vocab.token_to_id.get(bytes([b]))
                    if bid is not None:
                        out.append(bid)
    return out


def detokenize(vocab: Vocab, ids) -> bytes:
    """Token ids -> raw bytes (caller decides how to decode utf-8)."""
    return b"".join(vocab.id_to_token[int(i)] for i in ids)
