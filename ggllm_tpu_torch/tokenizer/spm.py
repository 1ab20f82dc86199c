"""SentencePiece-style tokenizer for the LLaMA family.

Mirrors llama_tokenizer (llama.cpp:1788-1930): split text into UTF-8
characters, then greedily merge the adjacent pair whose merged string is the
vocab token with the highest score (ties broken by leftmost position);
characters that never merge into a vocab token fall back to byte tokens
(id = byte + 3). BOS=1, EOS=2, UNK=0.

Detokenization is raw byte concatenation — converted GGML vocabs store
pieces with real spaces (convert.py replaced U+2581 at conversion time).
"""

from __future__ import annotations

import heapq

BOS_ID = 1
EOS_ID = 2
UNK_ID = 0
BYTE_OFFSET = 3  # byte b encodes as token id b + 3
NL_ID = BYTE_OFFSET + 10  # the byte token <0x0A> (llama_token_nl)


def _utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if b >> 5 == 0b110:
        return 2
    if b >> 4 == 0b1110:
        return 3
    if b >> 3 == 0b11110:
        return 4
    return 1


def tokenize(vocab, text: str | bytes, bos: bool = False) -> list[int]:
    """vocab: tokenizer.bpe.Vocab (uses id_to_token bytes + scores)."""
    data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    out: list[int] = [BOS_ID] if bos else []
    if not data:
        return out

    token_to_id = getattr(vocab, "_sp_token_to_id", None)
    if token_to_id is None or len(token_to_id) != len(vocab.id_to_token):
        token_to_id = {t: i for i, t in enumerate(vocab.id_to_token)}
        try:
            vocab._sp_token_to_id = token_to_id  # cache on the instance
        except AttributeError:
            pass
    scores = vocab.scores

    # symbol chain: list of (start, length); length 0 = merged away
    sym_start: list[int] = []
    sym_len: list[int] = []
    i = 0
    while i < len(data):
        n = min(_utf8_len(data[i]), len(data) - i)
        sym_start.append(i)
        sym_len.append(n)
        i += n
    prev = list(range(-1, len(sym_start) - 1))
    nxt = list(range(1, len(sym_start) + 1))
    nxt[-1] = -1

    # priority queue of candidate merges: (-score, left_index, size)
    heap: list[tuple[float, int, int]] = []

    def try_add(left: int, right: int):
        if left == -1 or right == -1:
            return
        merged = bytes(data[sym_start[left] : sym_start[right] + sym_len[right]])
        tid = token_to_id.get(merged)
        if tid is None or tid >= len(scores):
            return
        heapq.heappush(heap, (-scores[tid], left, len(merged)))

    for i in range(1, len(sym_start)):
        try_add(i - 1, i)

    while heap:
        _, left, size = heapq.heappop(heap)
        right = nxt[left]
        if right == -1 or sym_len[left] == 0 or sym_len[right] == 0:
            continue
        if sym_len[left] + sym_len[right] != size:
            continue  # stale entry: one side already merged
        sym_len[left] += sym_len[right]
        sym_len[right] = 0
        nxt[left] = nxt[right]
        if nxt[right] != -1:
            prev[nxt[right]] = left
        try_add(prev[left], left)
        try_add(left, nxt[left])

    i = 0
    while i != -1:
        piece = bytes(data[sym_start[i] : sym_start[i] + sym_len[i]])
        tid = token_to_id.get(piece)
        if tid is None:
            out.extend(b + BYTE_OFFSET for b in piece)  # byte fallback
        else:
            out.append(tid)
        i = nxt[i]
    return out


def detokenize(vocab, ids) -> bytes:
    return b"".join(vocab.id_to_token[int(t)] for t in ids)
