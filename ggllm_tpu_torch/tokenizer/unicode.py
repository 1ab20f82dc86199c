"""Codepoint classification for the Falcon pretokenizer.

The pretokenizer (see bpe.py) only distinguishes four classes: DIGIT, LETTER,
WHITESPACE and everything-else. Classification matches the reference's range
tables (cmpnct_unicode.cpp:get_code_type, projected onto this 4-way split):
we derive it from unicodedata and patch the residual disagreements with a
generated override table (_class_overrides.py).
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache

from ggllm_tpu_torch.tokenizer._class_overrides import OVERRIDE_RANGES

DIGIT = 0
LETTER = 1
WHITESPACE = 2
OTHER = 3

_EXTRA_WS = set("\t\n\x0b\x0c\r\x1c\x1d\x1e\x1f\x85")

# flatten override ranges into a dict (only ~5k codepoints)
_OVERRIDES: dict[int, int] = {}
for _s, _e, _t in OVERRIDE_RANGES:
    for _c in range(_s, _e + 1):
        _OVERRIDES[_c] = _t


@lru_cache(maxsize=8192)
def char_class(ch: str) -> int:
    """4-way character class of a single unicode character."""
    c = ord(ch)
    ov = _OVERRIDES.get(c)
    if ov is not None:
        return ov
    cat = unicodedata.category(ch)
    if cat.startswith("L"):
        return LETTER
    if cat == "Nd":
        return DIGIT
    if cat in ("Zs", "Zl", "Zp") or ch in _EXTRA_WS:
        return WHITESPACE
    return OTHER
