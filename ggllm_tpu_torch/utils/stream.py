"""Streaming stop-string handling for the CLI (the port's copy of
ggllm_tpu/utils/stream.py, held to it by tests/test_torch_generator.py).

The reference matches stopwords as byte suffixes over the accumulated
generation (falcon_main.cpp:1022-1056) and the server holds back any tail
that could still become a stop string so a stop word split across tokens is
never leaked (server.cpp streaming path). StopStream implements both.
"""

from __future__ import annotations


def partial_stop(text: bytes, stops: list[bytes]) -> int:
    """Longest tail of `text` that is a proper prefix of some stop string."""
    best = 0
    for s in stops:
        for k in range(1, min(len(s), len(text)) + 1):
            if text.endswith(s[:k]):
                best = max(best, k)
    return best


class StopStream:
    """Accumulates generated bytes, releasing only text that can no longer be
    part of a stop string; detects stopwords (suppressed from output) and
    antiprompts (emitted, then generation stops)."""

    def __init__(self, stops: list[bytes] = (), antiprompts: list[bytes] = ()):
        self.stops = [s for s in stops if s]
        self.anti = [a for a in antiprompts if a]
        self.text = b""
        self.sent = 0
        self.stop_reason: str | None = None
        self.stop_match: bytes | None = None  # which stop/antiprompt fired

    @property
    def stopped(self) -> bool:
        return self.stop_reason is not None

    def push(self, piece: bytes) -> bytes:
        """Add one decoded token's bytes. Returns newly releasable bytes
        (possibly empty). After a stop match, further pushes release b''."""
        if self.stopped:
            return b""
        self.text += piece
        hit = next((s for s in self.stops if s in self.text), None)
        if hit is not None:
            self.text = self.text[: self.text.index(hit)]
            self.stop_reason = "stopword"
            self.stop_match = hit
            out = self.text[self.sent :]
            self.sent = len(self.text)
            return out
        anti_hit = next((a for a in self.anti if self.text.endswith(a)), None)
        if anti_hit is not None:
            self.stop_reason = "antiprompt"
            self.stop_match = anti_hit
            out = self.text[self.sent :]
            self.sent = len(self.text)
            return out
        hold = partial_stop(self.text, self.stops)
        ready = len(self.text) - hold
        out = self.text[self.sent : ready] if ready > self.sent else b""
        self.sent = max(self.sent, ready)
        return out

    def flush(self) -> bytes:
        """Release any held-back tail (call when generation ends without a
        stop match)."""
        out = self.text[self.sent :]
        self.sent = len(self.text)
        return out
