"""Perplexity evaluation, reference protocol (the port's copy of
ggllm_tpu/engine/perplexity.py).

Replicates falcon_perplexity (examples/falcon_perplexity/falcon_perplexity.cpp:
28-120): tokenize the whole text (with BOS), split into n_ctx chunks, eval each
chunk with logits_all (each chunk starts at n_past=0), accumulate NLL over
window positions j in [min(512, n_ctx/2), n_ctx-1), ppl = exp(nll/count).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class PerplexityResult:
    ppl: float
    nll: float
    count: int
    n_chunks: int
    per_chunk: list


def perplexity(engine, tokens, progress=None, max_chunks: int = 0) -> PerplexityResult:
    """Compute wikitext-style perplexity. `engine` is a FalconEngine.

    Next-token log-probabilities come from engine.eval_logprobs: the
    log-softmax gather runs on the engine's device, so each chunk transfers
    n_ctx floats instead of the full (n_ctx, n_vocab) logits."""
    tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
    n_ctx = engine.cfg.n_ctx
    n_chunk = tokens.size // n_ctx
    if max_chunks:
        n_chunk = min(n_chunk, max_chunks)
    if n_chunk == 0:
        raise ValueError(f"need at least n_ctx={n_ctx} tokens, got {tokens.size}")

    nll = 0.0
    count = 0
    per_chunk = []
    first_j = min(512, n_ctx // 2)

    for i in range(n_chunk):
        start = i * n_ctx
        chunk = tokens[start:start + n_ctx]
        engine.reset()
        lp = engine.eval_logprobs(chunk)  # (n_ctx - 1,)
        nll += float(-lp[first_j:n_ctx - 1].astype(np.float64).sum())
        count += n_ctx - 1 - first_j
        ppl_so_far = math.exp(nll / count)
        per_chunk.append(ppl_so_far)
        if progress:
            progress(i + 1, n_chunk, ppl_so_far)

    return PerplexityResult(
        ppl=math.exp(nll / count), nll=nll, count=count, n_chunks=n_chunk,
        per_chunk=per_chunk,
    )
