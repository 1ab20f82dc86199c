"""The hand-written kernels as torch library ops in the namespace `ggllm`
(torch.ops.ggllm.*), so that a tracer sees each kernel call as one node
under its own name and schema (torch.export: engine/engine.py
FalconEngine.export and the CLI's --export).

| op | Python entry | CUDA implementation | CPU implementation |
|---|---|---|---|
| quant_matmul | quant_matmul.quant_matmul | quant_matmul_cuda (every route) | quant_matmul_plain |
| quant_matmul_tc | quant_matmul.quant_matmul_tc | quant_matmul_tc_cuda | none |
| group_sums | quant_matmul.group_sums | group_sums_cuda | group_sums_plain |
| flash_mqa | flash_attention.flash_mqa | flash_mqa_cuda | flash_mqa_plain |
| flash_decode | flash_decode.flash_decode | flash_decode_cuda | flash_decode_plain |

The entries keep their names and signatures. Under a tracer
(torch.compiler.is_compiling(), which torch.export sets) they call the ops;
an eager call goes straight to the same implementation, since a call
through the dispatcher cost 5-26 us more than the launcher called directly
on an H100 machine's host (tools/time_kernels.py dispatch; PERF.md): at
130-160 kernel calls a 300-token Falcon-7B prefill chunk, up to 10 % of its
26 ms where the device does not hide the host's work. That is a bound from
the per-call timing; no prefill regression was resolved in its noise.
Operands are tensors and plain values: a QuantTensor enters as its planes
in the order of quant_matmul._ARGS (`plane_args`: None where the format has
no such plane) with its format, O and K; an int8 cache as its codes and
scales, a dense one as one tensor and scales None; n_past as a (B,) int
tensor or, with that None, an int. The CUDA implementation is the launcher,
which counts its launches (build.launch); the CPU implementation serves CPU
tensors only; the fake implementation gives the launcher's output shape and
dtype and touches no data. No op writes an operand (the flash-decode workspace and its arrival
counters are tensors of the CUDA implementation, never operands), so no
write of a kernel escapes a traced graph.

The namespace is defined once a process: a second import of this module
(importlib.reload) finds the ops and registers nothing again.
"""

from __future__ import annotations

import torch

from ggllm_tpu_torch.kernels import flash_attention as fa
from ggllm_tpu_torch.kernels import flash_decode as fd
from ggllm_tpu_torch.kernels import quant_matmul as qm

NAMESPACE = "ggllm"
_PLANES = "Tensor? qs, Tensor? qh, Tensor? d, Tensor? m, Tensor? sc, Tensor? scm"
SCHEMAS = {
    "quant_matmul": f"(Tensor x, {_PLANES}, Tensor? xg, int gtype, int O, int K,"
                    " ScalarType out_dtype) -> Tensor",
    "quant_matmul_tc": f"(Tensor x, {_PLANES}, int gtype, int O, int K,"
                       " ScalarType out_dtype) -> Tensor",
    "group_sums": "(Tensor x, int g) -> Tensor",
    "flash_mqa": "(Tensor q, Tensor k, Tensor v, Tensor? n_past_vec, int n_past) -> Tensor",
    "flash_decode": "(Tensor kv, Tensor? scales, int KV, int layer, Tensor q,"
                    " Tensor? n_past_vec, int n_past, Tensor? kv_append, int? append_valid)"
                    " -> Tensor",
}


def _quant_matmul_cpu(x, qs, qh, d, m, sc, scm, xg, gtype, O, K, out_dtype):
    from ggllm_tpu_torch.ops.linear import QuantTensor  # ops.linear imports the kernels

    w = QuantTensor(gtype, (O, K), qm.arg_planes(gtype, (qs, qh, d, m, sc, scm)))
    return qm.quant_matmul_plain(w, x, out_dtype)


def _quant_matmul_cuda(x, qs, qh, d, m, sc, scm, xg, gtype, O, K, out_dtype):
    return qm.quant_matmul_cuda(x, (qs, qh, d, m, sc, scm), xg, gtype, O, K, out_dtype)


def _quant_matmul_fake(x, qs, qh, d, m, sc, scm, xg, gtype, O, K, out_dtype):
    return x.new_empty((*x.shape[:-1], O), dtype=out_dtype)


def _quant_matmul_tc_cuda(x, qs, qh, d, m, sc, scm, gtype, O, K, out_dtype):
    return qm.quant_matmul_tc_cuda(x, (qs, qh, d, m, sc, scm), gtype, O, K, out_dtype)


def _quant_matmul_tc_fake(x, qs, qh, d, m, sc, scm, gtype, O, K, out_dtype):
    return x.new_empty((*x.shape[:-1], O), dtype=out_dtype)


def _group_sums_fake(x, g):
    return x.new_empty((x.shape[0], x.shape[1] // g), dtype=torch.float32)


def _n_past(n_past_vec, n_past):
    return n_past if n_past_vec is None else n_past_vec


def _flash_mqa_cpu(q, k, v, n_past_vec, n_past):
    return fa.flash_mqa_plain(q, k, v, _n_past(n_past_vec, n_past))


def _flash_mqa_cuda(q, k, v, n_past_vec, n_past):
    return fa.flash_mqa_cuda(q, k, v, _n_past(n_past_vec, n_past))


def _flash_mqa_fake(q, k, v, n_past_vec, n_past):
    return torch.empty_like(q)


def _cache(kv, scales):
    return kv if scales is None else (kv, scales)


def _flash_decode_cpu(kv, scales, KV, layer, q, n_past_vec, n_past, kv_append, append_valid):
    return fd.flash_decode_plain(_cache(kv, scales), KV, layer, q, _n_past(n_past_vec, n_past),
                                 kv_append, append_valid)


def _flash_decode_cuda(kv, scales, KV, layer, q, n_past_vec, n_past, kv_append, append_valid):
    return fd.flash_decode_cuda(_cache(kv, scales), KV, layer, q, _n_past(n_past_vec, n_past),
                                kv_append, append_valid)


def _flash_decode_fake(kv, scales, KV, layer, q, n_past_vec, n_past, kv_append, append_valid):
    return q.new_empty(q.shape)  # (B, 1, H, D), computed in the route's dtype, cast to q's


# op -> (CUDA implementation, CPU implementation or None, fake implementation)
IMPLS = {
    "quant_matmul": (_quant_matmul_cuda, _quant_matmul_cpu, _quant_matmul_fake),
    "quant_matmul_tc": (_quant_matmul_tc_cuda, None, _quant_matmul_tc_fake),
    "group_sums": (qm.group_sums_cuda, qm.group_sums_plain, _group_sums_fake),
    "flash_mqa": (_flash_mqa_cuda, _flash_mqa_cpu, _flash_mqa_fake),
    "flash_decode": (_flash_decode_cuda, _flash_decode_cpu, _flash_decode_fake),
}


def _register() -> None:
    for name, schema in SCHEMAS.items():
        qualname = f"{NAMESPACE}::{name}"
        torch.library.define(qualname, schema)
        cuda, cpu, fake = IMPLS[name]
        torch.library.impl(qualname, "cuda", cuda)
        if cpu is not None:
            torch.library.impl(qualname, "cpu", cpu)
        torch.library.register_fake(qualname, fake)


if not hasattr(getattr(torch.ops, NAMESPACE), next(iter(SCHEMAS))):
    _register()
