"""falcon_quantize / llama quantize equivalent on the port (port of
ggllm_tpu/tools/quantize.py): requantize a model file.

    python -m ggllm_tpu_torch.tools.quantize model-f16.ggcc model-q4_0.ggcc q4_0

Policy mirrors falcon_model_quantize_internal (libfalcon.cpp:3533-3743):
quantize 2-D tensors whose name ends with 'weight'; lm_head only when
--quantize-output; K-quants require dims divisible by 256 (Falcon-7B's
4544-wide tensors are not — use legacy types there, libfalcon.cpp:3626-3635).

LLaMA (GGJT) files re-write as GGJT v3 and apply the reference's mixed
K-type policy (llama.cpp:2495-2513): output.weight upgrades to Q6_K;
attention.wv / feed_forward.w2 upgrade per ftype and layer position (the
`use_more_bits` pattern); attention.wo upgrades for the low-bit ftypes.

The quantizers are the port's C++ codecs (quant/native.py, built with g++
on first use), or where they cannot be built the numpy codecs of
quant/registry.py: both bit for bit the JAX package's numpy codecs, so both
tools write the same bytes. The JAX tool's
.kcache sidecar (its TPU kernel layout) has no counterpart here: the port
loads its planar layout straight from the file.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np

from ggllm_tpu_torch.core.dtypes import QK_K, FType, GGMLType, TYPE_TRAITS
from ggllm_tpu_torch.io.ggcc import GGCCWriter, GGJTWriter, read_model
from ggllm_tpu_torch.quant import native as native_mod
from ggllm_tpu_torch.quant import registry

# CLI name -> (ftype, tensor gtype); mirrors quantize.cpp:17-100's table
FTYPE_MAP: dict[str, tuple[FType, GGMLType]] = {
    "f32": (FType.ALL_F32, GGMLType.F32),
    "f16": (FType.MOSTLY_F16, GGMLType.F16),
    "q4_0": (FType.MOSTLY_Q4_0, GGMLType.Q4_0),
    "q4_1": (FType.MOSTLY_Q4_1, GGMLType.Q4_1),
    "q5_0": (FType.MOSTLY_Q5_0, GGMLType.Q5_0),
    "q5_1": (FType.MOSTLY_Q5_1, GGMLType.Q5_1),
    "q8_0": (FType.MOSTLY_Q8_0, GGMLType.Q8_0),
    "q2_k": (FType.MOSTLY_Q2_K, GGMLType.Q2_K),
    "q3_k": (FType.MOSTLY_Q3_K_M, GGMLType.Q3_K),
    "q3_k_s": (FType.MOSTLY_Q3_K_S, GGMLType.Q3_K),
    "q3_k_m": (FType.MOSTLY_Q3_K_M, GGMLType.Q3_K),
    "q3_k_l": (FType.MOSTLY_Q3_K_L, GGMLType.Q3_K),
    "q4_k": (FType.MOSTLY_Q4_K_M, GGMLType.Q4_K),
    "q4_k_s": (FType.MOSTLY_Q4_K_S, GGMLType.Q4_K),
    "q4_k_m": (FType.MOSTLY_Q4_K_M, GGMLType.Q4_K),
    "q5_k": (FType.MOSTLY_Q5_K_M, GGMLType.Q5_K),
    "q5_k_s": (FType.MOSTLY_Q5_K_S, GGMLType.Q5_K),
    "q5_k_m": (FType.MOSTLY_Q5_K_M, GGMLType.Q5_K),
    "q6_k": (FType.MOSTLY_Q6_K, GGMLType.Q6_K),
}


def _kquant_ok(gtype: GGMLType, ne: tuple) -> bool:
    """K-quants need dims divisible by 256 (libfalcon.cpp:3626-3635)."""
    if TYPE_TRAITS[gtype].block_size != QK_K:
        return True
    return ne[0] % QK_K == 0 and (len(ne) < 2 or ne[1] % QK_K == 0)


class _LlamaMixedPolicy:
    """Per-tensor type upgrades for LLaMA K-quant ftypes
    (llama.cpp:2441-2513: n_attention_wv/n_feed_forward_w2 counters +
    the `use_more_bits` layer-position rule)."""

    def __init__(self, tensors, ftype: FType):
        self.ftype = ftype
        self.n_wv = sum(1 for n in tensors if "attention.wv.weight" in n)
        self.n_w2 = sum(1 for n in tensors if "feed_forward.w2.weight" in n)
        self.i_wv = 0
        self.i_w2 = 0

    def _more_bits(self, i: int, n: int) -> bool:
        return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2

    def pick(self, name: str, base: GGMLType) -> GGMLType:
        ft = self.ftype
        new = base
        if name == "output.weight":
            new = GGMLType.Q6_K
        elif "attention.wv.weight" in name:
            if ft in (FType.MOSTLY_Q3_K_M, FType.MOSTLY_Q2_K):
                new = GGMLType.Q4_K
            elif ft == FType.MOSTLY_Q3_K_L:
                new = GGMLType.Q5_K
            elif ft in (FType.MOSTLY_Q4_K_M, FType.MOSTLY_Q5_K_M) and \
                    self._more_bits(self.i_wv, self.n_wv):
                new = GGMLType.Q6_K
            self.i_wv += 1
        elif "feed_forward.w2.weight" in name:
            if ft in (FType.MOSTLY_Q3_K_M, FType.MOSTLY_Q2_K):
                new = GGMLType.Q4_K
            elif ft == FType.MOSTLY_Q3_K_L:
                new = GGMLType.Q5_K
            elif ft in (FType.MOSTLY_Q4_K_M, FType.MOSTLY_Q5_K_M) and \
                    self._more_bits(self.i_w2, self.n_w2):
                new = GGMLType.Q6_K
            self.i_w2 += 1
        elif "attention.wo.weight" in name:
            if ft in (FType.MOSTLY_Q3_K_M, FType.MOSTLY_Q2_K):
                new = GGMLType.Q4_K
            elif ft == FType.MOSTLY_Q3_K_L:
                new = GGMLType.Q5_K
        return new


def quantize_file(
    fname_in: str,
    fname_out: str,
    ftype_name: str,
    quantize_output: bool = False,
    allow_requantize: bool = False,
    mixed: bool = True,
    log=print,
    native: bool | None = None,
) -> dict:
    """Requantize fname_in into fname_out as ftype_name. native: the C++
    codecs (True), the numpy codecs (False), or None for the C++ codecs
    where they build, else numpy (said through log)."""
    if native is None:
        try:
            native_mod.lib()
            native = True
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            log(f"the C++ codecs did not build ({e}); quantizing with the numpy codecs")
            native = False
    ftype, qtype = FTYPE_MAP[ftype_name.lower()]
    mf = read_model(fname_in)
    hp = mf.hparams
    hp.ftype = int(ftype)
    is_llama = mf.arch == "llama"
    if is_llama:
        writer = GGJTWriter(fname_out, hp, mf.vocab)
        output_name = "output.weight"
    else:
        writer = GGCCWriter(fname_out, hp, mf.vocab)
        output_name = "lm_head.weight"
    policy = _LlamaMixedPolicy(mf.tensors, ftype) \
        if is_llama and mixed and TYPE_TRAITS[qtype].block_size == QK_K else None

    total_org = 0
    total_new = 0
    n = len(mf.tensors)
    for idx, (name, t) in enumerate(mf.tensors.items()):
        quant = (
            name.endswith("weight")
            and len(t.ne) == 2
            and (quantize_output or name != output_name)
            and t.gtype != qtype
        )
        blob = np.asarray(mf.tensor_blob(name))
        total_org += blob.nbytes
        if not quant:
            writer.write_tensor(name, t.gtype, t.ne, blob)
            total_new += blob.nbytes
            log(f"[{idx + 1:4d}/{n:4d}] {name:48s} {str(t.ne):>16s} "
                f"{TYPE_TRAITS[t.gtype].name:>6s} (not quantizing)")
            continue
        new_type = qtype
        if policy is not None:
            picked = policy.pick(name, qtype)
            if _kquant_ok(picked, t.ne):
                new_type = picked
        if not _kquant_ok(new_type, t.ne):
            raise ValueError(
                f"tensor {name} dims {t.ne} not divisible by {QK_K}; "
                "K-quants unsupported for this model — use a legacy type"
            )
        if TYPE_TRAITS[t.gtype].is_quantized and not allow_requantize:
            raise ValueError(
                f"requantizing from {TYPE_TRAITS[t.gtype].name} is disabled "
                "(pass --allow-requantize)"
            )
        f32 = mf.tensor_f32(name)
        qblob = registry.quantize(new_type, f32, native=native)
        writer.write_tensor(name, new_type, t.ne, qblob)
        total_new += qblob.nbytes
        log(f"[{idx + 1:4d}/{n:4d}] {name:48s} {str(t.ne):>16s} "
            f"{TYPE_TRAITS[t.gtype].name:>6s} -> {TYPE_TRAITS[new_type].name:>6s} "
            f"{blob.nbytes / 2**20:8.2f} MB -> {qblob.nbytes / 2**20:8.2f} MB")
    writer.close()
    log(f"total: {total_org / 2**20:.2f} MB -> {total_new / 2**20:.2f} MB")
    return {"total_org": total_org, "total_new": total_new}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="quantize a GGCC Falcon or GGJT LLaMA model file")
    ap.add_argument("model_in")
    ap.add_argument("model_out")
    ap.add_argument("ftype", choices=sorted(FTYPE_MAP.keys()))
    ap.add_argument("--quantize-output", action="store_true",
                    help="also quantize lm_head.weight / output.weight")
    ap.add_argument("--allow-requantize", action="store_true")
    ap.add_argument("--no-mixed", action="store_true",
                    help="disable the llama mixed K-type per-tensor policy")
    args = ap.parse_args(argv)
    t0 = time.time()
    quantize_file(
        args.model_in, args.model_out, args.ftype,
        quantize_output=args.quantize_output,
        allow_requantize=args.allow_requantize,
        mixed=not args.no_mixed,
    )
    print(f"quantize time = {(time.time() - t0) * 1000:.2f} ms")
    return 0

if __name__ == "__main__":
    sys.exit(main())
