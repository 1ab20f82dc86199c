"""Per-tensor quantization error statistics (quantize-stats analogue; port
of ggllm_tpu/tools/quantize_stats.py).

For each 2-D weight in a model, quantizes to the target type(s) and reports
RMSE and max error of the round-trip vs the source values.

  python -m ggllm_tpu_torch.tools.quantize_stats -m model.ggcc [--types q4_0,q4_K]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ggllm_tpu_torch.core.dtypes import GGMLType, TYPE_TRAITS
from ggllm_tpu_torch.io.ggcc import read_model
from ggllm_tpu_torch.quant import registry


def main(argv=None):
    ap = argparse.ArgumentParser(description="quantization error statistics")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--types", default="q4_0,q4_1,q5_0,q5_1,q8_0")
    ap.add_argument("--per-tensor", action="store_true",
                    help="print every tensor (default: aggregate per type)")
    args = ap.parse_args(argv)

    by_name = {TYPE_TRAITS[t].name.lower(): t for t in TYPE_TRAITS
               if TYPE_TRAITS[t].name.lower().startswith("q")}
    types = [by_name[t.strip().lower()] for t in args.types.split(",")]
    mf = read_model(args.model)

    names = [n for n, t in mf.tensors.items()
             if len(t.shape) == 2 and n.endswith("weight")]
    print(f"{len(names)} 2-D weights")
    for gtype in types:
        bs = TYPE_TRAITS[gtype].block_size
        sq_sum = 0.0
        n_sum = 0
        max_err = 0.0
        skipped = 0
        for name in names:
            w = mf.tensor_f32(name).astype(np.float32)
            if w.shape[1] % bs != 0:
                skipped += 1
                continue
            blob = registry.quantize(gtype, w)
            back = registry.dequantize(gtype, blob, w.size).reshape(w.shape)
            d = (back - w).astype(np.float64)
            sq_sum += float((d * d).sum())
            n_sum += w.size
            err = float(np.abs(d).max())
            max_err = max(max_err, err)
            if args.per_tensor:
                rmse = float(np.sqrt((d * d).mean()))
                print(f"  {TYPE_TRAITS[gtype].name:6s} {name:56s} "
                      f"rmse {rmse:.6f} max {err:.6f}")
        if n_sum:
            print(f"{TYPE_TRAITS[gtype].name:6s} rmse {np.sqrt(sq_sum / n_sum):.6f} "
                  f"max {max_err:.6f}"
                  + (f"  ({skipped} tensors skipped: width % {bs})" if skipped else ""))
        else:
            print(f"{TYPE_TRAITS[gtype].name:6s} (no compatible tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
