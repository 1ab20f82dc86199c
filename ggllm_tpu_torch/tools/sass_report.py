"""What nvcc made of the decode GEMVs: instruction counts of every
`quant_gemv_legacy` and `quant_gemv_kq` instantiation in the built kernel
library, read from `cuobjdump -sass` (CUDA toolkit) on the card's machine.

    python -m ggllm_tpu_torch.tools.sass_report

Prints one JSON line per instantiation: kernel ("legacy" or "kq"), format, W
rows a warp, steps of row bytes in flight or in use (the loop's unrolled
steps), x and y dtypes, instructions in the function, I2F (int to float
conversions) in it, and its main loop (from the target of the last backward
branch to that branch: `depth` steps of the lane's blocks) with the loop's
instructions a weight. chip_smoke.py calls `gemv_report` after the build and
fails if a GEMV holds an I2F.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
from pathlib import Path

_FORMATS = {"legacy": {2: "q4_0", 3: "q4_1", 6: "q5_0", 7: "q5_1", 8: "q8_0"},
            "kq": {10: "q2_k", 11: "q3_k", 12: "q4_k", 13: "q5_k", 14: "q6_k"}}
_RUNS = {"q4_0": 2, "q4_1": 2, "q5_0": 2, "q5_1": 2, "q8_0": 1,  # 16-element runs a lane step
         "q2_k": 4, "q3_k": 4, "q4_k": 2, "q5_k": 2, "q6_k": 2}
# "/*0b30*/  @P0 BRA 0x5a0 ;": address, opcode (without its modifiers), operands
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)"
                    r"\s*([^;]*);")


def _cuobjdump() -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found: the SASS report needs the CUDA toolkit")
    return tool


def _describe(name: str) -> dict | None:
    """(kernel, format, rows, depth, x, y) of a mangled quant_gemv_legacy<F,
    R, D, TX, TY> or quant_gemv_kq<F, R, D, TX, TY> name."""
    m = re.search(r"quant_gemv_(legacy|kq)ILi(\d+)ELi(\d)ELi(\d)E(.*)EEvPK", name)
    if not m or int(m.group(2)) not in _FORMATS[m.group(1)]:
        return None
    rest = m.group(5)  # TX then TY: "f", "13__nv_bfloat16", or S1_ for a repeat of TX
    x_bf16 = rest.startswith("13__nv_bfloat16")
    tail = rest[len("13__nv_bfloat16"):] if x_bf16 else rest[1:]
    y_bf16 = tail.startswith("13__nv_bfloat16") or (x_bf16 and tail.startswith("S1_"))
    return {"kernel": m.group(1), "format": _FORMATS[m.group(1)][int(m.group(2))],
            "rows": int(m.group(3)), "depth": int(m.group(4)),
            "x": "bfloat16" if x_bf16 else "float32", "y": "bfloat16" if y_bf16 else "float32"}


def gemv_report(library: str | Path) -> list[dict]:
    """One dict per GEMV instantiation in `library` (see the module's
    docstring)."""
    return parse_sass(subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True,
                                     text=True, check=True).stdout)


def parse_sass(sass: str) -> list[dict]:
    """gemv_report's rows from the text `cuobjdump -sass` prints."""
    out = []
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        desc = _describe(name)
        if desc is None:
            continue
        ins = [(int(a, 16), op, arg) for a, op, _, arg in _INSTR.findall(func)]
        ops: dict[str, int] = {}
        for _, op, _ in ins:
            ops[op] = ops.get(op, 0) + 1
        loop = None
        for addr, op, arg in reversed(ins):
            target = re.search(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                loop = sum(1 for a, _, _ in ins if int(target.group(1), 16) <= a <= addr)
                break
        weights = desc["depth"] * desc["rows"] * 16 * _RUNS[desc["format"]]  # a lane's
        out.append({**desc, "instructions": len(ins), "I2F": ops.get("I2F", 0),
                    "loop_instructions": loop,
                    "loop_instructions_per_weight": None if loop is None else loop / weights,
                    "top_opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10])})
    return out


def main() -> int:
    from ggllm_tpu_torch.kernels import build

    for row in gemv_report(build.build()):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
