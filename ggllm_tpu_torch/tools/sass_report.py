"""What nvcc made of the decode GEMVs, the rows kernel and the f32 prefill
tile: instruction counts of every `quant_gemv_legacy`, `quant_gemv_kq`,
`quant_mmv_rows` and `quant_gemm_f32` instantiation in the built kernel
library, read from `cuobjdump -sass` (CUDA toolkit) on the card's machine.

    python -m ggllm_tpu_torch.tools.sass_report

Prints one JSON line per instantiation: kernel ("legacy" or "kq"), format, W
rows a warp, steps of row bytes in flight or in use (the loop's unrolled
steps), x and y dtypes, instructions in the function, I2F (int to float
conversions) in it, and its main loop (from the target of the last backward
branch to that branch: `depth` steps of the lane's blocks) with the loop's
instructions a weight (`parse_sass`). Then one JSON line per rows kernel
instantiation (`parse_rows_sass`): format, n-tiles, cluster size,
instructions, I2F, and its main loop (two units of 256 columns) with its
`HMMA` count. chip_smoke.py reads both after the build (`sass_text`) and
fails on an I2F in either kernel. Then one JSON line per f32 tile
instantiation (`parse_tile_sass`): format, x rows a block, instructions,
and its main loop (one 64-column slab: two 32-groups) with its `HMMA`
count, opcode counts and instructions a `HMMA`.
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


def sass_text(library: str | Path) -> str:
    """What `cuobjdump -sass` prints for `library`."""
    return subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout


def _functions(sass: str):
    """(mangled name, [(address, opcode, operands)]) of each function in the
    text `cuobjdump -sass` prints."""
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        yield (func.split("\n", 1)[0].strip(),
               [(int(a, 16), op, arg) for a, op, _, arg in _INSTR.findall(func)])


def _main_loop(ins: list) -> list | None:
    """The instructions from the target of the last backward branch to that
    branch, or None."""
    for addr, op, arg in reversed(ins):
        target = re.search(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            return [i for i in ins if int(target.group(1), 16) <= i[0] <= addr]
    return None


def _counts(ins: list) -> dict[str, int]:
    ops: dict[str, int] = {}
    for _, op, _ in ins:
        ops[op] = ops.get(op, 0) + 1
    return ops


def parse_sass(sass: str) -> list[dict]:
    """One dict per GEMV instantiation in the text `cuobjdump -sass` prints
    (see the module's docstring)."""
    out = []
    for name, ins in _functions(sass):
        desc = _describe(name)
        if desc is None:
            continue
        ops = _counts(ins)
        body = _main_loop(ins)
        loop = None if body is None else len(body)
        weights = desc["depth"] * desc["rows"] * 16 * _RUNS[desc["format"]]  # a lane's
        out.append({**desc, "instructions": len(ins), "I2F": ops.get("I2F", 0),
                    "loop_instructions": loop,
                    "loop_instructions_per_weight": None if loop is None else loop / weights,
                    "top_opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10])})
    return out


def parse_tile_sass(sass: str) -> list[dict]:
    """One dict per f32 tile instantiation in the text `cuobjdump -sass`
    prints (see the module's docstring)."""
    fmts = {**_FORMATS["legacy"], **_FORMATS["kq"]}
    out = []
    for name, ins in _functions(sass):
        m = re.search(r"quant_gemm_f32ILi(\d+)ELi(\d+)E", name)
        if not m or int(m.group(1)) not in fmts:
            continue
        body = _main_loop(ins) or []
        ops = _counts(body)
        hmma = ops.get("HMMA", 0)
        out.append({"kernel": "quant_gemm_f32", "format": fmts[int(m.group(1))],
                    "rows": int(m.group(2)), "instructions": len(ins),
                    "loop_instructions": len(body), "loop_HMMA": hmma,
                    "loop_instructions_per_HMMA": len(body) / hmma if hmma else None,
                    "loop_opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])})
    return out


def parse_rows_sass(sass: str) -> list[dict]:
    """One dict per rows kernel instantiation in the text `cuobjdump -sass`
    prints (see the module's docstring)."""
    fmts = {**_FORMATS["legacy"], **_FORMATS["kq"]}
    out = []
    for name, ins in _functions(sass):
        m = re.search(r"quant_mmv_rowsILi(\d+)ELi(\d+)ELi(\d+)E", name)
        if not m or int(m.group(1)) not in fmts:
            continue
        ops = _counts(ins)
        body = _main_loop(ins) or []
        loop_ops = _counts(body)
        out.append({"kernel": "quant_mmv_rows", "format": fmts[int(m.group(1))],
                    "ntiles": int(m.group(2)), "cluster": int(m.group(3)),
                    "instructions": len(ins), "I2F": ops.get("I2F", 0),
                    "loop_instructions": len(body), "loop_HMMA": loop_ops.get("HMMA", 0),
                    "loop_opcodes": dict(sorted(loop_ops.items(), key=lambda kv: -kv[1])[:12])})
    return out


def main() -> int:
    from ggllm_tpu_torch.kernels import build

    text = sass_text(build.build())
    for row in parse_sass(text) + parse_rows_sass(text) + parse_tile_sass(text):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
