"""Per-op timing tables from a torch.profiler trace (the counterpart of
ggllm_tpu/utils/traceview.py, which reads a JAX profiler trace).

The reference prints per-node op timing tables with ``--debug-timings
1..3`` (ggml_graph_print_impl, ggml.c:18266). The port's evidence is the
Chrome trace that ``torch.profiler``'s ``export_chrome_trace`` writes: one
JSON object whose "traceEvents" hold complete ("X") events. On the card the
table sums the device events ("cat" kernel, gpu_memcpy, gpu_memset) by
name. CUPTI records each kernel node of a replayed CUDA graph as a kernel
event of its own, so the decode graphs' kernels are listed by name, as
tools/profile_decode.py sees them. A trace with no device events (the CPU)
sums the host's operator events ("cat" cpu_op) instead.

Used by ``tools/main.py --profile DIR / -dt LEVEL`` and standalone::

    python -m ggllm_tpu_torch.utils.traceview DIR_OR_FILE [-l 1|2|3]
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
LIMITS = {1: 10, 2: 30}  # rows a level prints; level 3 prints every op


@dataclass
class OpStat:
    name: str
    calls: int
    total_us: float

    @property
    def mean_us(self) -> float:
        return self.total_us / max(self.calls, 1)


def trace_files(trace_dir: str) -> list[Path]:
    """The *.json / *.json.gz traces under a directory, or the file itself."""
    p = Path(trace_dir)
    if p.is_file():
        return [p]
    files = sorted(f for f in p.rglob("*") if f.name.endswith((".json", ".json.gz")))
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    return files


def _events(path: Path) -> list[dict]:
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def load_op_stats(trace_dir: str) -> list[OpStat]:
    """Complete events of the trace(s), summed by name: the device's when
    there are any, else the host's operators. Sorted by total time."""
    events = [e for path in trace_files(trace_dir) for e in _events(path)
              if e.get("ph") == "X"]
    on_device = any(e.get("cat") in DEVICE_CATS for e in events)
    cats = DEVICE_CATS if on_device else HOST_CATS
    agg: dict[str, OpStat] = {}
    for e in events:
        if e.get("cat") not in cats:
            continue
        name, dur = e.get("name", "?"), float(e.get("dur", 0.0))  # microseconds
        st = agg.setdefault(name, OpStat(name, 0, 0.0))
        st.calls += 1
        st.total_us += dur
    return sorted(agg.values(), key=lambda s: -s.total_us)


def format_table(stats: list[OpStat], level: int = 1) -> str:
    """The op table: name, calls, total ms and mean ms; level 1 the top 10
    ops, 2 the top 30, 3 every op."""
    limit = LIMITS.get(level, len(stats))
    total = sum(s.total_us for s in stats)
    lines = [f"{'op':<60} {'calls':>7} {'total ms':>10} {'mean ms':>10}"]
    for s in stats[:limit]:
        name = s.name if len(s.name) <= 60 else s.name[:57] + "..."
        lines.append(f"{name:<60} {s.calls:>7} {s.total_us / 1e3:>10.3f} {s.mean_us / 1e3:>10.4f}")
    if len(stats) > limit:
        rest = stats[limit:]
        lines.append(f"{'... ' + str(len(rest)) + ' more ops':<60} {sum(s.calls for s in rest):>7}"
                     f" {sum(s.total_us for s in rest) / 1e3:>10.3f}")
    lines.append(f"{'TOTAL':<60} {sum(s.calls for s in stats):>7} {total / 1e3:>10.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("-l", "--level", type=int, default=2, choices=[1, 2, 3])
    args = ap.parse_args(argv)
    print(format_table(load_op_stats(args.trace_dir), args.level))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
