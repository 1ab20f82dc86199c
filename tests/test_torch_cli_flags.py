"""The port CLI's remaining flags (ggllm_tpu_torch/tools/main.py) on the CPU:
the reference's thread / VRAM / mmap flags accepted and ignored, --alias,
--mtest, --weight-mode dequant (load-time dequantization, against the fused
path and the JAX CLI's dequant mode), --profile and -dt (utils/traceview.py
over torch.profiler's Chrome trace). --export: tests/test_torch_export.py;
--lora / --lora-base: tests/test_torch_lora.py; -ts, --kv-shard and
--multihost: tests/test_torch_cli_parallel.py."""

import contextlib
import gzip
import io
import json

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.tools import main as jcli

from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.io.loader import dequantize_params, load_model
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.tools import main as cli
from ggllm_tpu_torch.utils import traceview

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

BASE = ["-c", "96", "-b", "32", "--kv-dtype", "float32", "--compute-dtype", "float32",
        "--temp", "0", "--ignore-eos", "--decode-chunk", "4"]
COMPAT = ["-t", "4", "-ngl", "100", "--mlock", "--no-mmap", "--threads", "2",
          "--n-gpu-layers", "7", "--gpu-layers", "7", "--main-gpu", "0",
          "--gpu-reserve-mb-main", "512", "--gpu-reserve-mb-other", "0",
          "--override-max-gpu", "1", "--low-vram"]


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    from ggllm_tpu.utils.synthetic import write_tiny_model

    path = str(tmp_path_factory.mktemp("cli_flags") / "tiny.ggcc")
    write_tiny_model(path, FalconHParams.tiny(), ftype_2d=GGMLType.Q4_0, seed=5)
    return path


def run(tiny_model, capsysbinary, *extra, prompt="the thing", n=12):
    rc = cli.main(["-m", tiny_model, *BASE, "--device", "cpu", "-p", prompt, "-n", str(n),
                   *map(str, extra)])
    out = capsysbinary.readouterr()
    return rc, out.out, out.err.decode()


@pytest.fixture(scope="module")
def fused_text(tiny_model):
    """The CLI's text for the command line without the flags under test."""
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, write_through=True)  # closes buf when collected
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["-m", tiny_model, *BASE, "--device", "cpu", "-p", "the thing",
                         "-n", "12"]) == 0
    return buf.getvalue()


def test_reference_compat_flags_are_ignored(tiny_model, capsysbinary, fused_text):
    """The reference's thread, VRAM and mmap flags parse and change nothing:
    the same text as without them."""
    rc, out, _ = run(tiny_model, capsysbinary, *COMPAT)
    assert rc == 0 and out == fused_text and out.startswith(b"the thing")


def test_alias_is_reported(tiny_model, capsysbinary, fused_text):
    rc, out, err = run(tiny_model, capsysbinary, "--alias", "tiny-falcon")
    assert rc == 0 and "model alias: tiny-falcon" in err and out == fused_text


def test_mtest_reports_the_worst_case_paths(tiny_model, capsysbinary):
    """--mtest: a full-batch prefill of min(n_batch, n_ctx - 1) = 32 zeros and
    one decode step, their timings, no device memory figure on the CPU, exit
    0 without generating."""
    rc, out, err = run(tiny_model, capsysbinary, "--mtest")
    assert rc == 0 and out == b""
    assert "/ 32 tokens" in err and "eval time" in err and "/ 1 runs" in err
    assert "mtest: no device memory figure" in err and "MiB" not in err


def test_weight_mode_dequant_gives_the_fused_ids(tiny_model, capsysbinary, fused_text):
    """--weight-mode dequant dequantizes every quantized weight once at load
    (the tree holds no QuantTensor) and gives the fused path's greedy text
    in f32, which is also the JAX CLI's in its dequant mode."""
    rc, out, _ = run(tiny_model, capsysbinary, "--weight-mode", "dequant")
    assert rc == 0 and out == fused_text
    jcli.main(["-m", tiny_model, *BASE, "-p", "the thing", "-n", "12",
               "--weight-mode", "dequant"])
    assert capsysbinary.readouterr().out == out
    cfg = EngineConfig(compute_dtype="float32", weight_mode="dequant")
    _, params = load_model(tiny_model, cfg, device="cpu")
    leaves = [params["lm_head"]] + [w for lw in params["layers"] for w in lw.values()]
    assert not any(isinstance(w, QuantTensor) for w in leaves)
    with pytest.raises(ValueError, match="weight_mode"):
        load_model(tiny_model, EngineConfig(weight_mode="planar"), device="cpu")


def test_dequantize_params_is_the_quant_tensors_dequant(tiny_model):
    _, params = load_model(tiny_model, EngineConfig(compute_dtype="float32"), device="cpu")
    dense = dequantize_params(params, torch.bfloat16)
    for k in ("wqkvu", "w_od"):
        w = params["layers"][1][k]
        assert isinstance(w, QuantTensor)
        assert torch.equal(dense["layers"][1][k], w.dequantize(torch.float32).to(torch.bfloat16))
    assert dense["tok_embeddings"] is params["tok_embeddings"]
    assert dense["layers"][0]["input_ln_w"] is params["layers"][0]["input_ln_w"]


@pytest.mark.parametrize("level, rows", [(1, 10), (2, 30), (3, None)])
def test_debug_timings_print_an_op_table(tiny_model, capsysbinary, fused_text, level, rows):
    """-dt LEVEL wraps generation in torch.profiler (a temp dir) and prints
    the op table: the host's operators on the CPU, level 1 the top 10, 2 the
    top 30, 3 every op, with the same generated text."""
    rc, out, err = run(tiny_model, capsysbinary, "-dt", level)
    assert rc == 0 and out == fused_text
    table = err[err.index("op "):err.index("TOTAL")].splitlines()
    assert table[0].split() == ["op", "calls", "total", "ms", "mean", "ms"]
    body = [line for line in table[1:] if not line.startswith("...")]
    assert "aten::" in table[1]
    if rows is None:
        assert not any(line.startswith("...") for line in table)
    else:
        assert len(body) == rows and table[-1].startswith("...")
    assert "profiler trace written to" in err


def test_profile_writes_a_chrome_trace(tiny_model, capsysbinary, fused_text, tmp_path):
    rc, out, err = run(tiny_model, capsysbinary, "--profile", tmp_path / "prof")
    assert rc == 0 and out == fused_text and "TOTAL" not in err
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    stats = traceview.load_op_stats(str(tmp_path / "prof"))
    assert stats and all(a.total_us >= b.total_us for a, b in zip(stats, stats[1:]))


def test_traceview_prefers_device_events(tmp_path):
    """A trace with kernel events (a card's, graph replays included) sums
    them by name; one with none sums the host's operators. Gzipped traces
    read too."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50.0},
              {"ph": "X", "cat": "kernel", "name": "quant_gemv_legacy", "dur": 3.0},
              {"ph": "X", "cat": "kernel", "name": "quant_gemv_legacy", "dur": 5.0},
              {"ph": "X", "cat": "kernel", "name": "decode_tc_kernel", "dur": 1.5},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 0.5},
              {"ph": "i", "cat": "kernel", "name": "instant", "dur": 9.0}]
    with gzip.open(tmp_path / "t.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    stats = traceview.load_op_stats(str(tmp_path))
    assert [(s.name, s.calls, s.total_us) for s in stats] == [
        ("quant_gemv_legacy", 2, 8.0), ("decode_tc_kernel", 1, 1.5), ("Memcpy DtoH", 1, 0.5)]
    assert stats[0].mean_us == 4.0
    (tmp_path / "host.json").write_text(json.dumps({"traceEvents": events[:1]}))
    host = traceview.load_op_stats(str(tmp_path / "host.json"))
    assert [(s.name, s.calls) for s in host] == [("aten::mm", 1)]
    table = traceview.format_table(stats, 1)
    assert "quant_gemv_legacy" in table and table.splitlines()[-1].split()[1:] == ["4", "0.010"]
    with pytest.raises(FileNotFoundError):
        traceview.load_op_stats(str(tmp_path / "empty"))


def test_single_card_values_of_the_multi_gpu_flags_run(tiny_model, capsysbinary, fused_text):
    """-ts 1 and --kv-shard heads are the JAX CLI's defaults: a single card,
    nothing to refuse."""
    rc, out, _ = run(tiny_model, capsysbinary, "-ts", "1", "--kv-shard", "heads")
    assert rc == 0 and out == fused_text
    assert np.all([cli.refusal(cli.build_parser().parse_args(["-m", "x"])) is None])
