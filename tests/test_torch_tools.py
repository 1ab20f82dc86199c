"""The port's measuring tools on the CPU, where they cannot run: the models
they build and the library yardsticks they time beside the kernels.

* Every tool that builds LLaMA-7B from its preset builds it at n_rot =
  head_dim = 128, as llama.cpp's files hold it (utils/benchgen.py
  bench_hparams), while the preset keeps the JAX package's 64: chip_smoke.py
  phase_model, tools/profile_decode.py and tools/time_kernels.py f32path,
  nodes and decode, each stopped where it would make the weights on the
  card. time_kernels forms the rule itself from named_hparams, so that a
  --root tree of any age builds the same model; it equals bench_hparams.
* tools/time_kernels.py times every SDPA yardstick through `sdpa`, which
  runs f32 on the math backend (the memory-efficient one wrote past its
  tensors on an H100) and bf16 on the backend SDPA picks."""

import importlib.util
import inspect
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from ggllm_tpu_torch.core.config import named_hparams
from ggllm_tpu_torch.tools import profile_decode, time_kernels
from ggllm_tpu_torch.utils import benchgen

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


class Built(Exception):
    """Raised in place of making a model's weights, with its hparams."""


def _stop(hp, *args, **kw):
    raise Built(hp)


@pytest.fixture
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_hparams():
    hp = benchgen.bench_hparams("llama7b")
    assert (hp.n_rot, hp.head_dim, named_hparams("llama7b").n_rot) == (128, 128, 64)
    assert benchgen.bench_hparams("llama7b", 2).n_layer == 2
    assert benchgen.bench_hparams("falcon7b") == named_hparams("falcon7b")


@pytest.mark.parametrize("config", ["falcon7b", "falcon40b", "falcon180b", "llama7b"])
@pytest.mark.parametrize("n_layer", [None, 2])
def test_time_kernels_builds_bench_hparams(monkeypatch, config, n_layer):
    want = benchgen.bench_hparams(config, n_layer)
    monkeypatch.delattr(benchgen, "bench_hparams")
    assert time_kernels._hparams(config, n_layer) == want


@pytest.mark.parametrize("tool", ["chip_smoke.phase_model", "profile_decode",
                                  "time_kernels.f32path", "time_kernels.nodes",
                                  "time_kernels.decode"])
def test_tools_build_llama_at_n_rot_128(monkeypatch, chip_smoke, tool):
    monkeypatch.setattr(benchgen, "make_bench_params", _stop)
    monkeypatch.setattr(profile_decode, "make_bench_params", _stop)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", torch.cuda.CUDAGraph)  # nodes replaces it
    card = types.SimpleNamespace(synchronize=lambda: None, reset_peak_memory_stats=lambda: None)
    run = {"chip_smoke.phase_model": lambda: chip_smoke.phase_model(
               types.SimpleNamespace(cuda=card), "llama7b", "q4_0"),
           "profile_decode": lambda: profile_decode.main(["--config", "llama7b"]),
           "time_kernels.f32path": lambda: time_kernels.f32_path("llama7b", "q4_0", 2),
           "time_kernels.nodes": lambda: time_kernels.time_nodes("llama7b", "q4_0", "bfloat16"),
           "time_kernels.decode": lambda: time_kernels.time_decode("llama7b", "q4_0", "bfloat16",
                                                                   300, 64)}[tool]
    with pytest.raises(Built) as built:
        run()
    hp = built.value.args[0]
    assert hp.arch == "llama" and hp.n_rot == hp.head_dim == 128


def test_sdpa_yardstick_runs_f32_on_the_math_backend(monkeypatch):
    chosen = []

    def recording(backends, *a, **kw):
        chosen.append(backends)
        return keep(backends, *a, **kw)

    keep = torch.nn.attention.sdpa_kernel
    monkeypatch.setattr(torch.nn.attention, "sdpa_kernel", recording)
    q, k = torch.randn(1, 4, 5, 8), torch.randn(1, 4, 9, 8)
    torch.testing.assert_close(time_kernels.sdpa(q, k, k), F.scaled_dot_product_attention(q, k, k))
    assert chosen == [torch.nn.attention.SDPBackend.MATH]
    time_kernels.sdpa(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert len(chosen) == 1  # bf16 takes the backend SDPA picks


def test_every_sdpa_yardstick_goes_through_sdpa():
    src = inspect.getsource(time_kernels)
    helper = inspect.getsource(time_kernels.sdpa)
    assert src.count("scaled_dot_product_attention(") == helper.count(
        "scaled_dot_product_attention(") == 2
    for fn in (time_kernels.time_attn, time_kernels.time_f32, time_kernels.time_mqa32):
        assert "sdpa(" in inspect.getsource(fn), fn.__name__
