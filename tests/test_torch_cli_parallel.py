"""The port CLI's multi-GPU flags (ggllm_tpu_torch/tools/main.py -ts,
--kv-shard) against the JAX CLI's (tools/main.py:288-332), on the CPU:
`--device cpu -ts 2` (tensor-parallel, two gloo ranks started by the CLI;
MQA and GQA) and `-ts 2 --kv-shard sequence` print the JAX CLI's greedy
text on the same tiny file. The port runs in a subprocess (it starts the
ranks itself), the JAX CLI in this process on the 8-device CPU mesh. -ts
auto, --multihost, sessions and refusals:
tests/test_torch_cli_parallel_modes.py."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ggllm_tpu.core.config import FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.tools import main as jcli
from ggllm_tpu.utils.synthetic import write_tiny_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASE = ["-c", "96", "-b", "32", "--kv-dtype", "float32", "--compute-dtype", "float32",
        "--temp", "0", "--ignore-eos", "--decode-chunk", "4", "-p", "the thing", "-n", "12"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_par")
    out = {}
    for name in ("tiny", "tiny_gqa"):
        out[name] = str(d / f"{name}.ggcc")
        write_tiny_model(out[name], getattr(FalconHParams, name)(), ftype_2d=GGMLType.Q8_0,
                         seed=11)
    return out


def port(path, *extra, env=None):
    """The port CLI in a subprocess: (rc, stdout bytes, stderr text)."""
    p = subprocess.run([sys.executable, "-m", "ggllm_tpu_torch.tools.main", "-m", path, *BASE,
                        "--device", "cpu", *map(str, extra)], cwd=ROOT, capture_output=True,
                       timeout=300, env={**os.environ, **(env or {})})
    return p.returncode, p.stdout, p.stderr.decode()


def jax_text(capsysbinary, path, *extra):
    capsysbinary.readouterr()
    assert jcli.main(["-m", path, *BASE, *map(str, extra)]) in (0, None)
    out = capsysbinary.readouterr()
    return out.out, out.err.decode()


@pytest.mark.parametrize("name,extra", [
    ("tiny", ["-ts", "2"]), ("tiny_gqa", ["-ts", "2"]),
    ("tiny", ["-ts", "2", "--kv-shard", "sequence"])], ids=["mqa", "gqa", "sequence"])
def test_ts_2_prints_the_jax_text(files, capsysbinary, name, extra):
    rc, out, err = port(files[name], *extra)
    assert rc == 0, err
    assert "mesh: 1 x 2" in err
    ref, _ = jax_text(capsysbinary, files[name], *extra)
    assert out == ref
