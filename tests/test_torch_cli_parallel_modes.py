"""More of the port CLI's multi-GPU flags (ggllm_tpu_torch/tools/main.py)
against the JAX CLI's, on the CPU: -ts auto prints the JAX CLI's plan line
given the JAX planner's memory and overhead; --multihost joins a torchrun
world (one rank here: MASTER_PORT 0 binds a free port) on the device
--device names (a card by default: none raises); -ts 4 with fewer
cards exits 1 with make_mesh's message (the card count patched); a session
saved by two sharded ranks (--prompt-cache, gathered to rank 0) loads into
the JAX session loader with the JAX engine's cache; speculative decoding
and grammars under -ts exit 1; -ts 2 with --lora or --weight-mode dequant
(the fallback tree, parallel/sharding.py) prints the JAX CLI's text."""

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig
from ggllm_tpu.engine import session as jsession
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.parallel import plan as jplan
from ggllm_tpu.tools import main as jcli
from ggllm_tpu_torch.parallel import plan
from ggllm_tpu_torch.tools import main as cli
from tests.test_torch_cli_parallel import BASE, files, jax_text, port  # noqa: F401

torch.set_num_threads(1)


def test_ts_auto_prints_the_jax_plan_line(files, capsysbinary, monkeypatch):
    """Given the JAX planner's memory and layout overhead, the port's plan
    line is the JAX CLI's, and the text the single-card run's."""
    monkeypatch.setattr(plan, "device_memory", lambda device="cuda": jplan.DEFAULT_HBM_BYTES)
    monkeypatch.setattr(plan, "kernel_overhead", lambda mf, cfg=None: jplan.KERNEL_OVERHEAD)
    capsysbinary.readouterr()
    assert cli.main(["-m", files["tiny"], *BASE, "--device", "cpu", "-ts", "auto"]) == 0
    got = capsysbinary.readouterr()
    ref_out, ref_err = jax_text(capsysbinary, files["tiny"], "-ts", "auto")

    def line(err):
        return [s for s in err.splitlines() if s.startswith("auto tensor split:")]

    assert line(got.err.decode()) == line(ref_err) and len(line(ref_err)) == 1
    assert got.out == ref_out


def test_multihost_joins_the_torchrun_world(files, capsysbinary):
    """--multihost reads torchrun's environment (a world of one rank here:
    port 0 binds a free one) and prints the single-card text."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0", "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    rc, out, err = port(files["tiny"], "--multihost", env=env)
    assert rc == 0, err
    ref, _ = jax_text(capsysbinary, files["tiny"])
    assert out == ref


def test_ts_4_with_fewer_cards_exits_1(files, capsys, monkeypatch):
    """-ts 4 on a host with one card: make_mesh's message, before any rank
    starts or any file is read."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["-m", files["tiny"], "-ts", "4"]) == 1
    assert capsys.readouterr().err.strip() == "error: need 4 devices, have 1"
    with pytest.raises(AssertionError, match="need 16 devices, have 8"):
        jcli.main(["-m", files["tiny"], *BASE, "-ts", "16"])


@pytest.mark.parametrize("name,shard", [("tiny_gqa", "heads"), ("tiny", "sequence")])
def test_sharded_session_loads_into_the_jax_loader(files, tmp_path, name, shard):
    """--prompt-cache under -ts 2: the ranks' cache parts (K/V heads, time
    windows) gathered to rank 0 and written whole; the JAX loader reuses the
    prompt and holds the JAX engine's cache for it."""
    sess = str(tmp_path / "s.npz")
    rc, _, err = port(files[name], "-ts", "2", "--kv-shard", shard, "--prompt-cache", sess)
    assert rc == 0, err
    mf = read_model(files[name])
    cfg = EngineConfig(n_ctx=96, n_batch=32, kv_dtype="float32", compute_dtype="float32")
    z = np.load(sess)
    saved = [int(t) for t in z["tokens"]]
    assert z["kv"].shape[3] == len(saved) > 1
    eng = JEngine(mf.hparams, load_params(mf, cfg), cfg)
    assert jsession.try_load(sess, eng, saved + [5]) == [5]
    ref = JEngine(mf.hparams, load_params(mf, cfg), cfg)
    ref.eval(saved)
    n = len(saved)
    got_kv, ref_kv = np.asarray(eng.kv)[:, :, :, :n], np.asarray(ref.kv)[:, :, :, :n]
    np.testing.assert_allclose(got_kv, ref_kv, atol=1e-5 * np.abs(ref_kv).max())


@pytest.mark.parametrize("extra,why", [
    (["--self-draft", "1"], "speculative decoding requires a single-device engine"),
    (["--grammar", 'root ::= "a"'], "grammar requires a single-device engine")])
def test_one_device_modes_refused_under_ts(files, capsys, extra, why):
    assert cli.main(["-m", files["tiny"], "-ts", "2", *extra]) == 1
    assert capsys.readouterr().err.strip() == f"error: {why}"


def _adapter(path: str) -> str:
    """An r 4 adapter on every layer's query_key_value and dense_4h_to_h of
    tests/test_torch_cli_parallel.py's tiny file."""
    from ggllm_tpu_torch.core.config import FalconHParams
    from ggllm_tpu_torch.io.lora import write_lora

    hp, rng = FalconHParams.tiny(), np.random.default_rng(4)
    n_qkv = (hp.n_head + 2 * hp.n_head_kv) * hp.head_dim
    write_lora(path, 4, 8, {
        name: {"loraA": rng.standard_normal((4, cols)).astype(np.float32) * 0.1,
               "loraB": rng.standard_normal((rows, 4)).astype(np.float32) * 0.1}
        for i in range(hp.n_layer)
        for name, rows, cols in ((f"transformer.h.{i}.self_attention.query_key_value.weight",
                                  n_qkv, hp.n_embd),
                                 (f"transformer.h.{i}.mlp.dense_4h_to_h.weight", hp.n_embd,
                                  hp.n_ff))})
    return path


@pytest.mark.parametrize("mode", ["lora", "dequant"])
def test_ts_2_fallback_modes_print_the_jax_text(files, capsysbinary, tmp_path, mode):
    """-ts 2 --lora and -ts 2 --weight-mode dequant, which raised before the
    fallback tree was ported: the JAX CLI's greedy text (its GSPMD path)."""
    extra = (["--lora", _adapter(str(tmp_path / "a.ggla"))] if mode == "lora"
             else ["--weight-mode", "dequant"])
    rc, out, err = port(files["tiny"], "-ts", "2", *extra)
    assert rc == 0, err
    ref, _ = jax_text(capsysbinary, files["tiny"], "-ts", "2", *extra)
    assert out == ref and len(out) > 0


TORCHRUN_ONE = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0", "WORLD_SIZE": "1", "RANK": "0",
                "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}


@pytest.mark.parametrize("device,cards,want", [
    ("cpu", 1, ("cpu", "gloo")), ("cuda", 1, ("cuda", "nccl")), ("cuda", 0, None),
    (None, 0, None)], ids=["cpu_on_card_host", "cuda", "cuda_missing", "default_missing"])
def test_init_distributed_takes_the_asked_device(monkeypatch, device, cards, want):
    """--multihost's init_distributed(device=--device): the CPU over gloo
    when asked for, even on a host with cards; a card (the default) where
    there is none raises, as the single-process CLI does."""
    from ggllm_tpu_torch.parallel import mesh

    seen = {}
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    for k, v in TORCHRUN_ONE.items():
        monkeypatch.setenv(k, v)
    if want is None:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.init_distributed(device=device)
        assert not seen
    else:
        assert (mesh.init_distributed(device=device).type, seen["backend"]) == want


def test_multihost_without_a_card_raises(files, monkeypatch):
    """--multihost under the CLI's default --device cuda on a host without
    a card raises before joining, as the single-process CLI does."""
    from ggllm_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda *a, **kw: pytest.fail("joined without a card"))
    for k, v in TORCHRUN_ONE.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-m", files["tiny"], "--multihost"])
