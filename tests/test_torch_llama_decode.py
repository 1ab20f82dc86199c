"""The PyTorch port's LLaMA decode path against the JAX package, on the CPU:
greedy ids equal over three decode chunks on a dense and on an int8 cache,
then the caches equal (tests/test_torch_llama.py holds the rest of the LLaMA
slice; this file shares its files and JAX engines' setup, in a file of its
own so that the test workers balance). The JAX engine runs its Pallas
kernels in interpret mode; the port runs its kernels' plain versions."""

import numpy as np
import pytest
import torch

from ggllm_tpu.ops.sampling import SamplerParams

from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
from ggllm_tpu_torch.io.loader import load_model as tload_model
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams
from tests.test_torch_llama import (PROMPT, _torch_cfg, jax_engines,  # noqa: F401
                                    llama_files)

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["q4_0", "q4_k"])
def test_three_decode_chunks_match_jax_engine(llama_files, jax_engines, name, kv_dtype):
    """Greedy ids equal over three decode chunks (40 tokens at decode_chunk
    16: the last one partial), on a dense cache (written in place here,
    deferred in the JAX engine) and on an int8 cache (chunk-deferred in
    both: a chunk's own tokens are attended unquantized and quantized once
    at its end). Then the caches agree: dense values to 1e-4; int8 scales to
    1e-6 in layer 0 and to 2e-3 of their value above it (a code that rounds
    the other way in layer 0 moves what layer 1 attends by a quantization
    step), and codes but for rounding ties (at most one step, in under 0.5 %
    of the codes: 0.15 % at n_embd 256, where the two packages' f32 K/V
    differ by about 1e-5)."""
    path = llama_files[name]
    jeng = jax_engines(name, kv_dtype)
    tmf, params = tload_model(path, _torch_cfg(kv_dtype), device="cpu")
    teng = TFalconEngine(tmf.hparams, params, _torch_cfg(kv_dtype), device="cpu")

    ref, got = jeng.eval(PROMPT), teng.eval(PROMPT)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)
    jeng.reset()
    teng.reset()
    ref_ids = jeng.generate(PROMPT, 40, SamplerParams(temp=0.0))
    assert teng.generate(PROMPT, 40, TSamplerParams(temp=0.0)) == ref_ids
    n = teng.n_past
    assert n == jeng.n_past == len(PROMPT) + 39
    if kv_dtype == "int8":
        assert isinstance(teng.kv, tuple) and teng.kv[0].dtype == torch.int8
        jcodes, jscales = (np.asarray(a) for a in jeng.kv)
        step = np.abs(teng.kv[0].numpy()[:, :, :, :n].astype(np.int32) - jcodes[:, :, :, :n])
        assert step.max() <= 1 and (step != 0).mean() < 5e-3
        tscales = teng.kv[1].numpy()
        np.testing.assert_allclose(tscales[0, :, :, :n], jscales[0, :, :, :n], rtol=0, atol=1e-6)
        np.testing.assert_allclose(tscales[:, :, :, :n], jscales[:, :, :, :n], rtol=2e-3)
    else:
        np.testing.assert_allclose(teng.kv.numpy()[:, :, :, :n], np.asarray(jeng.kv)[:, :, :, :n],
                                   atol=1e-4)
