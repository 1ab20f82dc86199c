"""The PyTorch port's whole slice against the JAX package on the 40B-style
K-quant files (Q4_K, Q6_K, Q3_K, Q2_K at n_embd 256): prefill logits within
1e-4 of max |logit| of the JAX engine's (Pallas in interpret mode, f32
compute and cache) and 16 greedy ids equal. These are the K-quant cases of
tests/test_torch_engine.py's slice test, whose files and check they share,
in a file of their own so that the test workers balance."""

import pytest
import torch

from ggllm_tpu.engine.engine import FalconEngine
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params

from tests.test_torch_engine import _jax_cfg, slice_matches_jax_engine, tiny_files  # noqa: F401

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)


@pytest.mark.parametrize("hp_name", ["40b_q4_k", "40b_q6_k", "40b_q3_k", "40b_q2_k"])
def test_slice_matches_jax_engine(tiny_files, hp_name):  # noqa: F811
    mf = read_model(tiny_files[hp_name])
    slice_matches_jax_engine(tiny_files[hp_name],
                             FalconEngine(mf.hparams, load_params(mf, _jax_cfg()), _jax_cfg()))
