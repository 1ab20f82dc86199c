"""Test configuration: force JAX onto a virtual 8-device CPU platform.

Multi-chip sharding tests run against an 8-device host-platform mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8); real-TPU execution is
exercised by bench.py / the driver, not by the unit suite.
"""

import os

# force: the session env may preset JAX_PLATFORMS to the real TPU platform
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# the env var alone does not always win over an already-registered TPU plugin
jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels); skipped without one")
