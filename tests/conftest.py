"""Test configuration: run the suite on a virtual 8-device CPU mesh in f64.

Regression parity against the reference golden files requires float64; TPU
hardware is exercised separately by bench.py.  Multi-chip sharding tests use
the 8 virtual CPU devices (xla_force_host_platform_device_count).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# The environment may pre-register an accelerator plugin that force-selects
# itself via jax.config (overriding JAX_PLATFORMS env).  Tests are CPU-only:
# override back before any backend initializes.  f64 on the accelerator would
# silently demote to f32 and break regression parity.
jax.config.update("jax_platforms", "cpu")

# Make the repo root importable regardless of pytest invocation directory.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ROOT = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (mpp_tpu_torch's CUDA kernels); "
        "skips without one")
