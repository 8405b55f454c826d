"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding paths are validated on `xla_force_host_platform_device_count=8` CPU
devices; `python chip_smoke.py --four` runs them on four real GPUs.
XLA_FLAGS must be set before the first backend initialization, and the
platform is pinned to the CPU through the config API (backend initialization
is still lazy at this point).

Tests that need a GPU carry the `gpu` marker.  On a CPU-only run they skip
through the `gpu_device` fixture, which decides at run time.  On a machine
with a GPU, `python -m pytest tests -m gpu` leaves JAX on its default
backend (the GPU) and runs only those tests.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from ocs2_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on CPU-only runs"
    )
    jax.config.update("jax_enable_x64", False)
    enable_compile_cache()
    if config.getoption("markexpr") == "gpu":
        return
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the backend has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend in this process (tests run on the CPU)")
