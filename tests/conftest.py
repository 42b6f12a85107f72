"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI, so sharding is validated on a
forced-host-platform device mesh (SURVEY.md §4: multi-host tests via
``xla_force_host_platform_device_count``). These env vars must be set
before jax initializes its backends, hence the top of conftest.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them (with a reason) when JAX's
default backend is not a GPU — decided at run time, never at import, so
every xdist worker collects the same tests. On a card, run them with the
CPU backend beside it:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -q -m gpu -p no:xdist
"""

import os

import pytest

_GPU_RUN = "cuda" in os.environ.get("JAX_PLATFORMS", "")

if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_default_prng_impl", "threefry2x32")
jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    if not _GPU_RUN:
        assert jax.device_count() == 8, (
            f"expected 8 virtual CPU devices, got {jax.devices()}"
        )


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's backend is {jax.default_backend()}")
    return jax.devices()[0]
