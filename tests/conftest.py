"""Test harness: run everything on a virtual 8-device CPU mesh so multi-device
sharding paths are exercised without GPUs.

The platform is set through jax.config before any backend starts.
GIE_TEST_PLATFORMS overrides it: on a machine with a card,
`GIE_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` runs the tests
marked `gpu` (elsewhere they skip, from the `gpu_device` fixture).
"""
import os

import jax

jax.config.update("jax_platforms", os.environ.get("GIE_TEST_PLATFORMS", "cpu"))
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:  # older jax: fall back to XLA_FLAGS (no-op if backend is up)
    import os

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test FILES.

    The suite compiles hundreds of XLA CPU programs in one process; the
    LLVM JIT's code memory accumulates with the live executables and
    eventually segfaults inside a later compile (observed deterministically
    at ~220 programs once the change-gated switch multiplied program
    sizes).  Shapes/configs rarely repeat across files, so per-module
    clearing costs little recompilation and keeps the serial `pytest
    tests/` run within the JIT's memory budget."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: tests marked `gpu` run only on a card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
