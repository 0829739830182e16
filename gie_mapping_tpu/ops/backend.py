"""The one place that decides what runs on which platform.

Supported platforms are ``"gpu"`` (NVIDIA Hopper) and ``"cpu"``; every
stage is plain XLA on both.  No hand-written kernel is kept: the Pallas
envelope kernel for the GPU was measured end to end against XLA's plain
envelope and did not win (PERF.md, Findings).  Any other platform raises —
there is no silent fallback.

The platform is the one the computation is placed on: the device set by
``jax.default_device`` when one is set, else JAX's default backend.
"""
from __future__ import annotations

import jax

SUPPORTED = ("cpu", "gpu")


def platform() -> str:
    """The platform computations are placed on; raises on unsupported ones."""
    dev = jax.config.jax_default_device
    if dev is None:
        p = jax.default_backend()
    elif isinstance(dev, str):
        p = dev
    else:
        p = dev.platform
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this engine runs on "
            f"{' or '.join(SUPPORTED)}")
    return p
