"""The device a measurement ran on, for every result line.

The card's name and power limit come from `nvidia-smi` (a plain child
process that does not touch JAX, so it never competes for the card's
memory): a card set below its maximum power runs slower under load, so a
number is only comparable beside its limit.
"""
from __future__ import annotations

import shutil
import subprocess


def gpu_name_power() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output (one line per card), or None where there is no nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        r = subprocess.run([exe, "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def device_record() -> dict:
    """platform, device_kind and count as JAX reports them, plus the card
    line from nvidia-smi."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "gpu": gpu_name_power()}


def require_gpu() -> dict:
    """device_record(), raising unless JAX runs on a GPU: a timing taken
    elsewhere is not a device measurement."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {rec['platform']!r}")
    return rec
