"""Occupancy fusion primitives.

Counterparts of the per-voxel fusion math used by
updateHashOGMWithPntCld / updateHashOGMWithSensor
(/root/reference/src/kernel/par_wave/unify_helper.cuh:35-197).  The kernels
themselves are assembled in models/pipeline.py as dense window updates; this
module holds the shared primitives: the low-pass occupancy filter and the
virtual-fence AABB test.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils.constants import (
    OCC_VAL_MAX,
    OCC_VAL_MIN,
    VOX_FREE,
    VOX_OCCUPIED,
    VOX_UNKNOWN,
)


def _lowpass(old_occ, old_type, val, alpha, occu_thresh):
    """Low-pass occupancy update + re-thresholded type
    (set_hashvoxel_occ_val, voxmap_utils.cuh:181-200)."""
    prev = jnp.where(old_type != VOX_UNKNOWN, old_occ.astype(jnp.float32), 0.0)
    new = alpha * val + (1.0 - alpha) * prev
    new = jnp.clip(new, OCC_VAL_MIN, OCC_VAL_MAX)
    new_u8 = new.astype(jnp.uint8)
    new_type = jnp.where(new_u8 > occu_thresh, VOX_OCCUPIED, VOX_FREE).astype(jnp.int8)
    return new_u8, new_type


def _fence_mask(glb_pos, fence_ll, fence_ur, fence_active, n_obs):
    """Virtual-fence / external-observer AABB obstacle test: outside box 0
    (the inverted flyable-region fence) or inside any box 1..n
    (unify_helper.cuh:73-89; insideAABB voxmap_utils.cuh:202-207).

    fence_ll/ur: [M,3] float32; fence_active: [M] bool; n_obs: int32 scalar.
    """
    M = fence_ll.shape[0]
    pts = glb_pos[..., None, :]
    inside = jnp.all((pts >= fence_ll) & (pts <= fence_ur), axis=-1)
    live = fence_active & (jnp.arange(M) < n_obs)
    out0 = live[0] & ~inside[..., 0]
    rest = jnp.any(inside[..., 1:] & live[1:], axis=-1)
    return out0 | rest
