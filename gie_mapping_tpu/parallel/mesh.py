"""Device-mesh sharding of the mapping engine.

The reference is single-GPU with no distributed backend (SURVEY.md §2 P9);
multi-device scale-out is first-class here:

* the **canvas** (dense working region of the incremental EDT) is sharded
  along its x axis over the mesh — every relaxation sweep's 6-neighbour
  shifts become XLA-inserted halo exchanges (collective-permute),
  and the convergence flag is an implicit psum (jnp.any over a sharded
  array);
* the **block pool** is sharded along the block axis, spreading global-map
  memory across chips;
* the local window / sensor arrays are small and stay replicated — every
  host feeds the same observation, as per SURVEY.md §5's distributed plan.

No NCCL/MPI-style code exists here: `jax.sharding.NamedSharding` annotations
+ the XLA SPMD partitioner are the entire communication layer.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

MESH_AXIS = "gx"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the canvas-x axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (MESH_AXIS,))


def canvas_sharding(mesh: Mesh) -> NamedSharding:
    """Dense canvas arrays: sharded along x (dim 0)."""
    return NamedSharding(mesh, P(MESH_AXIS))


def pool_sharding(mesh: Mesh) -> NamedSharding:
    """Pool arrays: sharded along the block axis (dim 0)."""
    return NamedSharding(mesh, P(MESH_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state, mesh: Mesh):
    """Place a MapState with the canvas sharded along x and the archive
    sharded along the block axis.  Arrays whose leading dimension does not
    divide the mesh fall back to replication (e.g. odd `max_blocks`)."""
    import dataclasses

    n = mesh.size
    cs = canvas_sharding(mesh)
    ps = pool_sharding(mesh)
    rs = replicated(mesh)

    def put(arr, sh):
        if sh is not rs and arr.shape[0] % n != 0:
            sh = rs
        return jax.device_put(arr, sh)

    return dataclasses.replace(
        state,
        origin_blk=put(state.origin_blk, rs),
        occ_val=put(state.occ_val, cs),
        vox_type=put(state.vox_type, cs),
        dist_sq=put(state.dist_sq, cs),
        coc=put(state.coc, cs),
        present=put(state.present, rs),  # tiny block-flag grid
        arch_keys=put(state.arch_keys, ps),
        n_arch=put(state.n_arch, rs),
        a_packed=put(state.a_packed, ps),
        arch_dropped=put(state.arch_dropped, rs),
        dmax_cell=put(state.dmax_cell, rs),  # tiny cell grid
        p1c=put(state.p1c, cs),      # unused under a mesh (pipeline gates
        # it) — canvas-sharded rather than replicated so a mistakenly-on
        # knob costs 1/n per device, not a full copy
        p1c_ok=put(state.p1c_ok, rs),
    )


# backwards-compatible alias
shard_global_map = shard_state
