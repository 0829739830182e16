#!/usr/bin/env python
"""Multi-host (multi-process) sharded mapping demo.

Runs the full frame update with the canvas sharded over a GLOBAL device mesh
spanning several processes, validated with multi-process CPU + gloo
collectives (tests/test_multihost.py).

Usage (per process):
    python examples/multihost_demo.py <process_id> <num_processes> \
        [--coordinator 127.0.0.1:45688] [--devices-per-proc 2] [--out out.npz]

Process 0 writes the (all-gathered) window outputs to --out for comparison
against a single-process run.
"""
from __future__ import annotations

import argparse
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("--coordinator", default="127.0.0.1:45688")
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()

    import jax

    # this demo validates the multi-process CPU path; the single-process
    # baseline must run on the same backend for bitwise comparison
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices_per_proc)
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from gie_mapping_tpu.map_state import MapState, canvas_geometry
    from gie_mapping_tpu.models.pipeline import merge_frame
    from gie_mapping_tpu.parallel.mesh import make_mesh, shard_state
    from gie_mapping_tpu.utils.config import scan2d_config
    from gie_mapping_tpu.utils.constants import VOX_FREE, VOX_OCCUPIED

    cfg = scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2,
                        fast_mode=False, cutoff_dist=2.0, max_blocks=1024,
                        for_motion_planner=False)
    n_global = len(jax.devices())
    mesh = make_mesh(n_global) if n_global > 1 else None
    state = MapState.create(cfg)
    if mesh is not None:
        state = shard_state(state, mesh)

    M = cfg.max_ext_obs
    fence = (jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
             jnp.zeros((M,), jnp.bool_), jnp.int32(0))

    outs = []
    for i in range(args.frames):
        rng = np.random.default_rng(i)
        inst = np.full(cfg.local_size, VOX_FREE, np.int8)
        inst[rng.random(cfg.local_size) < 0.03] = VOX_OCCUPIED
        pvt = np.asarray([4 * i, 0, 0], np.int32)
        origin_blk, _, off = canvas_geometry(cfg, pvt)
        state, out = merge_frame(
            state, jnp.asarray(inst), jnp.zeros(cfg.local_size, jnp.int32),
            jnp.asarray(pvt), jnp.asarray(origin_blk), jnp.asarray(off),
            *fence, cfg=cfg, input_pointcloud=False, mesh=mesh,
        )
        outs.append({
            "dist_sq": np.asarray(multihost_utils.process_allgather(out["dist_sq"], tiled=True))
            if args.num_processes > 1 else np.asarray(out["dist_sq"]),
            "glb_type": np.asarray(multihost_utils.process_allgather(out["glb_type"], tiled=True))
            if args.num_processes > 1 else np.asarray(out["glb_type"]),
        })

    if args.process_id == 0:
        print(f"multihost demo ok: {args.num_processes} processes x "
              f"{args.devices_per_proc} devices, {args.frames} frames")
        if args.out:
            flat = {}
            for i, o in enumerate(outs):
                for k, v in o.items():
                    flat[f"{i}/{k}"] = v
            np.savez(args.out, **flat)


if __name__ == "__main__":
    main()
