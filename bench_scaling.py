"""Scaling benchmark: per-frame engine throughput vs device count.

Measurement points: 1 device and all devices of the process (one host's
GPUs).  The canvas is sharded along x over the mesh; the same jitted program
runs at every size.  Each pass ends in block_until_ready.

`--virtual N` instead runs a functional N-way point on virtual CPU devices
(correctness/collective-path exercise, not a hardware scaling number).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_point(n_devices, frames, cfg_overrides, virtual_cpu=False):
    import jax

    if virtual_cpu:
        try:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices", n_devices)
        except Exception:
            pass
    import jax.numpy as jnp

    from gie_mapping_tpu.map_state import MapState, canvas_geometry
    from gie_mapping_tpu.models.pipeline import merge_frame
    from gie_mapping_tpu.parallel.mesh import make_mesh, shard_state
    from gie_mapping_tpu.utils.config import cow_lady_config

    cfg = cow_lady_config(display_glb_edt=False, display_glb_ogm=False,
                          **cfg_overrides)
    mesh = make_mesh(n_devices) if n_devices > 1 else None
    state = MapState.create(cfg)
    if mesh is not None:
        state = shard_state(state, mesh)

    rng = np.random.default_rng(0)
    inst = np.full(cfg.local_size, 1, np.int8)
    inst[rng.random(cfg.local_size) < 0.01] = 2
    pvt = np.zeros(3, np.int32)
    ob, _, off = canvas_geometry(cfg, pvt)
    M = cfg.max_ext_obs
    fence = (jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
             jnp.zeros((M,), jnp.bool_), jnp.int32(0))
    args = (jnp.asarray(inst), jnp.zeros(cfg.local_size, jnp.int32),
            jnp.asarray(pvt), jnp.asarray(ob), jnp.asarray(off)) + fence

    state, out = merge_frame(state, *args, cfg=cfg, input_pointcloud=False,
                             mesh=mesh)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(frames):
        state, out = merge_frame(state, *args, cfg=cfg, input_pointcloud=False,
                                 mesh=mesh)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) * 1e3 / frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--virtual", type=int, default=0,
                    help="ALSO run an N-way virtual-CPU point (functional)")
    args = ap.parse_args()

    import jax

    from gie_mapping_tpu.runtime.compile_cache import enable
    from gie_mapping_tpu.runtime.devinfo import device_record

    enable()
    if args.virtual:
        # functional N-way run on virtual CPU devices: exercises the sharded
        # program + collectives; NOT a hardware scaling number
        try:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices", args.virtual)
        except Exception:
            pass

    device = device_record()
    n_avail = device["device_count"]
    points = {}
    t1 = run_point(1, args.frames, {})
    points["1"] = t1
    if n_avail > 1:
        tn = run_point(n_avail, args.frames, {})
        points[str(n_avail)] = tn
        points["scaling_efficiency"] = t1 / tn / n_avail
    print(json.dumps({
        "metric": "cowlady_merge_ms_per_frame_by_devices",
        "value": points.get(str(n_avail), points["1"]),
        "unit": "ms",
        "vs_baseline": 10.0 / points.get(str(n_avail), points["1"]),
        "extra": {"points_ms": points, "device": device},
    }))


if __name__ == "__main__":
    main()
