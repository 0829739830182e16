"""Headline benchmark: cow-lady-class workload (0.1 m voxels, 100x100x30
scrolling window, fast_mode off, 2 m cutoff) on one GPU.

Measures the ENGINE's per-frame time (sensor ingest + OGM fusion + batch EDT
+ incremental global EDT), the analogue of the reference's "OGM time +
Global EDT time" device brackets (volumetric_mapper.cpp:186-203): each pass
dispatches N_FRAMES frames as scanned replay and ends in block_until_ready;
N_PASSES passes are timed.

Prints ONE JSON line; vs_baseline = 10ms-target / best pass (>1 is better
than the BASELINE.md budget).  Fails unless JAX runs on a GPU.
"""

from __future__ import annotations

import json
import time

import numpy as np

N_WARMUP = 3
N_FRAMES = 40
N_PASSES = 5
# real cow-lady clouds are 100-300 k points/frame (reference
# pntcld_map_maker.cpp:49-61); 131072 LIVE points per frame, capacity ==
# live, so no padded scatter indices
N_RAYS = 131072
CHUNK = 40  # frames per scanned replay dispatch: one program per pass
TARGET_MS = 10.0


def main():
    from gie_mapping_tpu.runtime.compile_cache import enable
    from gie_mapping_tpu.runtime.devinfo import require_gpu

    enable()
    device = require_gpu()
    import jax

    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.runtime.datasets import BoxWorld, circular_trajectory
    from gie_mapping_tpu.utils.config import cow_lady_config

    cfg = cow_lady_config(
        max_raycast_points=N_RAYS,
        fuse_raycast=True,      # sensor model inside the frame program
        display_glb_edt=False,  # streaming is visualisation cadence, not
        display_glb_ogm=False,  # engine time (reference: vis_interval path)
    )
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    # CLOSED loop: the last measured pose is adjacent to the first, so
    # repeated passes wrap with an ordinary scroll (one scan program per
    # pass) instead of a teleport-scale jump that forces per-frame fallbacks
    poses_m = circular_trajectory(n_frames=N_FRAMES, radius=1.5, height=1.2,
                                  closed=True)
    poses = poses_m[:N_WARMUP] + poses_m
    frames = [
        world.pointcloud(p, n_rays=N_RAYS, max_range=8.0, seed=i)
        for i, p in enumerate(poses)
    ]

    mapper = VolumetricMapper(cfg)
    # sensor buffers are staged on the device before the timed loop: the
    # benchmark times the engine, not the host->device upload
    pts, val = mapper.stage_pointcloud_batch(frames)

    # warmup: compile (per-frame + scan programs) + first allocations
    for i in range(N_WARMUP):
        out = mapper.process_pointcloud(poses[i], pts[i], val[i])
    out = mapper.process_pointcloud_batch(
        poses[N_WARMUP:], pts[N_WARMUP:], val[N_WARMUP:], chunk=CHUNK)
    jax.block_until_ready(mapper.state)

    per_pass = []
    for _ in range(N_PASSES):
        t0 = time.perf_counter()
        out = mapper.process_pointcloud_batch(
            poses[N_WARMUP:], pts[N_WARMUP:], val[N_WARMUP:], chunk=CHUNK)
        jax.block_until_ready(mapper.state)
        per_pass.append((time.perf_counter() - t0) * 1e3 / N_FRAMES)

    best = min(per_pass)
    print(json.dumps({
        "metric": "cowlady_ogm_edt_ms_per_frame",
        "value": best,
        "unit": "ms",
        "vs_baseline": TARGET_MS / best,
        "extra": {
            "device": device,
            "frames": N_FRAMES,
            "passes_ms": per_pass,
            "median_ms": float(np.median(per_pass)),
            "dispatch_mode": f"scan_chunk_{CHUNK}",
            "mvoxels_per_s": cfg.map_volume * 1e3 / best / 1e6,
            # change-gated EDT observability: menu level of the last frame
            # (len(menu) = full recompute, lower = smaller slab)
            "gate_level_last": int(out.gate_level),
            "gate_slab_vox_last": int(out.gate_slab_vox),
            "rays_per_frame": N_RAYS,
        },
    }), flush=True)


if __name__ == "__main__":
    main()
