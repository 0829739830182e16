"""Six-config benchmark suite: one JSON line per BASELINE.md configuration.

The reference's de-facto benchmark is replaying its dataset bags through its
launch configs (README.md:102-145; cfg/*.yaml + launch/*.launch — BASELINE.md
table).  This suite reproduces each configuration's engine parameters and
sensor pipeline on synthetic worlds and measures, per config:

  * ms/frame      — engine time (sensor + fusion + EDT + merge), scanned-
                    replay dispatch, each pass ending in block_until_ready,
                    best of N_PASSES (same methodology as bench.py)
  * Mvox/s        — window voxels updated per second
  * edt_ms        — batch EDT alone over the case's canvas, chained on the
                    run's FINAL occupancy

Run on a GPU:  python bench_suite.py [--cases cow_lady,depthcam]
Prints one JSON line per case + a trailing summary line; every line names
the device.  Fails unless JAX runs on a GPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_WARMUP = 2
N_PASSES = 3
CHUNK = 40  # frames per scan program
K_EDT = 8

# Trajectory sampling granularity: the angular step is FIXED at BASE_FRAMES
# poses per closed loop regardless of chunk, so longer programs wind whole
# extra loops of the SAME circle (closed wrap -> ordinary scrolls) and
# per-frame device work matches a fixed-frame-rate sensor.
BASE_FRAMES = 40


def case_world_poses(cfg, chunk):
    """(world, poses_m, n_frames) at the fixed BASE_FRAMES step granularity."""
    from gie_mapping_tpu.runtime.datasets import BoxWorld, circular_trajectory

    extent = min(cfg.local_size_m[0] * 0.45, 4.5)
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=extent,
                              height=max(cfg.local_size_m[2], 2.5))
    loops = max(1, (chunk + BASE_FRAMES - 1) // BASE_FRAMES)
    base = circular_trajectory(n_frames=BASE_FRAMES, radius=extent * 0.35,
                               height=cfg.local_size_m[2] * 0.4, closed=True)
    return world, base * loops, BASE_FRAMES * loops

# Per-case targets: BASELINE.md names only the cow-lady 10 ms budget; the
# others reuse it as the common "real-time at 2 Hz with huge margin" bar.
TARGET_MS = 10.0


def _timed(fn, n, reps):
    """Best per-item ms of `reps` calls of fn (each synchronised)."""
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, (time.perf_counter() - t0) * 1e3 / n)
    return best


def _make_frames(case, cfg, world, poses):
    """(batch_fn, per-frame fallback data) for the case's sensor pipeline."""
    from gie_mapping_tpu.runtime.datasets import BoxWorld  # noqa: F401

    K = len(poses)
    if case in ("cow_lady", "ugv_corridor", "uav_raycast_fine"):
        n_rays = cfg.max_raycast_points
        clouds = [world.pointcloud(p, n_rays=n_rays, max_range=8.0, seed=i)
                  for i, p in enumerate(poses)]
        return "pointcloud", clouds, {}
    if case == "scan2D":
        scans = [world.scan_2d(p, n_beams=720) for p in poses]
        return "scan", np.stack([s[0] for s in scans]), {
            "theta_min": scans[0][1], "theta_inc": scans[0][2]}
    if case == "depthcam":
        imgs = [world.depth_image(p, rows=96, cols=128, fx=80.0, fy=80.0,
                                  max_range=6.0) for p in poses]
        d0 = imgs[0]
        return "depth", np.stack([im[0] for im in imgs]), {
            "fx": d0[1], "fy": d0[2], "cx": d0[3], "cy": d0[4]}
    if case == "laser3D":
        scans = [world.multiscan(p) for p in poses]
        s0 = scans[0]
        return "multiscan", np.stack([s[0] for s in scans]), {
            "theta_min": s0[1], "theta_inc": s0[2], "phi_min": s0[3],
            "phi_inc": s0[4]}
    raise KeyError(case)


def bench_case(case: str):
    import jax
    import jax.numpy as jnp

    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.ops.edt_batch import batch_edt
    from gie_mapping_tpu.utils.config import load_config

    overrides = dict(display_glb_edt=False, display_glb_ogm=False,
                     display_loc_edt=False, display_loc_ogm=False)
    if case in ("cow_lady", "ugv_corridor", "uav_raycast_fine"):
        overrides.update(max_raycast_points=16384, fuse_raycast=True)
    cfg = load_config(case, **overrides)

    chunk = CHUNK
    world, poses_m, n_frames = case_world_poses(cfg, chunk)
    poses = poses_m[:N_WARMUP] + poses_m  # closed loop: passes wrap with an
    # ordinary scroll -> each pass plans as one scan program
    kind, data, kw = _make_frames(case, cfg, world, poses)

    mapper = VolumetricMapper(cfg)
    if kind == "pointcloud":
        pts, val = mapper.stage_pointcloud_batch(data)
        run = lambda lo, hi: mapper.process_pointcloud_batch(
            poses[lo:hi], pts[lo:hi], val[lo:hi], chunk=chunk)
        warm = lambda i: mapper.process_pointcloud(poses[i], pts[i], val[i])
    else:
        dev = jnp.asarray(data)
        batch_call = {"scan": mapper.process_scan2d_batch,
                      "depth": mapper.process_depth_batch,
                      "multiscan": mapper.process_multiscan_batch}[kind]
        per_call = {"scan": mapper.process_scan2d,
                    "depth": mapper.process_depth,
                    "multiscan": mapper.process_multiscan}[kind]
        run = lambda lo, hi: batch_call(poses[lo:hi], dev[lo:hi], chunk=chunk,
                                        **kw)
        warm = lambda i: per_call(poses[i], dev[i], *kw.values())

    for i in range(N_WARMUP):
        warm(i)
    out = run(N_WARMUP, N_WARMUP + n_frames)
    jax.block_until_ready(mapper.state)  # compile + first allocations done

    def one_pass():
        run(N_WARMUP, N_WARMUP + n_frames)
        return mapper.state

    ms = _timed(one_pass, n_frames, N_PASSES)

    # stage split: batch EDT alone over this case's canvas, on the final
    # occupancy (chained in one program)
    glb = mapper.state.vox_type
    mw = sum(cfg.canvas_size)

    @jax.jit
    def edt_chain(g):
        def body(g, _):
            r = batch_edt(g, max_width=mw)["dist_sq"]
            g2 = (g + (r.reshape(-1)[0] % 1).astype(g.dtype)).astype(g.dtype)
            return g2, ()
        g, _ = jax.lax.scan(body, g, None, length=K_EDT)
        return g

    jax.block_until_ready(edt_chain(glb))
    edt_best = _timed(lambda: edt_chain(glb), K_EDT, 2)

    # ---- tail latency: a planner consuming frames at the reference's
    # 2 Hz cadence (volumetric_mapper.cpp:129) cares about the WORST frame,
    # which the chunked replay average hides.  Per-frame timing inside one
    # scan program is not observable, so the tail is derived from measured
    # STAGE costs in the same run:
    #   steady_ms   scroll-free replay of the same shapes (has_scrolls=False
    #               scan, same chunk -> includes the program-quantum share)
    #   scroll_ms   one compacted in-scan scroll step (chained _do_scroll)
    #   teleport_ms the full-canvas scroll path (forced-full worst case)
    # p50 ~= steady; p95 = steady + scroll where scrolls occur on > 5% of
    # frames (they do on every budget-line config); worst = steady +
    # teleport (teleport-scale jumps and force_full epochs).
    scroll_rate = (mapper.replay_scanned_scrolls
                   / max(mapper.replay_scanned_frames, 1))
    steady_poses = [poses_m[-1]] * n_frames
    if kind == "pointcloud":
        run_steady = lambda: mapper.process_pointcloud_batch(
            steady_poses, pts[N_WARMUP:], val[N_WARMUP:], chunk=chunk)
    else:
        run_steady = lambda: batch_call(
            steady_poses, dev[N_WARMUP:], chunk=chunk, **kw)
    run_steady()
    jax.block_until_ready(mapper.state)  # compile + sync

    def steady_pass():
        run_steady()
        return mapper.state

    steady_best = _timed(steady_pass, n_frames, 2)

    from gie_mapping_tpu.map_state import _do_scroll

    st0 = mapper.state
    rows = mapper._scroll_compact_rows(
        np.asarray(st0.origin_blk) + np.array([1, 0, 0]),
        prev=np.asarray(st0.origin_blk))

    def _scroll_chain(rows):
        @jax.jit
        def chain(s):
            def body(s, _):
                delta = jnp.where((s.origin_blk[0] % 2) == 0, 1, -1)
                tgt = s.origin_blk.at[0].add(delta)
                return _do_scroll(s, tgt, cfg, compact_rows=rows), ()
            s, _ = jax.lax.scan(body, s, None, length=K_EDT)
            # consume EVERY carried leaf: returning only origin_blk lets
            # XLA's while-loop simplifier delete the entire scroll as dead
            # code
            return jax.tree_util.tree_reduce(
                lambda x, y: x + jnp.float32(
                    y.reshape(-1)[0].astype(jnp.float32)),
                s, jnp.float32(0))
        jax.block_until_ready(chain(st0))
        return _timed(lambda: chain(st0), K_EDT, 2)

    scroll_best = _scroll_chain(rows)
    # teleport = the path the mapper dispatches for teleport-scale shifts
    # (mapper._scroll_compact_rows -> None: the dense full-canvas scroll)
    cb = np.asarray(cfg.canvas_blocks)
    teleport_best = _scroll_chain(mapper._scroll_compact_rows(
        np.asarray(st0.origin_blk) + 10 * cb, prev=np.asarray(st0.origin_blk)))
    p95 = steady_best + (scroll_best if scroll_rate > 0.05 else 0.0)

    return {
        "metric": f"{case}_ogm_edt_ms_per_frame",
        "value": ms,
        "unit": "ms",
        "vs_baseline": TARGET_MS / ms,
        "extra": {
            "case": case,
            "frames": n_frames,
            "dispatch_mode": f"scan_chunk_{chunk}",
            "mvoxels_per_s": cfg.map_volume * 1e3 / ms / 1e6,
            "edt_ms": edt_best,
            "steady_ms": steady_best,
            "scroll_ms": scroll_best,
            "teleport_ms": teleport_best,
            "scroll_rate": scroll_rate,
            "p50_ms": steady_best,
            "p95_ms": p95,
            "worst_ms": steady_best + teleport_best,
            "canvas": list(cfg.canvas_size),
            "window": list(cfg.local_size),
            "sensor": kind,
        },
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="scan2D,ugv_corridor,cow_lady,"
                    "depthcam,laser3D,uav_raycast_fine")
    ap.add_argument("--out", default=None,
                    help="also append results to this JSON-lines file")
    args = ap.parse_args()

    from gie_mapping_tpu.runtime.compile_cache import enable
    from gie_mapping_tpu.runtime.devinfo import require_gpu

    enable()
    device = require_gpu()
    results = []
    for case in args.cases.split(","):
        r = bench_case(case.strip())
        r["extra"]["device"] = device
        results.append(r)
        print(json.dumps(r), flush=True)
    summary = {"metric": "suite_geomean_vs_baseline",
               "value": float(np.exp(np.mean(
                   [np.log(max(r["vs_baseline"], 1e-9)) for r in results]))),
               "unit": "x", "device": device}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in results + [summary]:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
