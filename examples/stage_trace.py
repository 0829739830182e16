#!/usr/bin/env python
"""Where a frame's device time goes, per named stage, on the GPU.

    python examples/stage_trace.py [--cases cow_lady,depthcam]

For each case: a closed-loop scanned replay as in bench_suite (cow_lady at
the headline 131,072-point clouds), timed over 5 passes (each ending in
block_until_ready), then one pass under `jax.profiler`.  The trace is
reduced by runtime/trace_metrics.py: device busy time, idle share over the
pass, and kernel time per named stage (edt_envelope, edt_phase1, scroll,
panorama_lookup, image_lookup, stream_extract; the rest is "other"), using
XLA's optimized-HLO dump to map kernels to stages (by HLO op, else by
kernel name: kernels launched from a command buffer report the buffer).

One JSON line per case on stdout and in chiprun_out/stage_trace.jsonl, with
the card and its power limit.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out")
DUMP = os.path.join(OUT, "xla_dump")


def replay_setup(case):
    """(run() -> state, n_frames, cold seconds) of a warmed-up replay."""
    import jax
    import jax.numpy as jnp

    import bench_suite as bs
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.utils.config import load_config

    kw = dict(display_glb_edt=False, display_glb_ogm=False,
              display_loc_edt=False, display_loc_ogm=False)
    if case in ("cow_lady", "ugv_corridor", "uav_raycast_fine"):
        kw.update(fuse_raycast=True, max_raycast_points=(
            131072 if case == "cow_lady" else 16384))
    cfg = load_config(case, **kw)
    world, poses_m, n = bs.case_world_poses(cfg, bs.CHUNK)
    poses = poses_m[:bs.N_WARMUP] + poses_m
    kind, data, skw = bs._make_frames(case, cfg, world, poses)
    m = VolumetricMapper(cfg)
    w = bs.N_WARMUP
    if kind == "pointcloud":
        pts, val = m.stage_pointcloud_batch(data)
        for i in range(w):
            m.process_pointcloud(poses[i], pts[i], val[i])

        def run():
            m.process_pointcloud_batch(poses[w:], pts[w:], val[w:],
                                       chunk=bs.CHUNK)
            return m.state
    else:
        dev = jnp.asarray(data)
        per = {"scan": m.process_scan2d, "depth": m.process_depth,
               "multiscan": m.process_multiscan}[kind]
        batch = {"scan": m.process_scan2d_batch,
                 "depth": m.process_depth_batch,
                 "multiscan": m.process_multiscan_batch}[kind]
        for i in range(w):
            per(poses[i], dev[i], *skw.values())

        def run():
            batch(poses[w:], dev[w:], chunk=bs.CHUNK, **skw)
            return m.state
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    return run, n, time.perf_counter() - t0


def trace_case(case):
    import jax

    from gie_mapping_tpu.runtime import trace_metrics as tm
    from gie_mapping_tpu.runtime.devinfo import device_record

    run, n, cold = replay_setup(case)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        ts.append((time.perf_counter() - t0) * 1e3 / n)
    tdir = os.path.join(OUT, f"trace_{case}")
    shutil.rmtree(tdir, ignore_errors=True)
    with jax.profiler.trace(tdir):
        jax.block_until_ready(run())
    xp = glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                "*.xplane.pb"))[0]
    m = tm.stage_metrics(xp, tm.hlo_stage_map(DUMP))
    # which of the heaviest kernels the HLO dump names, for the record
    evs = tm.device_events(xp)
    known = set().union(*(ins.keys() for _, _, ins in
                          tm.hlo_stage_map(DUMP)))
    heavy = sorted(evs, key=lambda e: e[0] - e[1])[:5]
    print(json.dumps({"heavy_events": [
        (e[2], e[3], e[4], e[5], tm._norm(e[2]) in known) for e in heavy]}))
    shutil.rmtree(tdir, ignore_errors=True)
    busy_frame = m["busy_ns"] / n / 1e6
    rec = {"what": "stage_trace", "case": case, "frames": n,
           "ms_per_frame_best": min(ts), "ms_per_frame_passes": ts,
           "cold_first_pass_s": cold,
           "device_busy_ms_per_frame": busy_frame,
           "idle_share": m["idle_share"],
           "stage_ms_per_frame": {k: v / n / 1e6
                                  for k, v in m["stage_ns"].items()},
           "stage_share_of_busy": {k: v / m["kernel_ns"]
                                   for k, v in m["stage_ns"].items()},
           "top_kernels_ms_per_frame": [(k, v / n / 1e6)
                                        for k, v in m["top_kernels"]],
           "device": device_record()}
    line = json.dumps(rec)
    print(line, flush=True)
    with open(os.path.join(OUT, "stage_trace.jsonl"), "a") as f:
        f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="cow_lady,depthcam")
    args = ap.parse_args()
    # the stage map reads XLA's optimized HLO: dump before JAX starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={DUMP}"
                               " --xla_dump_hlo_as_text")
    os.makedirs(OUT, exist_ok=True)
    import jax

    from gie_mapping_tpu.runtime.devinfo import require_gpu

    # programs loaded from a persistent compile cache are not compiled, so
    # XLA would dump no HLO for them: this run compiles everything
    jax.config.update("jax_enable_compilation_cache", False)
    require_gpu()
    try:
        for case in args.cases.split(","):
            trace_case(case.strip())
    finally:
        shutil.rmtree(DUMP, ignore_errors=True)


if __name__ == "__main__":
    main()
