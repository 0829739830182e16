"""Console entry point: run any benchmark case end-to-end — the `roslaunch GIE <case>.launch`
equivalent (reference README.md:106-145).

Data sources:
  * default: procedural world + analytic sensor simulation (runtime/datasets)
  * --replay frames.npz: offline-converted bag (save_frames_npz format)

Examples:
  gie-tpu-run cow_lady --frames 20
  gie-tpu-run scan2D --frames 50 --profile
  gie-tpu-run depthcam --replay /data/depth_frames.npz
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from gie_mapping_tpu.models.mapper import VolumetricMapper
from gie_mapping_tpu.runtime.datasets import (
    BoxWorld,
    circular_trajectory,
    load_frames_npz,
)
from gie_mapping_tpu.utils import geometry as geo
from gie_mapping_tpu.utils.config import load_config


def synthetic_frames(cfg, n_frames):
    world = BoxWorld.corridor(seed=11, n_pillars=8,
                              extent=max(cfg.local_size_m[:2]) * 0.7,
                              height=max(1.5, cfg.local_size_m[2]))
    poses = circular_trajectory(n_frames, radius=cfg.local_size_m[0] * 0.15,
                                height=cfg.local_size_m[2] * 0.4)
    for i, proj in enumerate(poses):
        case = cfg.data_case
        if case in ("cow_lady", "ugv_corridor", "uav_raycast_fine"):
            pts = world.pointcloud(proj, n_rays=8192, seed=i,
                                   max_range=0.8 * cfg.local_size_m[0])
            yield proj, ("pointcloud", pts)
        elif case == "scan2D":
            r, tmin, tinc = world.scan_2d(proj, n_beams=360)
            yield proj, ("scan", (r, tmin, tinc))
        elif case == "depthcam":
            depth, fx, fy, cx, cy = world.depth_image(proj)
            yield proj, ("depth", (depth, fx, fy, cx, cy))
        elif case == "laser3D":
            img, tmin, tinc, pmin, pinc = world.multiscan(proj)
            yield proj, ("multiscan", (img, tmin, tinc, pmin, pinc))
        else:
            raise KeyError(case)


def replay_frames(path):
    for fr in load_frames_npz(path):
        proj = geo.Projection.from_pose(fr["position"], fr["quat_wxyz"])
        if "points" in fr:
            yield proj, ("pointcloud", fr["points"])
        elif "ranges" in fr:
            yield proj, ("scan", (fr["ranges"], float(fr["theta_min"]),
                                  float(fr["theta_inc"])))
        elif "depth" in fr:
            yield proj, ("depth", (fr["depth"], float(fr["fx"]), float(fr["fy"]),
                                   float(fr["cx"]), float(fr["cy"])))
        elif "rings" in fr:
            yield proj, ("multiscan", (fr["rings"], float(fr["theta_min"]),
                                       float(fr["theta_inc"]), float(fr["phi_min"]),
                                       float(fr["phi_inc"])))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=["scan2D", "cow_lady", "ugv_corridor",
                                     "depthcam", "laser3D", "uav_raycast_fine"])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--replay", type=str, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="enable RMSE ground-truth checking + CSV log")
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--save", type=str, default=None, help="checkpoint path")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--staged", action="store_true",
                    help="pre-upload sensor payloads to the device before the "
                         "measured loop (engine time, not host->device "
                         "transfer time)")
    ap.add_argument("--merge-mode", choices=["canvas_edt", "relax"],
                    default=None,
                    help="override the incremental-EDT engine (default: the "
                         "case preset; 'relax' is the reference-mirroring "
                         "wavefront engine)")
    ap.add_argument("--gate", choices=["on", "off"], default=None,
                    help="override cfg.edt_gate (change-gated canvas EDT: "
                         "recompute only the affected slab per frame)")
    ap.add_argument("--gate-pmode", choices=["voxel", "block"], default=None,
                    help="override cfg.edt_gate_pmode (affected-region test "
                         "granularity; 'block' uses the maintained per-cell "
                         "dist bound instead of a full-canvas read)")
    ap.add_argument("--p1-cache", choices=["on", "off"], default=None,
                    help="override cfg.edt_p1_cache (patch the cached packed "
                         "phase-1 word over the flip bbox instead of "
                         "rescanning the canvas on non-scroll frames)")
    ap.add_argument("--batch", type=int, default=0, metavar="K",
                    help="scanned-replay mode: dispatch frames as lax.scan "
                         "chunks of K (process_*_batch; bit-identical to the "
                         "per-frame loop)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run SPMD over an N-device mesh (canvas sharded "
                         "along x); with --cpu, N virtual devices are "
                         "created — bit-identical to single-device")
    args = ap.parse_args()

    from gie_mapping_tpu.runtime.compile_cache import enable

    enable()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.mesh > 1:
            jax.config.update("jax_num_cpu_devices", args.mesh)

    mesh = None
    if args.mesh > 1:
        from gie_mapping_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh)

    cfg = load_config(args.case)
    if args.merge_mode is not None:
        cfg = cfg.replace(merge_mode=args.merge_mode)
    if args.gate is not None:
        cfg = cfg.replace(edt_gate=(args.gate == "on"))
    if args.gate_pmode is not None:
        cfg = cfg.replace(edt_gate_pmode=args.gate_pmode)
    if args.p1_cache is not None:
        cfg = cfg.replace(edt_p1_cache=(args.p1_cache == "on"))
    if args.batch and args.profile:
        # the RMSE ground-truth checker needs per-frame host data, which the
        # scanned replay doesn't surface — profile runs stay per-frame
        print("--profile needs per-frame dispatch; ignoring --batch",
              file=sys.stderr)
        args.batch = 0
    if args.batch:
        cfg = cfg.replace(fuse_raycast=True)  # batch pointcloud path needs it
    if args.profile:
        cfg = cfg.replace(profile_loc_rms=True)
    if args.staged:
        # engine-time mode (bench.py methodology): visualization streaming
        # (a device->host readback per vis_interval) is excluded here
        cfg = cfg.replace(display_glb_edt=False, display_glb_ogm=False)
    mapper = VolumetricMapper(cfg, log_path=args.log, mesh=mesh)

    # materialise frames first: dataset simulation / replay decode is not
    # engine time
    src = list(replay_frames(args.replay) if args.replay
               else synthetic_frames(cfg, args.frames))
    if args.staged:
        import jax.numpy as jnp

        # size the static point capacity to the data (a deployment sizes its
        # buffer to the sensor; padding 8k synthetic rays to the default 64k
        # capacity would 8x the raycast work)
        maxpts = max((len(p) for _, (k, p) in src if k == "pointcloud"),
                     default=0)
        if maxpts:
            cap = 1 << (maxpts - 1).bit_length()
            cfg = cfg.replace(max_raycast_points=min(
                cfg.max_raycast_points, max(cap, 4096)))
            mapper = VolumetricMapper(cfg, log_path=args.log, mesh=mesh)

        def _stage(kind, payload):
            if kind == "pointcloud":
                return mapper.stage_pointcloud(payload)
            arrs = tuple(jnp.asarray(np.asarray(p, np.float32))
                         if isinstance(p, np.ndarray) else p for p in payload)
            jnp.asarray(arrs[0]).block_until_ready()
            return arrs

        src = [(proj, (kind, _stage(kind, payload)))
               for proj, (kind, payload) in src]
    warm = src[:4] if args.staged and len(src) > 5 else []
    src = src[len(warm):]

    def dispatch(proj, kind, payload):
        if kind == "pointcloud":
            return (mapper.process_pointcloud(proj, *payload) if args.staged
                    else mapper.process_pointcloud(proj, payload))
        if kind == "scan":
            return mapper.process_scan2d(proj, *payload)
        if kind == "depth":
            return mapper.process_depth(proj, *payload)
        if kind == "multiscan":
            return mapper.process_multiscan(proj, *payload)
        raise KeyError(kind)

    run_batch = None
    if args.batch:
        import jax.numpy as jnp

        projs_b = [p for p, _ in src]
        kind0 = src[0][1][0]
        pls = [pl for _, (_, pl) in src]

        def scal(idx):
            return np.asarray([float(pl[idx]) for pl in pls], np.float32)

        if kind0 == "pointcloud":
            if args.staged:  # already-staged (points, valid) pairs
                pts_b = jnp.stack([pl[0] for pl in pls])
                val_b = jnp.stack([pl[1] for pl in pls])
            else:
                pts_b, val_b = mapper.stage_pointcloud_batch(pls)
            run_batch = lambda: mapper.process_pointcloud_batch(
                projs_b, pts_b, val_b, chunk=args.batch)
        else:
            data = jnp.asarray(
                np.stack([np.asarray(pl[0], np.float32) for pl in pls]))
            if kind0 == "scan":
                run_batch = lambda: mapper.process_scan2d_batch(
                    projs_b, data, scal(1), scal(2), chunk=args.batch)
            elif kind0 == "depth":
                run_batch = lambda: mapper.process_depth_batch(
                    projs_b, data, scal(1), scal(2), scal(3), scal(4),
                    chunk=args.batch)
            elif kind0 == "multiscan":
                run_batch = lambda: mapper.process_multiscan_batch(
                    projs_b, data, scal(1), scal(2), scal(3), scal(4),
                    chunk=args.batch)

    for proj, (kind, payload) in warm:  # compile frame+scroll programs
        out = dispatch(proj, kind, payload)
    if warm:
        out.fetch()
    if run_batch is not None and warm:  # compile the scan program untimed
        out = run_batch()
        out.fetch()
    # staged mode: several passes, best one — late-appearing program variants
    # (e.g. the first ordinary scroll) trace/compile inside pass 1
    n_passes = 3 if warm else 1
    wall = float("inf")
    for _pass in range(n_passes):
        t0 = time.perf_counter()
        if run_batch is not None:
            out = run_batch()
            n = len(src)
        else:
            n = 0
            for proj, (kind, payload) in src:
                out = dispatch(proj, kind, payload)
                n += 1
        out.fetch()
        dt = time.perf_counter() - t0
        print(f"pass {_pass}: {dt*1e3/max(n,1):.2f} ms/frame", file=sys.stderr)
        wall = min(wall, dt)

    if mapper.mirror is not None:
        mapper.flush_stream()  # ingest in-flight streamed rows before reporting
    if args.save:
        mapper.save(args.save)

    print(json.dumps({
        "case": args.case,
        "frames": n,
        "wall_s": round(wall, 3),
        "ms_per_frame": round(wall * 1e3 / max(n, 1), 2),
        "occupied_voxels": int((out.glb_type == 2).sum()),
        "gate_level_last": int(out.gate_level),
        "frontier_voxels": int(out.fnt_count),
        "mirror_blocks": len(mapper.mirror) if mapper.mirror else 0,
        "arch_dropped": int(out.arch_dropped),
    }))


if __name__ == "__main__":
    main()
