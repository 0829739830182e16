#!/usr/bin/env python
"""Smoke test of the mapping engine on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --multi    # only the 4-card sharded path vs one card

Phases (any failure exits non-zero, and no result line is printed):

  1. device     JAX's platform is "gpu"; there is no CPU fallback.
  2. presets    all six presets at their preset canvases through the
                normal entry points: per-frame `process_*`, then
                `process_*_batch` scanned replay; every trajectory scrolls.
                cow_lady also runs every frame through the point-cloud
                presets' default per-frame path (fuse_raycast off), held to
                the fused run's map.
  3. exactness  invariants I1-I3 (tests/test_state_invariants.py) on the
                final cow_lady and depthcam states, zero violations; the
                per-frame-only and per-frame-then-replay final states are
                bit-identical for every preset.
  4. card/CPU   the same frames of scan2D and cow_lady on the in-process
                CPU backend: sensor `inst_type` mismatches at most 1e-4 of
                window voxels; fed the same `inst_type`, the merged states
                (fusion, EDT, merge) are bit-identical.
  5. kernels    each hand-written GPU kernel against its plain reference at
                preset widths, bit for bit.  None is kept today: the GPU
                envelope kernel lost to XLA end to end (PERF.md), so this
                phase only reports that.

With --multi, cow_lady's preset canvas runs on a 4-card mesh through the
change-gated EDT (a stop in the trajectory makes it take slab branches) and
scanned replay, bit for bit against one card.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CASES = ("scan2D", "ugv_corridor", "cow_lady", "depthcam", "laser3D",
         "uav_raycast_fine")
POINTCLOUD_CASES = ("cow_lady", "ugv_corridor", "uav_raycast_fine")
# the default unfused point-cloud path compiles its own frame programs
# (~1 min cold per preset); one preset keeps the script within its time
UNFUSED_CASES = ("cow_lady",)
INVARIANT_CASES = ("cow_lady", "depthcam")
CPU_CASES = ("scan2D", "cow_lady")
PER_FRAME = 6        # per-frame frames, then REPLAY frames as one scan
REPLAY = 10
CPU_FRAMES = 3
STEP_VOX = 3.0       # trajectory step per frame, in voxels (forces scrolls)
MULTI_HOLD = range(4, 10)  # --multi: frames that stand still
COW_RAYS = 131072    # the headline cloud size (bench.py)
PC_RAYS = 16384
SENSOR_TOL = 1e-4    # max inst_type mismatch fraction, card vs CPU

# ---- values shared with the package (kept literal: this file must not
# import the package before the checkout check in _import_package) --------
VOX_UNKNOWN, VOX_OCCUPIED = 0, 2
EMPTY_VALUE = 999999
COC_INVALID = 32767


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# ===========================================================================
# checkers (pure numpy; tests/test_chip_smoke.py applies them to CPU runs)
# ===========================================================================

def invariant_violations(vox_type, dist, coc) -> dict:
    """Invariants I1-I3 over every observed canvas voxel with a valid stored
    (dist, coc) pair (canvas-relative cocs):

      I1  dist == |voxel - coc|^2
      I2  an in-canvas coc is an OCCUPIED voxel
      I3  dist <= squared distance to the nearest OCCUPIED canvas voxel

    I3 is exact: the nearest occupied voxel comes from scipy's exact EDT.
    Returns {"checked", "I1", "I2", "I3"} (violation counts)."""
    from scipy import ndimage

    vox_type = np.asarray(vox_type)
    dist = np.asarray(dist).astype(np.int64)
    coc = np.asarray(coc).astype(np.int64)
    valid = ((vox_type != VOX_UNKNOWN) & (dist != EMPTY_VALUE)
             & (coc[..., 0] != COC_INVALID))
    idx = np.nonzero(valid)
    vox = np.stack(idx, -1)
    c = coc[valid]
    d = dist[valid]
    i1 = int((((vox - c) ** 2).sum(-1) != d).sum())
    in_canvas = ((c >= 0) & (c < np.asarray(vox_type.shape))).all(-1)
    ci = c[in_canvas]
    i2 = int((vox_type[ci[:, 0], ci[:, 1], ci[:, 2]] != VOX_OCCUPIED).sum())
    occ = vox_type == VOX_OCCUPIED
    i3 = 0
    if occ.any() and len(d):
        near = ndimage.distance_transform_edt(
            ~occ, return_distances=False, return_indices=True)
        nearest = np.stack([near[a][idx] for a in range(3)], -1)
        i3 = int((d > ((vox - nearest) ** 2).sum(-1)).sum())
    return {"checked": int(len(d)), "I1": i1, "I2": i2, "I3": i3}


def state_arrays(state) -> dict:
    """MapState -> {field: numpy array} (gathers sharded leaves)."""
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def state_diff(a: dict, b: dict) -> list:
    """Names of the state fields whose arrays differ bit for bit."""
    return [k for k in a
            if a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes()]


def mismatch_fraction(a, b) -> tuple:
    """(count, fraction) of elements where a != b."""
    a, b = np.asarray(a), np.asarray(b)
    n = int((a != b).sum())
    return n, n / max(a.size, 1)


def result_line(devices) -> str:
    """The final JSON line, from the devices JAX reports."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


# ===========================================================================
# workload
# ===========================================================================

def case_config(case: str, **overrides):
    """The preset's MapConfig (overrides shrink it for CPU tests)."""
    from gie_mapping_tpu.utils.config import load_config

    kw = {}
    if case in POINTCLOUD_CASES:
        # the scanned-replay point-cloud path runs the sensor in-program
        kw = dict(fuse_raycast=True, max_raycast_points=(
            COW_RAYS if case == "cow_lady" else PC_RAYS))
    return load_config(case, **{**kw, **overrides})


def trajectory(cfg, n: int, hold=()):
    """(poses, steps): n poses on a straight line along +x with a slow yaw,
    STEP_VOX voxels per frame, so the canvas scrolls every few frames.
    Frames in `hold` stay where the frame before them was; steps[i] is the
    number of moves made by frame i."""
    from gie_mapping_tpu.utils import geometry as geo

    step = STEP_VOX * cfg.voxel_width
    z = cfg.local_size_m[2] * 0.4
    steps = []
    for i in range(n):
        steps.append(0 if i == 0 else steps[-1] + (i not in hold))
    out = []
    for t in steps:
        yaw = 0.04 * t
        pos = [-0.5 * step * n + step * t, 0.1 * step * t, z]
        out.append(geo.Projection.from_pose(
            pos, [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]))
    return out, steps


def sensor_frames(case: str, cfg, poses, seeds=None):
    """(kind, per-frame payloads, scalar kwargs) from a seeded box world;
    point clouds draw their rays from seeds[i] (default: the frame index)."""
    from gie_mapping_tpu.runtime.datasets import BoxWorld

    world = BoxWorld.corridor(seed=11, n_pillars=10, extent=6.0,
                              height=max(cfg.local_size_m[2], 2.5))
    if case in POINTCLOUD_CASES:
        n = cfg.max_raycast_points
        seeds = range(len(poses)) if seeds is None else seeds
        return "pointcloud", [world.pointcloud(p, n_rays=n, max_range=8.0,
                                               seed=int(k))
                              for p, k in zip(poses, seeds)], {}
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


class Runner:
    """Feeds one case's frames to a VolumetricMapper through its public
    per-frame and batched entry points."""

    def __init__(self, mapper, kind, data, kw, poses):
        import jax.numpy as jnp

        self.m, self.kind, self.kw, self.poses = mapper, kind, kw, poses
        if kind == "pointcloud":
            self.pts, self.val = mapper.stage_pointcloud_batch(data)
        else:
            self.dev = jnp.asarray(data)

    def frame(self, i):
        m, p = self.m, self.poses[i]
        if self.kind == "pointcloud":
            return m.process_pointcloud(p, self.pts[i], self.val[i])
        fn = {"scan": m.process_scan2d, "depth": m.process_depth,
              "multiscan": m.process_multiscan}[self.kind]
        return fn(p, self.dev[i], *self.kw.values())

    def batch(self, lo, hi):
        m, ps = self.m, self.poses[lo:hi]
        if self.kind == "pointcloud":
            return m.process_pointcloud_batch(ps, self.pts[lo:hi],
                                              self.val[lo:hi], chunk=hi - lo)
        fn = {"scan": m.process_scan2d_batch, "depth": m.process_depth_batch,
              "multiscan": m.process_multiscan_batch}[self.kind]
        return fn(ps, self.dev[lo:hi], chunk=hi - lo, **self.kw)


def run_case(case: str, **overrides) -> dict:
    """Phases 2 and 3 for one preset."""
    import jax

    from gie_mapping_tpu.models.mapper import VolumetricMapper

    cfg = case_config(case, **overrides)
    n = PER_FRAME + REPLAY
    poses, _ = trajectory(cfg, n)
    kind, data, kw = sensor_frames(case, cfg, poses)

    # mapper A: per-frame then scanned replay
    a = Runner(VolumetricMapper(cfg), kind, data, kw, poses)
    gates = set()
    t0 = time.perf_counter()
    out = a.frame(0)
    jax.block_until_ready(a.m.state)
    cold_frame_s = time.perf_counter() - t0
    gates.add(out.gate_level)
    for i in range(1, PER_FRAME):
        gates.add(a.frame(i).gate_level)
    t0 = time.perf_counter()
    out = a.batch(PER_FRAME, n)
    jax.block_until_ready(a.m.state)
    cold_replay_s = time.perf_counter() - t0
    gates.update(int(g) for g in np.asarray(out.per_frame["gate_level"]))
    if a.m.replay_scanned_frames != REPLAY:
        raise PhaseError(f"{case}: replay scanned {a.m.replay_scanned_frames}"
                         f" of {REPLAY} frames")
    if a.m.replay_scanned_scrolls < 1:
        raise PhaseError(f"{case}: the replay run did not scroll")
    if out.arch_dropped != 0:
        raise PhaseError(f"{case}: arch_dropped = {out.arch_dropped}")
    st_a = state_arrays(a.m.state)
    occupied = int((st_a["vox_type"] == VOX_OCCUPIED).sum())
    if occupied == 0:
        raise PhaseError(f"{case}: no occupied voxel in the map")

    # mapper B: every frame per-frame (the reference for the replay)
    b = Runner(VolumetricMapper(cfg), kind, data, kw, poses)
    scrolls = 0
    prev = None
    for i in range(n):
        b.frame(i)
        org = np.asarray(b.m._origin)
        if prev is not None and not np.array_equal(prev, org):
            scrolls += 1
        prev = org
    diff = state_diff(st_a, state_arrays(b.m.state))
    if diff:
        raise PhaseError(f"{case}: replay and per-frame states differ in "
                         f"{diff}")
    if scrolls < 1:
        raise PhaseError(f"{case}: the trajectory did not scroll")
    unfused = (per_frame_unfused(cfg, data, poses, st_a)
               if case in UNFUSED_CASES else None)

    rec = {"case": case, "canvas": list(cfg.canvas_size),
           "canvas_mvox": float(np.prod(cfg.canvas_size)) / 1e6,
           "frames": n, "replay_frames": REPLAY,
           "scrolls": scrolls,
           "replay_scrolls": a.m.replay_scanned_scrolls,
           "gate_levels": sorted(int(g) for g in gates),
           "occupied": occupied, "frontier_last": int(out.fnt_count),
           "arch_dropped": int(out.arch_dropped),
           "cold_first_frame_s": cold_frame_s,
           "cold_first_replay_s": cold_replay_s,
           "replay_bit_identical": True}
    if unfused is not None:
        rec["unfused"] = unfused
    if case in INVARIANT_CASES:
        inv = invariant_violations(st_a["vox_type"], st_a["dist_sq"],
                                   st_a["coc"])
        rec["invariants"] = inv
        if inv["I1"] or inv["I2"] or inv["I3"] or inv["checked"] == 0:
            raise PhaseError(f"{case}: invariant violations {inv}")
    return rec


def per_frame_unfused(cfg, clouds, poses, st_ref) -> dict:
    """The preset's own point-cloud path (fuse_raycast off): host clouds
    through `process_pointcloud`, i.e. the sensor transform, a separate
    `pointcloud_project` program and the frame program on the donated
    MapState.  Its final map is held to the fused run's: the two programs
    differ only in how the sensor stage is compiled, so occupancy may differ
    at panorama bin edges, by at most SENSOR_TOL of the window per frame."""
    from gie_mapping_tpu.models.mapper import VolumetricMapper

    m = VolumetricMapper(cfg.replace(fuse_raycast=False))
    dropped = 0
    for p, cloud in zip(poses, clouds):
        dropped += int(m.process_pointcloud(p, cloud).arch_dropped)
    st = state_arrays(m.state)
    n_mis, _ = mismatch_fraction(st["vox_type"], st_ref["vox_type"])
    bound = SENSOR_TOL * float(np.prod(cfg.local_size)) * len(poses)
    rec = {"frames": len(poses), "arch_dropped": dropped,
           "occupied": int((st["vox_type"] == VOX_OCCUPIED).sum()),
           "vox_type_mismatch": n_mis, "mismatch_bound": bound,
           "bit_identical_to_fused": not state_diff(st, st_ref)}
    if dropped or rec["occupied"] == 0 or n_mis > bound:
        raise PhaseError(f"per-frame point-cloud path (fuse_raycast off): "
                         f"{rec}")
    return rec


def _geometry(cfg, proj):
    from gie_mapping_tpu.map_state import canvas_geometry
    from gie_mapping_tpu.utils import geometry as geo

    pvt = geo.calculate_pivot(np.asarray(proj.trans), cfg.voxel_width,
                              cfg.local_size)
    origin_blk, _, off = canvas_geometry(cfg, pvt)
    return pvt, origin_blk, off


def sensor_stage(case, cfg, proj, payload, kw, pvt):
    """(inst_type, ray_count) of one frame, on the current default device."""
    import jax.numpy as jnp

    from gie_mapping_tpu.ops import raycast as rc
    from gie_mapping_tpu.ops import scan_sensors as ss

    common = dict(local_size=cfg.local_size, voxel_width=cfg.voxel_width,
                  ogm_min_h=cfg.ogm_min_h, ogm_max_h=cfg.ogm_max_h,
                  for_motion_planner=cfg.for_motion_planner,
                  robot_r2_grids=cfg.robot_r2_grids)
    pvt = jnp.asarray(pvt)
    if case == "scan2D":
        param = ss.ScanParam(jnp.float32(kw["theta_min"]),
                             jnp.float32(kw["theta_inc"]),
                             jnp.asarray(payload, jnp.float32))
        inst = ss.hokuyo_update(proj, param, pvt, **common)
        return inst, jnp.zeros(cfg.local_size, jnp.int32)
    pts = jnp.asarray(payload, jnp.float32)
    nt, nph = rc.panorama_bins(cfg.local_size)
    return rc.pointcloud_project(proj.l2g(pts), jnp.ones(len(pts), bool),
                                 proj.trans, pvt, n_theta=nt, n_phi=nph,
                                 **common)


def card_vs_cpu(case: str, **overrides) -> dict:
    """Phase 4 for one case: sensor stage and merge on the card (the default
    device) and on the in-process CPU backend."""
    import jax
    import jax.numpy as jnp

    from gie_mapping_tpu.map_state import MapState
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.models.pipeline import merge_frame
    from gie_mapping_tpu.utils import geometry as geo

    cfg = case_config(case, **overrides)
    poses, _ = trajectory(cfg, CPU_FRAMES)
    kind, data, kw = sensor_frames(case, cfg, poses)
    cpu = jax.devices("cpu")[0]
    pc = kind == "pointcloud"
    fence, fence_on = VolumetricMapper(cfg)._fence_args(
        _geometry(cfg, poses[0])[0])
    states = {"gpu": MapState.create(cfg)}
    with jax.default_device(cpu):
        states["cpu"] = jax.device_put(MapState.create(cfg), cpu)
    mism = total = 0
    for i, p in enumerate(poses):
        pvt, origin_blk, off = _geometry(cfg, p)
        proj = geo.Projection(jnp.asarray(p.rot), jnp.asarray(p.trans))
        inst_g, cnt_g = sensor_stage(case, cfg, proj, data[i], kw, pvt)
        with jax.default_device(cpu):
            proj_c = jax.device_put(proj, cpu)
            inst_c, _ = sensor_stage(case, cfg, proj_c, data[i], kw, pvt)
        m, _ = mismatch_fraction(inst_g, inst_c)
        mism += m
        total += int(np.prod(cfg.local_size))
        geom = (jnp.asarray(pvt), jnp.asarray(origin_blk), jnp.asarray(off))
        for plat in ("gpu", "cpu"):
            dev = cpu if plat == "cpu" else jax.devices()[0]
            with jax.default_device(dev):
                args = jax.device_put((inst_g, cnt_g) + geom + tuple(fence),
                                      dev)
                states[plat], _ = merge_frame(
                    states[plat], *args, cfg=cfg, input_pointcloud=pc,
                    use_fence=fence_on)
    frac = mism / total
    diff = state_diff(state_arrays(states["gpu"]), state_arrays(states["cpu"]))
    rec = {"case": case, "frames": CPU_FRAMES, "inst_mismatch": mism,
           "window_voxels": total, "inst_mismatch_frac": frac,
           "merge_bit_identical": not diff}
    if frac > SENSOR_TOL:
        raise PhaseError(f"{case}: sensor mismatch {frac:.3g} > {SENSOR_TOL}")
    if diff:
        raise PhaseError(f"{case}: card and CPU merges differ in {diff}")
    return rec


def multi_card(n_dev: int = 4, **overrides) -> dict:
    """The sharded path: cow_lady's preset canvas over a 4-card mesh through
    the change-gated EDT and scanned replay, against one card."""
    import jax

    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.models.pipeline import _menu_fracs, _slab_menu
    from gie_mapping_tpu.ops.edt_batch import sharded_edt_ok
    from gie_mapping_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < n_dev:
        raise PhaseError(f"--multi needs {n_dev} devices, found "
                         f"{len(jax.devices())}")
    cfg = case_config("cow_lady", **overrides)
    mesh = make_mesh(n_dev)
    if not sharded_edt_ok(cfg.canvas_size, mesh):
        raise PhaseError(f"canvas {cfg.canvas_size} does not shard over "
                         f"{n_dev} devices")
    n = PER_FRAME + REPLAY
    # a stop of MULTI_HOLD frames across the per-frame/replay boundary: the
    # same pose and cloud again change (almost) nothing, so the gate takes
    # its y-sliced slab branches there; the moving frames scroll
    poses, steps = trajectory(cfg, n, hold=MULTI_HOLD)
    kind, data, kw = sensor_frames("cow_lady", cfg, poses, seeds=steps)
    finals, gates = {}, {}
    for name, mapper in (("mesh", VolumetricMapper(cfg, mesh=mesh)),
                         ("one", VolumetricMapper(cfg,
                                                  device=jax.devices()[0]))):
        r = Runner(mapper, kind, data, kw, poses)
        g = {r.frame(i).gate_level for i in range(PER_FRAME)}
        out = r.batch(PER_FRAME, n)
        g.update(int(v) for v in np.asarray(out.per_frame["gate_level"]))
        finals[name], gates[name] = state_arrays(mapper.state), sorted(g)
    # the phase-1 cache (p1c, p1c_ok) is single-device only: a mesh never
    # fills it, so it is not part of the map the two runs must share
    diff = [k for k in state_diff(finals["mesh"], finals["one"])
            if k not in ("p1c", "p1c_ok")]
    if diff:
        raise PhaseError(f"4-card and 1-card states differ in {diff}")
    full = len(_slab_menu(cfg.canvas_size, _menu_fracs(cfg)))
    if not any(0 <= g < full for g in gates["mesh"]):
        raise PhaseError(f"the mesh run took no slab branch of the gated "
                         f"EDT (levels {gates['mesh']}, full = {full})")
    return {"case": "cow_lady", "devices": n_dev, "frames": n,
            "gate_levels": gates["mesh"], "gate_levels_one": gates["one"],
            "full_level": full, "bit_identical": True}


# ===========================================================================

def _import_package():
    """Import the package from THIS checkout, or fail."""
    sys.path.insert(0, HERE)
    try:
        import gie_mapping_tpu
    except ImportError as e:
        raise PhaseError(f"package not importable from {HERE}: {e}")
    where = os.path.dirname(os.path.dirname(os.path.abspath(
        gie_mapping_tpu.__file__)))
    if where != HERE:
        raise PhaseError(f"package imported from {where}, not {HERE}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded path against one card")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated presets for phases 2-3")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        _import_package()
        import jax

        from gie_mapping_tpu.runtime.compile_cache import enable
        from gie_mapping_tpu.runtime.devinfo import gpu_name_power

        cache = enable()
        log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
            f"; compile cache {cache}")
        # ---- phase 1: device ---------------------------------------------
        devices = jax.devices()
        if devices[0].platform != "gpu":
            raise PhaseError(f"phase 1: JAX platform is "
                             f"{devices[0].platform!r}, not 'gpu'")
        log(f"gpu: {gpu_name_power()}")
        log(f"phase 1 device: ok {devices[0].device_kind} x{len(devices)}")
        if args.multi:
            log("multi: " + json.dumps(multi_card()))
        else:
            log("phase 5 kernels: none kept (ops/backend.py)")
            for case in args.cases.split(","):
                rec = run_case(case)
                log("phase 2-3 case: " + json.dumps(rec))
            for case in CPU_CASES:
                log("phase 4 card/cpu: " + json.dumps(card_vs_cpu(case)))
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
