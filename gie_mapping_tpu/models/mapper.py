"""VolumetricMapper: the engine orchestrator (imperative shell).

Counterpart of the reference's ROS node
(/root/reference/src/volumetric_mapper.cpp:6-224,
 include/volumetric_mapper.h:44-357): owns the global map state, dispatches
one of the four sensor pipelines per frame, runs the jitted merge, maintains
the CPU mirror of streamed blocks, the CSV profile log and the ground-truth
checker.  ROS pub/sub is replaced by plain function calls returning numpy
arrays (runtime/datasets.py provides replayers).
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..map_state import MapState, canvas_geometry
from ..ops import raycast as rc
from ..utils import geometry as geo
from ..utils.config import MapConfig, DEFAULT_FENCE_LL, DEFAULT_FENCE_UR
from ..utils.constants import EMPTY_VALUE, VB_WIDTH, VOX_UNKNOWN
from .pipeline import frame_step, merge_frame, scroll_frame_step, scroll_step


from ..map_state import shift_block_mask as _shift_block_mask


class FrameOutput:
    """Per-frame results (CostMap equivalent, msg/CostMap.msg:1-15).

    Device arrays are held lazily: nothing is copied device->host until a
    field is accessed.
    The mapping engine itself (dispatch side) never synchronises — matching
    the reference's async kernel stream, where only profiling inserts
    explicit syncs (volumetric_mapper.cpp:153,186).
    """

    _LAZY = ("edt", "glb_type", "dist_sq", "coc", "relax_iters", "fnt_count",
             "arch_dropped", "gate_level", "gate_slab_vox")

    def __init__(self, raw: dict, origin, pvt):
        self._raw = raw
        self.origin = origin
        self.pvt = pvt
        self.ogm_time_ms = 0.0
        self.edt_time_ms = 0.0
        self._cache: dict = {}

    def __getattr__(self, name):
        if name in FrameOutput._LAZY:
            cache = self.__dict__["_cache"]
            if name not in cache:
                v = np.asarray(self.__dict__["_raw"][name])
                if v.ndim == 0:
                    v = v.item()
                cache[name] = v
            return cache[name]
        raise AttributeError(name)

    @property
    def seen(self):
        return self.glb_type != VOX_UNKNOWN

    def device(self, name):
        """The un-fetched device array for a raw output field."""
        return self._raw[name]

    def fetch(self):
        """Materialise all lazy fields in one batched transfer."""
        vals = jax.device_get([self._raw[k] for k in FrameOutput._LAZY])
        for k, v in zip(FrameOutput._LAZY, vals):
            v = np.asarray(v)
            self._cache[k] = v.item() if v.ndim == 0 else v
        return self

    def cost_map(self):
        """SeenDist payload: (d, s, o) per voxel (local_batch.h:19-24,382-391)."""
        return {
            "d": self.edt,
            "o": self.glb_type,
            "s": self.seen,
            "origin": self.origin,
        }

    # 8-byte SeenDist record: float d + bool s + bool o + 2 pad bytes
    # (C struct layout of local_batch.h:19-24 — float aligns the struct to 4,
    # so sizeof(SeenDist) == 8; the field is literally named payload8)
    PAYLOAD8_DTYPE = np.dtype(
        [("d", "<f4"), ("s", "u1"), ("o", "u1"), ("_pad", "V2")])

    def cost_map_msg(self, voxel_width: float):
        """Byte-compatible CostMap message (msg/CostMap.msg:1-15) so a
        consumer of the reference's planner topic can parse our output
        unchanged.

        `payload8` reproduces the raw memcpy of SeenDist[volume]
        (volumetric_mapper.cpp:206-212, local_batch.h:386): records in the
        reference's linear order x-fastest (`coord2idx_local`,
        local_batch.h:168-170).  Faithful quirks of convertCostMap
        (local_batch.h:382-391): only `d` (EDT in GRID units — consumers
        scale by `width`) and `o` (the raw glb_type char coerced to bool,
        i.e. truthy = known) are written; `s` is never assigned by the
        reference and is 0 here.
        """
        d = np.asarray(self.edt, np.float32)
        X, Y, Z = d.shape
        rec = np.zeros((Z, Y, X), dtype=FrameOutput.PAYLOAD8_DTYPE)
        rec["d"] = d.transpose(2, 1, 0)
        rec["o"] = (self.glb_type.transpose(2, 1, 0) != 0).astype(np.uint8)
        origin = np.asarray(self.origin, np.float32)
        return {
            "x_size": X, "y_size": Y, "z_size": Z,
            "x_origin": float(origin[0]),
            "y_origin": float(origin[1]),
            "z_origin": float(origin[2]),
            "width": float(voxel_width),
            # carrot fields exist in the msg but setupEDTmsg4Motion never
            # sets them (volumetric_mapper.cpp:375-389)
            "x_carrot": 0.0, "y_carrot": 0.0, "z_carrot": 0.0,
            "type": 1,  # CostMap::TYPE_EDT
            "payload8": rec.tobytes(),
        }

    def local_occupied_cloud(self, voxel_width: float):
        """World positions of occupied window voxels
        (publish_local_ptcld_2_rviz equivalent, volumetric_mapper.h:181-243)."""
        from ..utils.constants import VOX_OCCUPIED

        idx = np.argwhere(self.glb_type == VOX_OCCUPIED)
        return (idx + self.pvt) * voxel_width

    def local_edt_cloud(self, voxel_width: float):
        """(world positions, distances in metres) of seen window voxels."""
        sel = self.seen
        idx = np.argwhere(sel)
        return (idx + self.pvt) * voxel_width, self.edt[sel] * voxel_width

    def debug_voxel(self, point_world, voxel_width: float):
        """Inspect the window voxel containing a world point — the dbg_pt
        debug-topic equivalent (volumetric_mapper.cpp:113-115).  Returns a
        dict (grid coords, type, dist_m, coc global coords) or None if the
        point is outside the window."""
        g = np.floor(np.asarray(point_world, np.float64) / voxel_width
                     + 0.5).astype(np.int64) - self.pvt
        if np.any(g < 0) or np.any(g >= np.asarray(self.edt.shape)):
            return None
        i, j, k = (int(v) for v in g)
        return {
            "loc": (i, j, k),
            "glb": tuple(int(v) for v in (g + self.pvt)),
            "type": int(self.glb_type[i, j, k]),
            "dist_m": float(self.edt[i, j, k]) * voxel_width,
            "dist_sq_grids": int(self.dist_sq[i, j, k]),
            "coc": tuple(int(v) for v in self.coc[i, j, k]),
        }

    def query_distance(self, points_world, voxel_width: float):
        """Trilinearly-interpolated obstacle distance + gradient at world
        points — the motion-planner consumer API.  The reference publishes
        the raw CostMap payload and leaves interpolation to the planner;
        here it is provided directly (host-side numpy, no reference
        counterpart).

        Args:
          points_world: [..., 3] float metres.
        Returns:
          (dist_m [...], grad [..., 3] unitless d(dist)/d(position),
           valid [...] bool — inside the window with all 8 corners seen).
        """
        pts = np.asarray(points_world, np.float64)
        shp = np.asarray(self.edt.shape)
        g = pts / voxel_width - self.pvt  # voxel centres sit on integers
        g0 = np.floor(g).astype(np.int64)
        inb = np.all((g >= 0) & (g <= shp - 1), axis=-1)
        g0c = np.clip(g0, 0, shp - 2)
        f = np.clip(g - g0c, 0.0, 1.0)

        edt = self.edt
        seen = self.seen
        c = np.empty(pts.shape[:-1] + (2, 2, 2))
        ok = np.ones(pts.shape[:-1], bool)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    ix, iy, iz = g0c[..., 0] + dx, g0c[..., 1] + dy, g0c[..., 2] + dz
                    c[..., dx, dy, dz] = edt[ix, iy, iz]
                    ok &= seen[ix, iy, iz]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        cz = c[..., 0] * (1 - fz[..., None, None]) + c[..., 1] * fz[..., None, None]
        cy = cz[..., 0] * (1 - fy[..., None]) + cz[..., 1] * fy[..., None]
        s = cy[..., 0] * (1 - fx) + cy[..., 1] * fx
        # analytic trilinear partials (dist is s * voxel_width, position is
        # g * voxel_width: the ratio is unitless)
        gx = cy[..., 1] - cy[..., 0]
        by = cz[..., 0, :] * (1 - fx[..., None]) + cz[..., 1, :] * fx[..., None]
        gy = by[..., 1] - by[..., 0]
        bz0 = c[..., 0, 0, :] * (1 - fy[..., None]) + c[..., 0, 1, :] * fy[..., None]
        bz1 = c[..., 1, 0, :] * (1 - fy[..., None]) + c[..., 1, 1, :] * fy[..., None]
        bz = bz0 * (1 - fx[..., None]) + bz1 * fx[..., None]
        gz = bz[..., 1] - bz[..., 0]
        grad = np.stack([gx, gy, gz], axis=-1)
        return s * voxel_width, grad, inb & ok


class CapacityWarning(UserWarning):
    """A capacity edge was hit: archive full (scrolled-out map data dropped),
    streaming backlog not draining, or the relaxation sweep cap reached.

    The reference fails loudly on every such edge (wave_helper.h:26-30,82-88;
    unify_helper.cuh:107-113,511-517; blockalloc.h:56-58).  This engine warns
    by default and raises a RuntimeError with cfg.capacity_strict."""


class _ExtObs:
    """Virtual fence / external-observer AABB set (Ext_Obs_Wrapper,
    include/map_structure/pre_map.h:12-29, src/kernel/pre_map/pre_map.cu)."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        M = cfg.max_ext_obs
        self.ll = np.zeros((M, 3), np.float32)
        self.ur = np.zeros((M, 3), np.float32)
        self.n = 0
        self.assign([DEFAULT_FENCE_LL], [DEFAULT_FENCE_UR])

    def assign(self, lls, urs):
        self.n = min(len(lls), self.cfg.max_ext_obs)
        for i in range(self.n):
            self.ll[i] = lls[i]
            self.ur[i] = urs[i]

    def append(self, ll, ur):
        if self.n < self.cfg.max_ext_obs:
            self.ll[self.n] = ll
            self.ur[self.n] = ur
            self.n += 1

    def activate(self, win_ll, win_ur):
        """AABB-vs-window activation (pre_map.cu:80-102).  Box 0 — the
        inverted flyable-region fence — is kept inactive exactly as the
        reference's activate_AABB does (pre_map.cu:85-86)."""
        act = np.zeros(self.cfg.max_ext_obs, bool)
        for i in range(1, self.n):
            overlap = np.all(self.ll[i] <= win_ur) and np.all(self.ur[i] >= win_ll)
            act[i] = overlap
        return act


class VolumetricMapper:
    """The mapping engine: feed poses + sensor frames, read cost maps."""

    def __init__(self, cfg: MapConfig, device=None, log_path: Optional[str] = None,
                 mesh=None):
        """mesh: optional jax.sharding.Mesh — shards the canvas along x and
        the archive over blocks across the mesh devices (parallel/mesh.py);
        every frame program then runs SPMD with XLA-inserted collectives,
        bit-identical to the single-device run (tests/test_multichip.py)."""
        from ..ops.backend import platform

        platform()  # refuse an unsupported platform before any work
        self.cfg = cfg
        self.device = device
        self.mesh = mesh
        if device is not None and mesh is not None:
            raise ValueError("device and mesh are mutually exclusive: a mesh "
                             "places state across its own devices")
        self.state = MapState.create(cfg)
        if mesh is not None:
            from ..parallel.mesh import shard_state

            self.state = shard_state(self.state, mesh)
        elif device is not None:
            self.state = jax.device_put(self.state, device)
        self.ext_obs = _ExtObs(cfg)
        self._origin = None  # host mirror of the canvas origin (scroll gate)
        self.map_ct = 0
        # batched-replay observability: frames absorbed by scan programs and
        # scrolls executed in-scan (vs per-frame fallbacks)
        self.replay_scanned_frames = 0
        self.replay_scanned_scrolls = 0
        self.mirror = None  # lazily-constructed runtime.host_mirror.HostMirror
        # capacity monitor (loud saturation, CapacityWarning): the per-frame
        # scalars ride an async D2H so the dispatch path never synchronises;
        # each frame ingests the PREVIOUS frame's values
        self._cap_pending = None
        self._cap_dropped_seen = 0
        self._stream_stall = 0
        self._stall_reported = False
        self._last_leftover = 0
        self._stream_rot = 0
        self.last_output: Optional[FrameOutput] = None
        self.logger = None
        if log_path is not None or cfg.profile_loc_rms or cfg.profile_glb_rms:
            from ..runtime.logger import CsvLogger

            self.logger = CsvLogger(log_path)
        self.gt_checker = None
        if cfg.profile_loc_rms or cfg.profile_glb_rms:
            from ..runtime.gt_checker import GroundTruthChecker

            self.gt_checker = GroundTruthChecker()

    def warmup(self, robot_pos=(0.0, 0.0, 0.0)):
        """Compile the merge program before the first real frame so frame 0
        doesn't pay compilation cost (reference warmupCuda,
        src/kernel/edt/warmup.cu:7-17, volumetric_mapper.cpp:126).

        Runs on a throwaway state (merge_frame donates its state buffers, so
        the live map must not be fed a discardable frame)."""
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(np.asarray(robot_pos, np.float32))
        throwaway = MapState.create(cfg)
        if self.mesh is not None:
            from ..parallel.mesh import shard_state

            throwaway = shard_state(throwaway, self.mesh)
        fence, fence_on = self._fence_args(pvt)
        throwaway = scroll_step(throwaway, jnp.asarray(origin_blk), cfg=cfg)
        _, out = merge_frame(
            throwaway, jnp.zeros(cfg.local_size, jnp.int8),
            jnp.zeros(cfg.local_size, jnp.int32),
            jnp.asarray(pvt), jnp.asarray(origin_blk), jnp.asarray(off),
            *fence, cfg=cfg, input_pointcloud=False, do_scroll=False,
            use_fence=fence_on, mesh=self.mesh,
        )
        np.asarray(out["relax_iters"])  # force completion
        return self

    # ------------------------------------------------------------------
    def _scroll_compact_rows(self, origin_blk, prev=None):
        """Static compacted-archive-IO size (rows) for this scroll, or None
        for the dense full-canvas path.

        Upper-bounds exiting/entering blocks as NB - prod(cb - |shift|):
        ordinary block crossings move thin slabs (~200-700 blocks of ~3.6k).
        Bucketed to a few sizes so the jit cache stays small; larger
        (teleport-scale) shifts take the dense path, and the replay planner
        breaks them out to the per-frame path so a scanned run's static
        bounds never inflate."""
        if prev is None:
            prev = (self._origin if self._origin is not None
                    else np.asarray(self.state.origin_blk))
        shift = np.abs(np.asarray(origin_blk) - prev)
        cb = np.asarray(self.cfg.canvas_blocks, np.int64)
        nb = int(cb.prod())
        bound = nb - int(np.maximum(cb - shift, 0).prod())
        return next((s for s in (256, 1024, 2048) if bound <= s <= nb), None)

    _SELF = object()  # sentinel: "use self._origin" (which may itself be None)

    def _frame_geometry(self, robot_pos, origin=_SELF, motion=_SELF):
        """Window pivot + canvas origin with scroll hysteresis: the canvas is
        slightly larger than window+halo, so the origin is kept while the
        window (plus its halo) still fits — halving scroll frequency.  When
        a scroll IS forced, placement is motion-biased (canvas_geometry:
        cfg.scroll_bias of the slack goes ahead of the travel direction).

        `origin` overrides the current canvas origin and `motion` the pivot
        delta (the batch planner walks hypothetical origins/pivots ahead of
        dispatch); by default both track the live per-frame state."""
        cfg = self.cfg
        if origin is VolumetricMapper._SELF:
            origin = self._origin
        pvt = geo.calculate_pivot(robot_pos, cfg.voxel_width, cfg.local_size)
        if motion is VolumetricMapper._SELF:
            last = getattr(self, "_last_pvt", None)
            motion = None if last is None else pvt - last
            self._last_pvt = pvt.copy()
        if origin is not None:
            off = pvt - origin * VB_WIDTH
            lo_ok = (off >= cfg.halo_grids).all()
            hi_ok = (off + np.asarray(cfg.local_size) + cfg.halo_grids
                     <= np.asarray(cfg.canvas_size)).all()
            if lo_ok and hi_ok:
                return pvt, origin.copy(), off.astype(np.int32)
        origin_blk, origin_vox, off = canvas_geometry(cfg, pvt, motion)
        return pvt, origin_blk, off

    def _fence_args(self, pvt):
        cfg = self.cfg
        win_ll = pvt.astype(np.float32) * cfg.voxel_width
        win_ur = win_ll + np.asarray(cfg.local_size_m, np.float32)
        act = self.ext_obs.activate(win_ll, win_ur)
        # cache the device arrays: the box set changes rarely, and four small
        # uploads per frame each cost an enqueue
        key = (self.ext_obs.ll.tobytes(), self.ext_obs.ur.tobytes(),
               act.tobytes(), self.ext_obs.n)
        cached = getattr(self, "_fence_cache", None)
        if cached is None or cached[0] != key:
            args = (
                jnp.asarray(self.ext_obs.ll),
                jnp.asarray(self.ext_obs.ur),
                jnp.asarray(act),
                jnp.int32(self.ext_obs.n),
            )
            self._fence_cache = cached = (key, args)
        return cached[1], bool(act.any())

    # ------------------------------------------------------------------
    def _run(self, inst_type, ray_count, pvt, origin_blk, off, *, input_pointcloud,
             t_sensor0, raycast_inputs=None, sensor=None):
        cfg = self.cfg
        fence, fence_on = self._fence_args(pvt)
        # pack the per-frame scalars into ONE H2D transfer: each small upload
        # is a separate enqueue.  f32 [9,3]: integer pvt/origin/off
        # rows (exact in f32), sensor rotation rows + origin, then two rows
        # of per-sensor scalars (bin geometry / camera intrinsics).
        pose_h = np.zeros((9, 3), np.float32)
        pose_h[0], pose_h[1], pose_h[2] = pvt, origin_blk, off
        if raycast_inputs is not None:
            pts, vmask, rot3, origin3 = raycast_inputs
            pose_h[3:6] = np.asarray(rot3, np.float32)
            pose_h[6] = np.asarray(origin3, np.float32)
            extra = {"points": pts, "pts_valid": vmask, "fuse_raycast": True}
        elif sensor is not None:
            # projection sensor fused into the frame program (one dispatch)
            kind, data, scalars, proj = sensor
            pose_h[3:6] = np.asarray(proj.rot, np.float32)
            pose_h[6] = np.asarray(proj.trans, np.float32)
            pose_h[7:9] = scalars
            extra = {"sensor_data": data, "sensor_kind": kind}
        else:
            extra = {"inst_type": jnp.asarray(inst_type),
                     "ray_count": jnp.asarray(ray_count)}
        pose = jnp.asarray(pose_h)
        t_ogm = time.perf_counter()

        # host-gated scroll: only block-crossing frames pay it, and they run
        # the scroll fused into the frame program (one dispatch, not two)
        if self._origin is None or not np.array_equal(self._origin, origin_blk):
            rows = self._scroll_compact_rows(origin_blk)
            if getattr(self, "_stream_carry", None) is not None:
                # un-served streamed blocks are indexed in canvas coords:
                # shift the carry mask with the canvas (exposed region: False)
                shift = (np.asarray(origin_blk)
                         - (self._origin if self._origin is not None
                            else np.asarray(self.state.origin_blk)))
                self._stream_carry = _shift_block_mask(
                    self._stream_carry, jnp.asarray(shift, jnp.int32))
            self._origin = np.asarray(origin_blk).copy()
            self.state, out = scroll_frame_step(
                self.state, pose, *fence, cfg=cfg,
                input_pointcloud=input_pointcloud, use_fence=fence_on,
                compact_rows=rows, mesh=self.mesh, **extra,
            )
        else:
            self.state, out = frame_step(
                self.state, pose, *fence, cfg=cfg,
                input_pointcloud=input_pointcloud, use_fence=fence_on,
                mesh=self.mesh, **extra,
            )
        t_end = time.perf_counter()

        self.map_ct += 1
        result = FrameOutput(
            out,
            origin=pvt.astype(np.float32) * cfg.voxel_width,
            pvt=pvt,
        )
        result.ogm_time_ms = (t_ogm - t_sensor0) * 1e3
        result.edt_time_ms = (t_end - t_ogm) * 1e3
        self.last_output = result

        if (cfg.display_glb_edt or cfg.display_glb_ogm) and (
            self.map_ct % cfg.vis_interval == 0
        ):
            self._stream(out, origin_blk)
        self._queue_capacity_guard(out["arch_dropped"], out["relax_iters"])

        # profiling path (reference: visualize() pauses the bag, checks RMSE
        # and logs CSV, volumetric_mapper.h:320-356): profile_loc_rms checks
        # the window EDT; profile_glb_rms checks the streamed global mirror
        # (the publish_glb_2_rviz consumer view) — distinct routes
        if self.gt_checker is not None and self.map_ct % cfg.vis_interval == 0:
            if cfg.profile_loc_rms:
                self.gt_checker.check_frame(result, cfg.voxel_width,
                                            self.logger)
            if cfg.profile_glb_rms and self.mirror is not None:
                self.flush_stream()  # ingest in-flight rows first
                self.gt_checker.check_global(self.mirror, cfg.voxel_width,
                                             self.logger)
        if self.logger is not None:
            self.logger.log_frame(result.ogm_time_ms, result.edt_time_ms,
                                  self.logger.take_pending_rmse(),
                                  self._cap_dropped_seen, self._last_leftover)
        return result

    # -- capacity monitor ------------------------------------------------
    def _alert(self, msg: str):
        if self.cfg.capacity_strict:
            raise RuntimeError(msg)
        if self.cfg.capacity_warn:
            warnings.warn(msg, CapacityWarning, stacklevel=3)

    def check_capacity(self):
        """Ingest the previous frame's capacity scalars and report saturation
        (the loud counterpart of the reference's device asserts,
        wave_helper.h:82-88).  Called automatically at the next frame; call
        directly (after the final frame) to drain the last pending check."""
        p, self._cap_pending = self._cap_pending, None
        if p is None:
            return
        dropped = int(np.asarray(p["arch_dropped"]))
        if dropped > self._cap_dropped_seen:
            n = dropped - self._cap_dropped_seen
            self._cap_dropped_seen = dropped
            self._alert(
                f"archive capacity exhausted: {n} scrolled-out block(s) "
                f"dropped this frame ({dropped} total) — map data is being "
                f"lost; increase cfg.max_blocks (currently "
                f"{self.cfg.max_blocks})")
        if "relax_iters" in p:
            ri = int(np.asarray(p["relax_iters"]))
            if ri >= self.cfg.relax_iters:
                self._alert(
                    f"relaxation hit its sweep cap ({ri} >= "
                    f"{self.cfg.relax_iters}): the wavefront fixed point may "
                    f"not have converged; raise cfg.max_relax_iters")

    def _queue_capacity_guard(self, arch_dropped, relax_iters=None):
        self.check_capacity()
        scalars = {"arch_dropped": arch_dropped}
        if relax_iters is not None and self.cfg.merge_mode == "relax":
            scalars["relax_iters"] = relax_iters
        for a in scalars.values():
            try:
                a.copy_to_host_async()
            except Exception:
                pass
        self._cap_pending = scalars

    def capacity_report(self) -> dict:
        """Current saturation counters (host view)."""
        return {
            "arch_dropped": self._cap_dropped_seen,
            "n_arch": int(np.asarray(self.state.n_arch)),
            "stream_leftover": self._last_leftover,
            "stream_stall_ticks": self._stream_stall,
        }

    # -- auxiliary channels --------------------------------------------
    def process_ext_cloud(self, points, premap_ll=None, premap_ur=None):
        """External-observer pointcloud -> DBSCAN clusters -> fence boxes
        (CB_ext_cld/clustring, volumetric_mapper.cpp:391-497): the box set is
        reset to the prior map, then one AABB per cluster is appended."""
        from ..runtime.clustering import cloud_to_fence_boxes

        if premap_ll is None:
            premap_ll, premap_ur = [DEFAULT_FENCE_LL], [DEFAULT_FENCE_UR]
        self.ext_obs.assign(premap_ll, premap_ur)
        for ll, ur in cloud_to_fence_boxes(points, self.cfg.is_ext_obsv_3D):
            self.ext_obs.append(ll, ur)
        return self.ext_obs.n

    def process_multiscan_cloud(self, proj: geo.Projection, points, ring_idx,
                                ring_num=16, scan_num=360,
                                phi_min=-0.2617994, phi_inc=0.0349066):
        """3-D spinning-LiDAR frame from a raw (points, ring) cloud: converts
        to range rings host-side (vlp16_map_maker.cpp:73-148; native C++ when
        built) then runs the spherical-projection model."""
        from ..runtime.rings import cloud_to_rings

        rings_img, tmin, tinc = cloud_to_rings(points, ring_idx, ring_num, scan_num)
        return self.process_multiscan(proj, rings_img, tmin, tinc, phi_min, phi_inc)

    # -- persistence (no reference counterpart: the reference never
    #    persists its map, SURVEY.md §5 'Checkpoint/resume: none') ------
    def save(self, path: str):
        import numpy as np

        state_np = {f"state/{k}": np.asarray(getattr(self.state, k))
                    for k in ("origin_blk", "occ_val", "vox_type", "dist_sq",
                              "coc", "present", "arch_keys", "n_arch",
                              "a_packed", "arch_dropped")}
        state_np["meta/map_ct"] = np.asarray(self.map_ct)
        state_np["meta/version"] = np.asarray(3)  # v3: relative coc anchors
        np.savez_compressed(path, **state_np)

    def load(self, path: str):
        import dataclasses as dc

        import numpy as np

        raw = np.load(path)
        version = int(raw["meta/version"]) if "meta/version" in raw.files else 1
        if version != 3:
            raise ValueError(
                f"checkpoint format v{version} not supported (current: v3 — canvas/block-relative coc anchors)"
            )
        kw = {k.split("/", 1)[1]: jnp.asarray(raw[k]) for k in raw.files
              if k.startswith("state/")}
        if kw["a_packed"].ndim == 3:  # v3 checkpoints written before the
            # flat-row archive layout (round 5) stored [B,512,3]
            kw["a_packed"] = kw["a_packed"].reshape(
                kw["a_packed"].shape[0], -1)
        # the per-cell dist bound and phase-1 cache are not serialized
        # (format stays v3): reset both conservatively — the gate's first
        # frame self-heals (full branch / full phase-1 rescan)
        kw["dmax_cell"] = jnp.full(
            tuple(c // 4 for c in self.cfg.canvas_size), EMPTY_VALUE,
            jnp.int32)
        kw["p1c_ok"] = jnp.zeros((), jnp.bool_)
        self.state = dc.replace(self.state, **kw)
        if self.mesh is not None:
            from ..parallel.mesh import shard_state

            self.state = shard_state(self.state, self.mesh)
        self.map_ct = int(raw["meta/map_ct"])
        self._origin = None  # force a scroll-sync on the next frame
        return self

    def _stream(self, out, origin_blk):
        """Changed-block device->host streaming into the CPU mirror
        (streamPipeline, glb_hash_map.cu:209-247).

        Two-phase async: this tick DISPATCHES the on-device compaction
        (map_state.stream_extract) and starts the host copy; the rows are
        ingested on the NEXT tick (or flush_stream), so the D2H rides under
        subsequent frame dispatches — the reference's separate-stream
        streamD2H, without ever stalling the compute queue.  Columns beyond
        the per-tick cap carry over in a device-resident leftover mask."""
        from ..map_state import stream_extract

        if self.mirror is None:
            from ..runtime.host_mirror import HostMirror

            self.mirror = HostMirror(self.cfg)
        self.flush_stream()
        cb = self.cfg.canvas_blocks
        if getattr(self, "_stream_carry", None) is None:
            self._stream_carry = jnp.zeros(tuple(cb), jnp.bool_)
        k_cols = self.cfg.stream_k_cols or min(cb[0] * cb[1], 64)
        k_cols = min(k_cols, cb[0] * cb[1])
        ids, valid, rows, blk_mask, leftover = stream_extract(
            self.state, out["changed_blk"], self._stream_carry,
            jnp.int32(self._stream_rot), cfg=self.cfg, k_cols=k_cols,
        )
        # round-robin service offset: bounded staleness when more columns
        # change per tick than k_cols can serve
        self._stream_rot = (self._stream_rot + k_cols) % (cb[0] * cb[1])
        self._stream_carry = leftover
        self._stream_k_cols = k_cols
        lo_cnt = jnp.sum(jnp.any(leftover, axis=2).astype(jnp.int32))
        for a in (ids, valid, rows, blk_mask, lo_cnt):
            try:
                a.copy_to_host_async()
            except Exception:
                pass
        self._stream_pending = (ids, valid, rows, blk_mask,
                                np.asarray(origin_blk).copy(), lo_cnt)

    def flush_stream(self):
        """Ingest any in-flight streamed rows into the host mirror."""
        p = getattr(self, "_stream_pending", None)
        if p is None:
            return 0
        self._stream_pending = None
        ids, valid, rows, blk_mask, origin_blk, lo_cnt = p
        n = self.mirror.ingest_rows(
            np.asarray(ids), np.asarray(valid), np.asarray(rows),
            np.asarray(blk_mask), origin_blk,
        )
        # streaming-backlog stall detection (reference analogue: the
        # stream-capacity asserts, unify_helper.cuh:107-113,511-517).  With
        # round-robin service a bounded backlog only delays the mirror by
        # ceil(ncols/k_cols) ticks; the loud condition is a backlog the
        # rotation cannot even cycle through within stream_stall_ticks —
        # persistent for that many consecutive ticks.
        self._last_leftover = int(np.asarray(lo_cnt))
        k = getattr(self, "_stream_k_cols", 64)
        if self._last_leftover > self.cfg.stream_stall_ticks * k:
            self._stream_stall += 1
            if (self._stream_stall >= self.cfg.stream_stall_ticks
                    and not self._stall_reported):
                self._stall_reported = True
                self._alert(
                    f"streaming backlog: {self._last_leftover} changed "
                    f"block-column(s) undrained for {self._stream_stall} "
                    f"consecutive ticks (service rate {k} cols/tick) — the "
                    f"host mirror is falling behind; raise "
                    f"cfg.stream_k_cols or lower cfg.vis_interval")
        else:
            self._stream_stall = 0
            self._stall_reported = False
        return n

    def _sensor_proj(self, proj: geo.Projection) -> geo.Projection:
        """ugv_height override: ground vehicles clamp the sensor origin's z
        (volumetric_mapper.cpp:148-151) before the pivot computation."""
        if self.cfg.ugv_height > 0:
            t = np.asarray(proj.trans, np.float32).copy()
            t[2] = self.cfg.ugv_height
            return geo.Projection(proj.rot, t)
        return proj

    # -- the four map makers -------------------------------------------
    def process_scan2d(self, proj: geo.Projection, ranges, theta_min, theta_inc):
        """2-D LiDAR frame (HokuyoMapMaker, src/hokuyo_map_maker.cpp)."""
        t0 = time.perf_counter()
        proj = self._sensor_proj(proj)
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(np.asarray(proj.trans))
        scalars = np.zeros((2, 3), np.float32)
        scalars[0, 0], scalars[0, 1] = theta_min, theta_inc
        return self._run(None, None, pvt, origin_blk, off,
                         input_pointcloud=False, t_sensor0=t0,
                         sensor=("scan", jnp.asarray(ranges, jnp.float32),
                                 scalars, proj))

    def process_depth(self, proj: geo.Projection, depth, fx, fy, cx, cy):
        """Depth-camera frame (RealsenseMapMaker, src/realsense_map_maker.cpp)."""
        t0 = time.perf_counter()
        proj = self._sensor_proj(proj)
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(np.asarray(proj.trans))
        scalars = np.zeros((2, 3), np.float32)
        scalars[0] = (fx, fy, cx)
        scalars[1, 0] = cy
        return self._run(None, None, pvt, origin_blk, off,
                         input_pointcloud=False, t_sensor0=t0,
                         sensor=("depth", jnp.asarray(depth, jnp.float32),
                                 scalars, proj))

    def process_multiscan(self, proj: geo.Projection, rings, theta_min, theta_inc,
                          phi_min, phi_inc):
        """3-D spinning-LiDAR frame (Vlp16MapMaker, src/vlp16_map_maker.cpp)."""
        t0 = time.perf_counter()
        proj = self._sensor_proj(proj)
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(np.asarray(proj.trans))
        scalars = np.zeros((2, 3), np.float32)
        scalars[0] = (theta_min, theta_inc, phi_min)
        scalars[1, 0] = phi_inc
        return self._run(None, None, pvt, origin_blk, off,
                         input_pointcloud=False, t_sensor0=t0,
                         sensor=("multiscan", jnp.asarray(rings, jnp.float32),
                                 scalars, proj))

    @staticmethod
    def _pc_bucket(n, cap):
        """Smallest power-of-2 staging capacity covering n live points
        (>=4096, <=cap).  The panorama build's scatters cost per PADDED
        index, while the reference pays per actual point
        (pntcld_map_maker.cpp:49-61).
        Power-of-2 buckets bound both the padded waste (<2x live) and the
        compile count (one program per bucket, persistent-cached)."""
        b = 4096
        while b < n:
            b *= 2
        return min(b, cap)

    def stage_pointcloud(self, points_sensor, pad_to=None):
        """Pre-upload a point cloud to the device (padded to the live-point
        bucket, or `pad_to` when given).  Returns (points_dev, valid_dev)
        accepted by process_pointcloud — lets callers pipeline sensor DMA
        ahead of the frame loop."""
        cfg = self.cfg
        pts = np.asarray(points_sensor, np.float32)
        n = min(len(pts), cfg.max_raycast_points)
        cap = pad_to or self._pc_bucket(n, cfg.max_raycast_points)
        buf = np.zeros((cap, 3), np.float32)
        buf[:n] = pts[:n]
        vmask = np.zeros(cap, bool)
        vmask[:n] = True
        return jnp.asarray(buf), jnp.asarray(vmask)

    def process_pointcloud(self, proj: geo.Projection, points_sensor, valid=None):
        """Point-cloud frame (PntcldMapMaker, src/pntcld_map_maker.cpp).

        points_sensor: [N,3] float32 in SENSOR frame (transformed to world
        here, mirroring pntcld_raycast.cu:77,93).  Padded to the live-point
        power-of-2 bucket (capped at cfg.max_raycast_points — see
        _pc_bucket; the scatter cost is per padded index).
        """
        t0 = time.perf_counter()
        proj = self._sensor_proj(proj)
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(np.asarray(proj.trans))
        if (isinstance(points_sensor, jax.Array)
                and points_sensor.ndim == 2 and points_sensor.shape[1] == 3
                and valid is not None):
            # pre-staged device buffers (see stage_pointcloud): no host pass
            buf, vmask = points_sensor, valid
        else:
            pts = np.asarray(points_sensor, np.float32)
            n = min(len(pts), cfg.max_raycast_points)
            cap = self._pc_bucket(n, cfg.max_raycast_points)
            buf = np.zeros((cap, 3), np.float32)
            buf[:n] = pts[:n]
            vmask = np.zeros(cap, bool)
            vmask[:n] = True if valid is None else np.asarray(valid, bool)[:n]

        if cfg.raycast_mode == "projective" and cfg.fuse_raycast:
            # single-program frame: the sensor->world transform runs inside
            # frame_step (the rotation rides the packed pose upload), so a
            # frame costs two small uploads + one dispatch
            return self._run(None, None, pvt, origin_blk, off,
                             input_pointcloud=True, t_sensor0=t0,
                             raycast_inputs=(jnp.asarray(buf), jnp.asarray(vmask),
                                             proj.rot, proj.trans))
        world = proj.l2g(jnp.asarray(buf))
        kw = {}
        if cfg.raycast_mode == "dda":
            kernel = rc.pointcloud_raycast
        else:
            kernel = rc.pointcloud_project
            kw["n_theta"], kw["n_phi"] = rc.panorama_bins(cfg.local_size)
        inst, counts = kernel(
            world, jnp.asarray(vmask), proj.trans, jnp.asarray(pvt),
            local_size=cfg.local_size, voxel_width=cfg.voxel_width,
            ogm_min_h=cfg.ogm_min_h, ogm_max_h=cfg.ogm_max_h,
            for_motion_planner=cfg.for_motion_planner,
            robot_r2_grids=cfg.robot_r2_grids, **kw,
        )
        return self._run(inst, counts, pvt, origin_blk, off,
                         input_pointcloud=True, t_sensor0=t0)

    # -- batched replay (throughput mode) --------------------------------
    # in-scan scrolls use a static compacted-archive bound chosen PER
    # PLANNED RUN from the actual scrolls; only scrolls no bucket covers
    # (true teleports) break the plan.  The minimum bucket also gates
    # whether compaction pays at all on small canvases.
    REPLAY_ROWS = 256  # minimum bucket

    def stage_pointcloud_batch(self, clouds, pad_to=None):
        """Pre-upload K point clouds as stacked device buffers
        ([K,N,3] float32, [K,N] bool) for process_pointcloud_batch.
        N = the batch's live-point bucket (one bucket per batch so the
        replay scan compiles once), or `pad_to` when given."""
        cfg = self.cfg
        K = len(clouds)
        sizes = [min(len(np.asarray(p)), cfg.max_raycast_points)
                 for p in clouds]
        cap = pad_to or self._pc_bucket(max(sizes, default=0),
                                        cfg.max_raycast_points)
        buf = np.zeros((K, cap, 3), np.float32)
        vmask = np.zeros((K, cap), bool)
        for i, pts in enumerate(clouds):
            pts = np.asarray(pts, np.float32)
            n = sizes[i]
            buf[i, :n] = pts[:n]
            vmask[i, :n] = True
        return jnp.asarray(buf), jnp.asarray(vmask)

    def process_pointcloud_batch(self, projs, points, valids, chunk: int = 10):
        """Offline/replay throughput mode: K point-cloud frames dispatched as
        `lax.scan` chunks of `chunk` frames — ONE program per chunk instead of
        one per frame (pipeline.replay_frames), so per-frame cost approaches
        pure device time.  This is the counterpart of the reference's own
        evaluation mode (rosbag replay, README.md:102-145), where poses are
        known ahead of dispatch.

        State evolution is bit-identical to calling process_pointcloud per
        frame (tests/test_replay_batch.py).  Chunk tails and post-teleport
        segments dispatch as SHORTER scan programs (ladder
        {chunk, chunk/2, chunk/4, 5, 2}); only
        frames a scan cannot absorb at all (fresh map, teleport-scale
        scrolls, fence flips) fall back to the per-frame path.
        Streaming/visualisation runs at chunk cadence over the union of
        changed blocks; the ground-truth checker needs per-frame host data
        and is skipped (use the per-frame API when profiling RMSE).

        Args:
          projs:  K Projections (sensor pose per frame).
          points: [K,N,3] float32 sensor-frame clouds (device or host;
                  see stage_pointcloud_batch), N = cfg.max_raycast_points.
          valids: [K,N] bool.
          chunk:  frames per scan program (each distinct value compiles once).

        Returns the final frame's FrameOutput; `.per_frame` carries stacked
        [chunk] scalars (relax_iters, fnt_count, arch_dropped) of its chunk.
        """
        cfg = self.cfg
        if not (cfg.raycast_mode == "projective" and cfg.fuse_raycast):
            raise ValueError(
                "process_pointcloud_batch requires raycast_mode='projective' "
                "and fuse_raycast (the in-scan sensor path)")
        return self._process_batch(
            projs, chunk=chunk, input_pointcloud=True, sensor_kind=None,
            data={"points": points, "pts_valid": valids}, scalars=None,
            fallback=lambda i: self.process_pointcloud(
                projs[i], points[i], valids[i]))

    def process_scan2d_batch(self, projs, ranges, theta_min, theta_inc,
                             chunk: int = 10):
        """Batched 2-D LiDAR replay (see process_pointcloud_batch).  `ranges`
        is [K, n_beams] (device or host); theta_min/theta_inc are scalars or
        [K] arrays."""
        K = len(projs)
        sc = self._sensor_scalars(K, [np.broadcast_to(theta_min, K),
                                      np.broadcast_to(theta_inc, K)])
        data = jnp.asarray(ranges, jnp.float32)
        return self._process_batch(
            projs, chunk=chunk, input_pointcloud=False, sensor_kind="scan",
            data={"sensor_data": data}, scalars=sc,
            fallback=lambda i: self.process_scan2d(
                projs[i], data[i], float(sc[i, 0, 0]), float(sc[i, 0, 1])))

    def process_depth_batch(self, projs, depths, fx, fy, cx, cy,
                            chunk: int = 10):
        """Batched depth-camera replay.  `depths` is [K, H, W]; intrinsics
        are scalars or [K] arrays."""
        K = len(projs)
        sc = self._sensor_scalars(
            K, [np.broadcast_to(fx, K), np.broadcast_to(fy, K),
                np.broadcast_to(cx, K)], [np.broadcast_to(cy, K)])
        data = jnp.asarray(depths, jnp.float32)
        return self._process_batch(
            projs, chunk=chunk, input_pointcloud=False, sensor_kind="depth",
            data={"sensor_data": data}, scalars=sc,
            fallback=lambda i: self.process_depth(
                projs[i], data[i], float(sc[i, 0, 0]), float(sc[i, 0, 1]),
                float(sc[i, 0, 2]), float(sc[i, 1, 0])))

    def process_multiscan_batch(self, projs, rings, theta_min, theta_inc,
                                phi_min, phi_inc, chunk: int = 10):
        """Batched 3-D spinning-LiDAR replay.  `rings` is
        [K, ring_num, scan_num]; bin geometry scalars or [K] arrays."""
        K = len(projs)
        sc = self._sensor_scalars(
            K, [np.broadcast_to(theta_min, K), np.broadcast_to(theta_inc, K),
                np.broadcast_to(phi_min, K)], [np.broadcast_to(phi_inc, K)])
        data = jnp.asarray(rings, jnp.float32)
        return self._process_batch(
            projs, chunk=chunk, input_pointcloud=False,
            sensor_kind="multiscan", data={"sensor_data": data}, scalars=sc,
            fallback=lambda i: self.process_multiscan(
                projs[i], data[i], float(sc[i, 0, 0]), float(sc[i, 0, 1]),
                float(sc[i, 0, 2]), float(sc[i, 1, 0])))

    @staticmethod
    def _sensor_scalars(K, row0, row1=()):
        """[K,2,3] per-frame sensor scalar block (pose rows 7-8)."""
        sc = np.zeros((K, 2, 3), np.float32)
        for c, v in enumerate(row0):
            sc[:, 0, c] = v
        for c, v in enumerate(row1):
            sc[:, 1, c] = v
        return sc

    def _process_batch(self, projs, *, chunk, input_pointcloud, sensor_kind,
                       data, scalars, fallback):
        """Shared scanned-replay driver for all four sensor pipelines:
        plans chunk runs (scroll decisions + compact bounds), dispatches
        pipeline.replay_frames per run, falls back to `fallback(i)` for
        frames a scan cannot absorb (first frame, teleports, tails)."""
        from .pipeline import replay_frames

        cfg = self.cfg
        projs = [self._sensor_proj(p) for p in projs]
        K = len(projs)
        cb = np.asarray(cfg.canvas_blocks, np.int64)
        # small canvases can't fill the compacted buckets: the full-canvas
        # scroll path (also fully traced) handles ANY in-scan shift there
        use_compact = int(cb.prod()) >= self.REPLAY_ROWS
        result = None
        i = 0

        def _fence_key(pvt):
            # fence-box activation is window-position dependent
            # (_fence_args); a scanned chunk holds it constant, so chunks
            # must break where the per-frame path would see it change
            win_ll = pvt.astype(np.float32) * cfg.voxel_width
            win_ur = win_ll + np.asarray(cfg.local_size_m, np.float32)
            return self.ext_obs.activate(win_ll, win_ur).tobytes()

        while i < K:
            # plan a run of `chunk` frames whose scrolls fit the bounds
            prev = None if self._origin is None else self._origin.copy()
            prev_pvt = getattr(self, "_last_pvt", None)
            plan = []
            plan_rows = []  # per-frame rows so truncation can re-max
            fkey0 = None
            j = i
            while j < K and len(plan) < chunk:
                pvt, origin_blk, off = self._frame_geometry(
                    np.asarray(projs[j].trans), origin=prev,
                    motion=(None if prev_pvt is None else
                            geo.calculate_pivot(np.asarray(projs[j].trans),
                                                self.cfg.voxel_width,
                                                self.cfg.local_size)
                            - prev_pvt))
                prev_pvt = pvt.copy()
                scroll = prev is None or not np.array_equal(prev, origin_blk)
                rows = 0
                if scroll:
                    if prev is None:
                        break  # fresh map: per-frame path compiles the scroll
                    if use_compact:
                        rows = self._scroll_compact_rows(origin_blk, prev=prev)
                        if rows is None or rows >= int(cb.prod()):
                            break  # teleport-scale: per-frame dispatch (a
                            # scanned run's static bounds must not inflate)
                fkey = _fence_key(pvt)
                if fkey0 is None:
                    fkey0 = fkey
                elif fkey != fkey0:
                    break  # fence activation flips mid-chunk
                plan.append((pvt, origin_blk, off, scroll, j))
                plan_rows.append(rows)
                if scroll:
                    prev = origin_blk.copy()
                j += 1
            # dispatch the largest LADDER length the plan covers: tails and
            # post-teleport segments run as SHORTER scan programs instead of
            # per-frame fallbacks.  compact_rows is also a static jit arg; a
            # session-sticky HIGH-WATER mark (below) makes it monotone, so
            # the compile count is bounded by the scan lengths x the (at
            # most 2) bucket increases a session can see.  The short rungs
            # (5, 2) matter around teleports: a jump breaks the plan, and
            # the leftover segment runs as a few programs instead of
            # per-frame fallbacks.
            ladder = sorted({chunk, max(chunk // 2, 2), max(chunk // 4, 2),
                             5, 2}, reverse=True)
            ladder = [L for L in ladder if L <= max(chunk, 2)]
            run_len = next((L for L in ladder if len(plan) >= L), 0)
            if run_len == 0:
                # plan too short for any scan program (jump / fence flip /
                # fresh map): per-frame path for one frame, then re-plan
                result = fallback(i)
                i += 1
                continue
            plan = plan[:run_len]
            # re-max rows over the frames actually KEPT (truncated frames
            # must not oversize the compile), then apply the sticky
            # high-water mark (a larger compacted scroll is always correct —
            # it is capacity, not semantics)
            run_rows = max([self.REPLAY_ROWS] + plan_rows[:run_len])
            if use_compact:
                self._replay_rows_hw = max(
                    getattr(self, "_replay_rows_hw", 0), run_rows)
                cr = self._replay_rows_hw
            else:
                cr = None

            t0 = time.perf_counter()
            n = len(plan)
            pose_h = np.zeros((n, 9, 3), np.float32)
            scrolled = np.zeros(n, bool)
            for k, (pvt, origin_blk, off, scr, idx) in enumerate(plan):
                pose_h[k, 0], pose_h[k, 1], pose_h[k, 2] = pvt, origin_blk, off
                pose_h[k, 3:6] = np.asarray(projs[idx].rot, np.float32)
                pose_h[k, 6] = np.asarray(projs[idx].trans, np.float32)
                if scalars is not None:
                    pose_h[k, 7:9] = scalars[idx]
                scrolled[k] = scr
            fence, fence_on = self._fence_args(plan[0][0])
            start_origin = (self._origin if self._origin is not None
                            else np.asarray(self.state.origin_blk))
            if sensor_kind is None:
                extra = {"points": data["points"][i:i + n],
                         "pts_valid": data["pts_valid"][i:i + n],
                         "fuse_raycast": True}
            else:
                extra = {"sensor_data": data["sensor_data"][i:i + n],
                         "sensor_kind": sensor_kind}
            # scroll-free runs compile the scan body WITHOUT the scroll
            # cond (its identity branch copies every carried canvas buffer
            # per frame) and with stable compact statics (no archive IO)
            has_scrolls = bool(scrolled.any())
            if not has_scrolls:
                cr = None
            self.state, out, changed_union, per_frame = replay_frames(
                self.state, jnp.asarray(pose_h), jnp.asarray(scrolled), *fence,
                cfg=cfg, input_pointcloud=input_pointcloud, use_fence=fence_on,
                compact_rows=cr, mesh=self.mesh,
                has_scrolls=has_scrolls, **extra)
            last = plan[-1]
            self._origin = np.asarray(last[1]).copy()
            self._last_pvt = np.asarray(last[0]).copy()  # motion-bias anchor
            self.map_ct += n
            self.replay_scanned_frames += n
            self.replay_scanned_scrolls += int(scrolled.sum())
            result = FrameOutput(
                out, origin=last[0].astype(np.float32) * cfg.voxel_width,
                pvt=last[0])
            result.per_frame = per_frame
            dt = (time.perf_counter() - t0) * 1e3 / n
            result.edt_time_ms = dt  # amortised dispatch-side time
            self.last_output = result
            if cfg.display_glb_edt or cfg.display_glb_ogm:
                if getattr(self, "_stream_carry", None) is not None:
                    net = jnp.asarray(self._origin - start_origin, jnp.int32)
                    self._stream_carry = _shift_block_mask(self._stream_carry,
                                                           net)
                self._stream({"changed_blk": changed_union}, self._origin)
            # arch_dropped is cumulative (last frame covers the chunk); the
            # relax cap check uses the chunk's worst frame
            self._queue_capacity_guard(
                per_frame["arch_dropped"][-1],
                jnp.max(per_frame["relax_iters"]))
            if self.logger is not None:
                for _ in range(n):
                    self.logger.log_frame(0.0, dt,
                                          self.logger.take_pending_rmse(),
                                          self._cap_dropped_seen,
                                          self._last_leftover)
            i += n
        return result
