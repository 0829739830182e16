"""Configuration system.

Counterpart of the reference's ROS-param `Parameters` struct
(/root/reference/include/parameters.h:11-139) plus the five benchmark case
presets shipped as cfg/*.yaml + launch files (see /root/repo/BASELINE.md).

A `MapConfig` is frozen/hashable so it can be a `static_argnum` of jitted
update steps; every derived grid quantity is computed once here so the traced
code sees only static Python ints.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from .constants import VB_WIDTH


def _grids_sq(dist_m: float, voxel_width: float) -> int:
    """metres -> squared grid count (reference flt2GridsSq, parameters.h:134-138)."""
    g = int(math.ceil(dist_m / voxel_width))
    return g * g


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


# Dense-canvas propagation bound (voxels).  Beyond this halo the per-frame
# dense sweep cost dominates; cutoffs above it are narrowed (loudly — see
# CutoffNarrowedWarning) to the resident canvas.
MAX_HALO_GRIDS = 96


class CutoffNarrowedWarning(UserWarning):
    """cutoff_dist exceeds the dense-canvas halo bound: EDT propagation
    beyond the resident canvas is narrowed.

    Reference semantics (what is being narrowed): with fast_mode OFF, the
    raise/lower-outside wavefronts walk the allocated hash blocks up to
    cutoff_grids_sq with no window bound
    (/root/reference/src/kernel/par_wave/wave_core.cuh:125-126,259-262).
    Here propagation reaches min(cutoff, MAX_HALO_GRIDS) voxels beyond the
    window (the canvas halo); blocks archived out of the canvas keep their
    stored (dist, coc) until they scroll back in, where the canvas EDT
    refreshes them the same frame.  All shipped presets keep cutoff within
    the halo (or run fast_mode, whose reference wave is window-bounded —
    wave_core.cuh:370 `is_inside_local_volume` — so nothing is narrowed);
    only custom configs can trigger this.  Pinned by
    tests/test_long_cutoff.py."""


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """All static parameters of one mapping case."""

    # general (parameters.h:69-98)
    data_case: str = "ugv_corridor"
    for_motion_planner: bool = False
    robot_r: float = 0.4
    occupancy_threshold: int = 180
    voxel_width: float = 0.2
    local_size_m: Tuple[float, float, float] = (10.0, 10.0, 3.0)
    ogm_min_h: float = 0.2
    ogm_max_h: float = 10.0
    fast_mode: bool = True
    cutoff_dist: float = 6.0

    # capacity (parameters.h:100-102); block_max is the pool capacity
    max_blocks: int = 19997

    # display / streaming toggles (parameters.h:72-79)
    display_glb_edt: bool = True
    display_glb_ogm: bool = True
    display_loc_edt: bool = False
    display_loc_ogm: bool = False
    vis_interval: int = 1

    # profiling
    profile_loc_rms: bool = False
    profile_glb_rms: bool = False
    log_name: str = "gie_tpu_log.csv"

    # UGV sensor-height override: when > 0 the sensor origin's z is clamped
    # to this height before the pivot/window computation — the reference
    # does this for ground vehicles whose odometry z drifts
    # (parameters.h:41,82; volumetric_mapper.cpp:148-151)
    ugv_height: float = -1.0
    # global-EDT visualization slice height (metres): publish_glb_2_rviz
    # draws the EDT cloud only at this z layer unless profiling
    # (parameters.h:40,81; volumetric_mapper.h:333-341,279-281)
    vis_height: float = 1.0

    # external-observer / fence
    is_ext_obsv_3D: bool = False
    max_ext_obs: int = 16  # static capacity of AABB obstacle slots

    # sensor specifics
    valid_nan: bool = False  # realsense NaN->far policy (realsense_fast.cu:64-73)

    # engine-specific knobs (no reference counterpart)
    max_raycast_points: int = 65536  # static per-frame point-cloud capacity
    # "projective" = dense spherical min-range carve (default);
    # "dda" = exact per-ray Amanatides-Woo walk (reference-faithful)
    raycast_mode: str = "projective"
    # fuse the projective raycast into the frame program (one dispatch; loses
    # cross-frame raycast/merge pipelining — off by default)
    fuse_raycast: bool = False
    # "canvas_edt" = one exact separable EDT over the dense canvas per frame
    # (default: cheaper than iterating and exactly the Voronoi
    # limit the wavefronts converge to); "relax" = iterative fixed-point
    # relaxation mirroring the reference's raise/lower wavefront composition
    merge_mode: str = "canvas_edt"
    # Change-gated canvas EDT: per frame, recompute the exact EDT only over
    # the bounding slab of voxels this frame's occupancy changes can affect
    # (models/pipeline.py::_gated_canvas_merge), splicing unchanged state
    # through — bit-identical outputs (tests/test_edt_gate.py), cost scales
    # with change volume instead of canvas volume.  canvas_edt + 3-D
    # canvases only (Z==1 excluded); under a mesh the gate slices y lanes
    # only (batch_edt_sharded_slab — x stays the sharded axis).
    edt_gate: bool = True
    # canvas-volume floor for the gate: the gated switch compiles
    # len(menu)+1 EDT pipelines, so small canvases skip it.  256000 = the
    # smallest shipped preset's canvas (uav_raycast_fine, 80x80x40), so
    # every preset gates while the CPU test suite's size-reduced configs
    # (<= ~250k) stay on the single-EDT path; tests that pin the gate
    # itself set 0
    edt_gate_min_vox: int = 256000
    # Slab-size ladder for the gated EDT, as (num, den) canvas fractions
    # per x/y axis (None = pipeline.DEFAULT_MENU_FRACS).  Measured
    # affected-slab distributions set the default;
    # workloads whose bboxes straddle a rung can add one.
    edt_gate_menu: tuple | None = None
    # Fraction of the canvas position slack placed AHEAD of the motion
    # direction when a scroll re-places the origin (0.5 = centred; see
    # map_state.canvas_geometry).  0.75 keeps a 25% reserve behind the
    # robot (immediate reversals don't scroll straight back) while
    # straight-line travel scrolls ~2/3 as often.
    scroll_bias: float = 0.75
    # Extra canvas slack blocks per axis beyond window+halo+alignment (see
    # canvas_blocks): more slack = fewer scrolls (and the motion bias gets
    # room to act) at slightly more canvas volume per pass.
    canvas_slack_blocks: int = 0
    # affected-region (P) test granularity for the gate:
    #   "voxel" — one fused full-canvas pass: box-distance vs the stored
    #             dist_sq of every observed voxel.
    #   "block" — the test runs on the maintained per-cell dist bound
    #             (MapState.dmax_cell, 4x4x4 max over observed voxels): no
    #             full-canvas read at all; the bound is conservative by at
    #             most one cell diameter, so the slab can only grow (by a
    #             few voxels) and outputs stay bit-identical
    #             (tests/test_edt_gate.py).
    edt_gate_pmode: str = "block"
    # phase-1 cache for the gated EDT (MapState.p1c): sites change only
    # inside the window's flip bbox on non-scroll frames, so phase 1 is
    # PATCHED over the covering x-slab instead of rescanned over the canvas
    # (scroll/teleport frames rebuild in full — the y site axis shifted).
    # Bit-identical outputs (tests/test_edt_gate.py); single-device gated
    # path only (a mesh ignores it).
    edt_p1_cache: bool = True
    max_relax_iters: Optional[int] = None  # cap on fixed-point sweeps (None=auto)
    stream_max_blocks: Optional[int] = None  # compaction size for D2H streaming
    stream_k_cols: Optional[int] = None  # per-tick streamed block-column cap

    # capacity-edge policy: the reference fails loudly on every capacity
    # edge (wave_helper.h:26-30,82-88; unify_helper.cuh:107-113,511-517;
    # blockalloc.h:56-58).  Here saturation warns (CapacityWarning) by
    # default; capacity_strict upgrades the warning to a RuntimeError.
    capacity_warn: bool = True
    capacity_strict: bool = False
    # consecutive streaming ticks with an undrained leftover mask before the
    # backlog is reported
    stream_stall_ticks: int = 4

    def __post_init__(self):
        if self.merge_mode not in ("canvas_edt", "relax"):
            raise ValueError(f"merge_mode {self.merge_mode!r} not in "
                             "('canvas_edt', 'relax')")
        if self.edt_gate_pmode not in ("voxel", "block"):
            raise ValueError(f"edt_gate_pmode {self.edt_gate_pmode!r} not in "
                             "('voxel', 'block')")
        if not self.fast_mode:
            cutoff = int(math.ceil(self.cutoff_dist / self.voxel_width))
            if cutoff > MAX_HALO_GRIDS:
                import warnings

                warnings.warn(
                    f"cutoff_dist={self.cutoff_dist} m is "
                    f"{cutoff} voxels at width={self.voxel_width} m — beyond "
                    f"the {MAX_HALO_GRIDS}-voxel dense-canvas halo "
                    f"({MAX_HALO_GRIDS * self.voxel_width:.2f} m): EDT "
                    "propagation outside the canvas is narrowed; archived "
                    "blocks keep stale (dist, coc) until they re-enter "
                    "(docs/PARITY.md divergence 6)",
                    CutoffNarrowedWarning, stacklevel=2)

    # ---- derived static geometry -------------------------------------
    @property
    def local_size(self) -> Tuple[int, int, int]:
        """Window size in voxels (volumetric_mapper.cpp:70-74)."""
        return tuple(int(round(s / self.voxel_width)) for s in self.local_size_m)

    @property
    def map_volume(self) -> int:
        x, y, z = self.local_size
        return x * y * z

    @property
    def max_width(self) -> int:
        """'Infinite' 1-D distance sentinel (local_batch.h:46)."""
        return sum(self.local_size)

    @property
    def max_loc_dist_sq(self) -> int:
        x, y, z = self.local_size
        return x * x + y * y + z * z

    @property
    def cutoff_grids_sq(self) -> int:
        return _grids_sq(self.cutoff_dist, self.voxel_width)

    @property
    def robot_r2_grids(self) -> int:
        return _grids_sq(self.robot_r, self.voxel_width)

    @property
    def is_2d(self) -> bool:
        return self.local_size[2] == 1

    # Canvas: the dense working region for the incremental global EDT =
    # window inflated by the propagation halo, block aligned.  Replaces the
    # reference's hash-walking wavefronts with dense stencil sweeps.
    @property
    def halo_grids(self) -> int:
        if self.fast_mode:
            return VB_WIDTH  # one block ring: read-only boundary seeds
        cutoff = int(math.ceil(self.cutoff_dist / self.voxel_width))
        # bound the dense canvas: beyond MAX_HALO_GRIDS of halo the dense
        # sweep cost dominates.  Narrowing a larger cutoff is LOUD
        # (CutoffNarrowedWarning at construction) and the staleness contract
        # is pinned by tests/test_long_cutoff.py.
        return min(cutoff, MAX_HALO_GRIDS)

    @property
    def canvas_blocks(self) -> Tuple[int, int, int]:
        h = self.halo_grids
        out = []
        for s in self.local_size:
            span = s + 2 * h
            # +1 alignment slack, +1 ceil, + deliberate scroll-hysteresis
            # slack (canvas_slack_blocks): each extra block/axis costs a few
            # % of canvas volume but multiplies the scroll hysteresis
            # distance — and gives the motion-biased placement room to work
            # (with 1 block of slack the bias rounds back to centred)
            out.append(span // VB_WIDTH + 2 + self.canvas_slack_blocks)
        return tuple(out)

    @property
    def canvas_size(self) -> Tuple[int, int, int]:
        return tuple(b * VB_WIDTH for b in self.canvas_blocks)

    @property
    def relax_iters(self) -> int:
        if self.max_relax_iters is not None:
            return self.max_relax_iters
        # propagation depth is bounded by the halo plus in-window travel
        return self.halo_grids + max(self.local_size)

    @property
    def stream_capacity(self) -> int:
        if self.stream_max_blocks is not None:
            return self.stream_max_blocks
        bx, by, bz = self.canvas_blocks
        return bx * by * bz

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "MapConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The five benchmark cases (cfg/*.yaml + launch/*.launch; BASELINE.md table).
# ---------------------------------------------------------------------------

def scan2d_config(**overrides) -> MapConfig:
    """UAV-2DLiDAR (cfg/scan2D_params.yaml)."""
    cfg = MapConfig(
        data_case="scan2D",
        for_motion_planner=True,
        robot_r=0.2,
        voxel_width=0.1,
        local_size_m=(10.0, 10.0, 3.0),
        ogm_min_h=-10.0,
        ogm_max_h=10.0,
        fast_mode=True,
        cutoff_dist=6.0,
        max_blocks=11997,
        display_glb_edt=False,
        display_glb_ogm=False,
        display_loc_edt=True,
        display_loc_ogm=True,
    )
    return cfg.replace(**overrides)


def cow_lady_config(**overrides) -> MapConfig:
    """ETH cow-and-lady pointcloud case (cfg/cow_lady_params.yaml)."""
    cfg = MapConfig(
        data_case="cow_lady",
        for_motion_planner=False,
        voxel_width=0.1,
        local_size_m=(10.0, 10.0, 3.0),
        ogm_min_h=0.0,
        ogm_max_h=2.5,
        fast_mode=False,
        cutoff_dist=2.0,
        max_blocks=11997,
        display_glb_edt=True,
        display_glb_ogm=True,
    )
    return cfg.replace(**overrides)


def ugv_corridor_config(**overrides) -> MapConfig:
    """UGV corridor pointcloud raycast case (cfg/ugv_laser3D_params.yaml)."""
    cfg = MapConfig(
        data_case="ugv_corridor",
        for_motion_planner=False,
        voxel_width=0.05,
        local_size_m=(10.0, 10.0, 1.2),
        ogm_min_h=-10.0,
        ogm_max_h=10.0,
        fast_mode=True,  # yaml omits fast_mode -> default true (parameters.h:93)
        cutoff_dist=100.0,
        max_blocks=21997,
        display_glb_edt=True,
        display_glb_ogm=True,
    )
    return cfg.replace(**overrides)


def depthcam_config(**overrides) -> MapConfig:
    """UAV depth-camera case (cfg/depthcam_params.yaml)."""
    cfg = MapConfig(
        data_case="depthcam",
        for_motion_planner=False,
        robot_r=0.2,
        voxel_width=0.1,
        local_size_m=(10.0, 10.0, 3.0),
        ogm_min_h=-10.0,
        ogm_max_h=10.0,
        fast_mode=False,
        cutoff_dist=6.0,
        max_blocks=11997,
        display_loc_edt=True,
        # +1 deliberate hysteresis block: fewer scrolls at 1.12x canvas
        # volume (per-case: cow-class canvases pay 1.22x volume for it)
        canvas_slack_blocks=1,
    )
    return cfg.replace(**overrides)


def uav_laser3d_config(**overrides) -> MapConfig:
    """UAV 16-ring spherical-projection case (cfg/uav_laser3D_params.yaml)."""
    cfg = MapConfig(
        data_case="laser3D",
        for_motion_planner=True,
        voxel_width=0.2,
        local_size_m=(16.0, 16.0, 2.0),
        ogm_min_h=0.2,
        ogm_max_h=2.0,
        fast_mode=True,
        cutoff_dist=5.0,
        max_blocks=21997,
        display_loc_edt=True,
        display_glb_ogm=True,
        display_glb_edt=False,
    )
    return cfg.replace(**overrides)


def uav_laser3d_fine_config(**overrides) -> MapConfig:
    """UAV 3D-LiDAR raycast fine case (cfg/uav_laser3D_fine_params.yaml)."""
    cfg = MapConfig(
        data_case="uav_raycast_fine",
        for_motion_planner=True,
        robot_r=0.6,
        voxel_width=0.2,
        local_size_m=(10.0, 10.0, 3.0),
        ogm_min_h=0.2,
        ogm_max_h=3.0,
        fast_mode=True,
        cutoff_dist=5.0,
        max_blocks=11997,
        display_loc_edt=True,
        display_glb_ogm=True,
        display_glb_edt=False,
    )
    return cfg.replace(**overrides)


PRESETS = {
    "scan2D": scan2d_config,
    "cow_lady": cow_lady_config,
    "ugv_corridor": ugv_corridor_config,
    "depthcam": depthcam_config,
    "laser3D": uav_laser3d_config,
    "uav_raycast_fine": uav_laser3d_fine_config,
}


def load_config(case: str, **overrides) -> MapConfig:
    if case not in PRESETS:
        raise KeyError(f"unknown data_case {case!r}; available: {sorted(PRESETS)}")
    return PRESETS[case](**overrides)


def load_config_yaml(path: str) -> MapConfig:
    """Load a reference-format yaml (cfg/*.yaml schema) into a MapConfig."""
    import yaml  # lazy; pyyaml ships with the baked environment

    with open(path) as f:
        raw = yaml.safe_load(f)
    ogm = raw.get("ogm", {})
    wave = raw.get("wave", {})
    hash_cfg = raw.get("hash", {})
    return MapConfig(
        data_case=raw.get("data_case", "custom"),
        for_motion_planner=bool(raw.get("for_motion_planner", False)),
        robot_r=float(raw.get("robot_r", 0.4)),
        occupancy_threshold=int(raw.get("occupancy_threshold", 180)),
        voxel_width=float(raw.get("voxel_width", 0.2)),
        local_size_m=(
            float(raw.get("local_size_x", 10.0)),
            float(raw.get("local_size_y", 10.0)),
            float(raw.get("local_size_z", 3.0)),
        ),
        ogm_min_h=float(ogm.get("min_height", 0.2)),
        ogm_max_h=float(ogm.get("max_height", 10.0)),
        fast_mode=bool(wave.get("fast_mode", True)),
        cutoff_dist=float(wave.get("cutoff_dist", 6.0)),
        max_blocks=int(hash_cfg.get("block_max", 19997)),
        display_glb_edt=bool(raw.get("display_glb_edt", True)),
        display_glb_ogm=bool(raw.get("display_glb_ogm", True)),
        display_loc_edt=bool(raw.get("display_loc_edt", False)),
        display_loc_ogm=bool(raw.get("display_loc_ogm", False)),
        vis_interval=int(raw.get("vis_interval", 1)),
        profile_loc_rms=bool(raw.get("profile_loc_rms", False)),
        profile_glb_rms=bool(raw.get("profile_glb_rms", False)),
        log_name=str(raw.get("log_name", "gie_tpu_log.csv")),
        is_ext_obsv_3D=bool(raw.get("is_ext_obsv_3D", False)),
        ugv_height=float(raw.get("ugv_height", -1.0)),
        vis_height=float(raw.get("vis_height", 1.0)),
    )


# cow-lady vicon->cam extrinsic, hard-coded in the reference
# (parameters.h:112-118)
T_V_C = np.array(
    [
        [0.971048, -0.120915, 0.206023, 0.00114049],
        [0.15701, 0.973037, -0.168959, 0.0450936],
        [-0.180038, 0.196415, 0.96385, 0.0430765],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)

# default virtual-fence bbox (parameters.h:121-131); box 0 is the inverted
# "flyable region" fence
DEFAULT_FENCE_LL = np.array([-3.6, -3.2, 0.2], np.float32)
DEFAULT_FENCE_UR = np.array([4.4, 3.4, 2.6], np.float32)
