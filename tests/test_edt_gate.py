"""Change-gated canvas EDT: bit-exactness vs the full recompute.

The gated merge (models/pipeline.py::_gated_canvas_merge) recomputes the
exact EDT only over the affected-region slab and splices unchanged state
through; its soundness argument is inductive, so these tests drive the SAME
frame sequences through cfg.edt_gate on/off and assert bitwise equality of
every state field and every output, across the cases the induction leans
on: site appearance/disappearance near and far, UNKNOWN transitions,
axis/diagonal/z scrolls, teleports, zero-site epochs (the force-full
guard), keep-old out-of-canvas memory, fast_mode window gating, and
randomized fuzz worlds.  Also pins batch_edt_slab against batch_edt
directly and the mapper/replay integration paths.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from gie_mapping_tpu.map_state import MapState, canvas_geometry
from gie_mapping_tpu.models.pipeline import _slab_menu, merge_frame
from gie_mapping_tpu.utils.config import scan2d_config
from gie_mapping_tpu.utils.constants import (
    EMPTY_VALUE,
    VOX_FREE,
    VOX_OCCUPIED,
    VOX_UNKNOWN,
)

STATE_FIELDS = ("vox_type", "dist_sq", "coc", "occ_val", "present",
                "arch_keys", "n_arch", "a_packed")
SKIP_KEYS = ("gate_level", "gate_slab_vox")


def _cfg(gate, fast=False, cutoff=2.0, pmode="voxel"):
    pmode, _, extra = pmode.partition("+")
    return scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2,
                         fast_mode=fast, cutoff_dist=cutoff, max_blocks=2048,
                         for_motion_planner=False, edt_gate=gate,
                         edt_gate_min_vox=0, edt_gate_pmode=pmode,
                         edt_p1_cache=extra == "p1c")


def _fence(cfg):
    M = cfg.max_ext_obs
    return (jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
            jnp.zeros((M,), jnp.bool_), jnp.int32(0))


def _step(cfg, gmap, inst, pvt):
    pvt = np.asarray(pvt, np.int32)
    origin_blk, _, off = canvas_geometry(cfg, pvt)
    gmap, out = merge_frame(
        gmap, jnp.asarray(inst, jnp.int8),
        jnp.zeros(cfg.local_size, jnp.int32), jnp.asarray(pvt),
        jnp.asarray(origin_blk), jnp.asarray(off), *_fence(cfg),
        cfg=cfg, input_pointcloud=False,
    )
    return gmap, {k: np.asarray(v) for k, v in out.items()}


def _dmax_invariant(g):
    """dmax_cell must upper-bound the stored dist_sq of every observed voxel
    (the cell-granular P test's soundness condition)."""
    d = np.asarray(g.dist_sq)
    obs = np.asarray(g.vox_type) != VOX_UNKNOWN
    X, Y, Z = d.shape
    true_max = np.where(obs, d, -1).reshape(
        X // 4, 4, Y // 4, 4, Z // 4, 4).max((1, 3, 5))
    assert (np.asarray(g.dmax_cell) >= true_max).all()


def _p1c_invariant(g, cfg):
    """After every gated merge the phase-1 cache must hold EXACTLY the
    packed phase-1 word of the stored occupancy (p1c_ok is re-established
    each frame: any scroll clears it, the merge's full branch rebuilds)."""
    from gie_mapping_tpu.ops.edt_batch import phase1_packed

    assert bool(g.p1c_ok)
    occ = jnp.asarray(np.asarray(g.vox_type)) == VOX_OCCUPIED
    want = np.asarray(phase1_packed(occ, sum(cfg.canvas_size)))
    np.testing.assert_array_equal(np.asarray(g.p1c), want)


def _run_scenario(frames, fast=False, cutoff=2.0, pmode="voxel"):
    """frames: list of (inst_fn(local_size)->int8 array, pvt).  Returns the
    gate levels taken; asserts gated == ungated bitwise each frame."""
    results = []
    for gate in (False, True):
        cfg = _cfg(gate, fast=fast, cutoff=cutoff, pmode=pmode)
        g = MapState.create(cfg)
        outs, states = [], []
        for inst_fn, pvt in frames:
            g, out = _step(cfg, g, inst_fn(cfg.local_size), pvt)
            if gate and pmode.startswith("block"):
                _dmax_invariant(g)
            if gate and pmode.endswith("p1c"):
                _p1c_invariant(g, cfg)
            outs.append(out)
            states.append({f: np.asarray(getattr(g, f))
                           for f in STATE_FIELDS})
        results.append((outs, states))
    (o0, s0), (o1, s1) = results
    for i, (a, b) in enumerate(zip(o0, o1)):
        for k in a:
            if k in SKIP_KEYS:
                continue
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"frame {i} output {k!r}")
    for i, (a, b) in enumerate(zip(s0, s1)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"frame {i} state {k!r}")
    return [int(o["gate_level"]) for o in o1]


def _free(shape):
    return np.full(shape, VOX_FREE, np.int8)


def _with(base, *voxels, val=VOX_OCCUPIED):
    def fn(shape):
        inst = base(shape)
        for v in voxels:
            inst[tuple(v)] = val
        return inst
    return fn


def test_menu_nonempty():
    cfg = _cfg(True)
    menu = _slab_menu(cfg.canvas_size)
    assert menu and all(sx % 8 == 0 and sy % 8 == 0 for sx, sy in menu)
    assert menu == sorted(menu)


def test_custom_menu_bit_identical():
    """cfg.edt_gate_menu overrides the slab ladder (VERDICT r4 item 8's
    5/16 rung); any menu must stay bit-identical to the ungated path."""
    rung = ((3, 16), (5, 16), (3, 8), (5, 8))
    frames = [
        (_with(_free, [8, 8, 4]), [0, 0, 0]),
        (_with(_free, [8, 8, 4]), [0, 0, 0]),
        (_with(_free, [8, 8, 4], [2, 14, 2]), [0, 0, 0]),
        (_with(_free, [2, 14, 2]), [3, 1, 0]),    # + a sub-block move
    ]
    results = []
    for gate in (False, True):
        cfg = _cfg(gate).replace(edt_gate_menu=rung if gate else None)
        assert not gate or len(_slab_menu(cfg.canvas_size, rung)) >= 3
        g = MapState.create(cfg)
        outs = []
        for inst_fn, pvt in frames:
            g, out = _step(cfg, g, inst_fn(cfg.local_size), pvt)
            outs.append(out)
        results.append((outs, g))
    (o0, g0), (o1, g1) = results
    for i, (a, b) in enumerate(zip(o0, o1)):
        for k in a:
            if k not in SKIP_KEYS:
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"frame {i} {k!r}")
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(g0, f)),
                                      np.asarray(getattr(g1, f)), err_msg=f)


@pytest.mark.parametrize("pmode", ["voxel", "block", "block+p1c"])
def test_static_and_appearing_obstacles(pmode):
    frames = [
        (_with(_free, [8, 8, 4]), [0, 0, 0]),
        (_with(_free, [8, 8, 4]), [0, 0, 0]),        # static: tiny slab
        (_with(_free, [8, 8, 4], [2, 14, 2]), [0, 0, 0]),  # appears
        (_with(_free, [2, 14, 2]), [0, 0, 0]),       # disappears (raise)
        (_free, [0, 0, 0]),                          # all sites gone
        (_with(_free, [15, 1, 7]), [0, 0, 0]),       # reappears far (epoch!)
        (_with(_free, [15, 1, 7]), [0, 0, 0]),
    ]
    levels = _run_scenario(frames, pmode=pmode)
    n_menu = len(_slab_menu(_cfg(True).canvas_size))
    assert levels[4] == n_menu or levels[5] == n_menu  # zero-site force-full
    assert min(levels) < n_menu  # gating engaged somewhere


@pytest.mark.parametrize("pmode", ["voxel", "block", "block+p1c"])
def test_unknown_transitions(pmode):
    def half_unknown(shape):
        inst = _free(shape)
        inst[: shape[0] // 2] = VOX_UNKNOWN
        return inst
    frames = [
        (_with(half_unknown, [12, 8, 4]), [0, 0, 0]),
        (_with(_free, [12, 8, 4]), [0, 0, 0]),   # half becomes observed
        (_with(_free, [12, 8, 4]), [0, 0, 0]),
    ]
    _run_scenario(frames, pmode=pmode)


@pytest.mark.parametrize("pmode", ["voxel", "block", "block+p1c"])
def test_scrolls_axis_diagonal_z_and_teleport(pmode):
    frames = [
        (_with(_free, [8, 8, 4]), [0, 0, 0]),
        (_with(_free, [0, 8, 4]), [8, 0, 0]),    # +x scroll
        (_with(_free, [0, 0, 4]), [8, 8, 0]),    # +y scroll (diagonal path)
        (_with(_free, [0, 0, 0]), [8, 8, 4]),    # z scroll
        (_with(_free, [0, 0, 0]), [8, 8, 4]),
        (_free, [96, 96, 0]),                    # teleport (archive round trip)
        (_free, [8, 8, 4]),                      # teleport back: re-entry
        (_with(_free, [4, 4, 2]), [8, 8, 4]),
    ]
    _run_scenario(frames, pmode=pmode)


@pytest.mark.parametrize("pmode", ["voxel", "block", "block+p1c"])
def test_keep_old_memory_journey(pmode):
    """Out-of-canvas coc memory (keep_old) across archive + re-entry: the
    long-cutoff journey of tests/test_long_cutoff.py under the gate."""
    def place(x):
        return _with(_free, [x, 8, 4])
    frames = [
        (place(14), [24, 0, 0]),   # obstacle at glb 38 (window 24..40)
        (_free, [8, 0, 0]),        # v at glb 10 observed; coc -> 38
        (_free, [36, 0, 0]),       # v archived; obstacle observed REMOVED
        (_free, [36, 0, 0]),
        (_with(_free, [12, 8, 4]), [8, 0, 0]),  # re-entry + new obstacle glb 20
    ]
    _run_scenario(frames, pmode=pmode)


@pytest.mark.parametrize("pmode", ["voxel", "block", "block+p1c"])
def test_fast_mode_window_gating(pmode):
    frames = [
        (_with(_free, [14, 8, 4]), [0, 0, 0]),
        (_free, [8, 0, 0]),        # obstacle observed removed; v outside win
        (_with(_free, [2, 2, 2]), [8, 0, 0]),
        (_free, [0, 0, 0]),
    ]
    _run_scenario(frames, fast=True, cutoff=100.0, pmode=pmode)


@pytest.mark.parametrize("pmode", ["voxel", "block", "block+p1c"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_unaligned_pivots(seed, pmode):
    """Production pivots come from the continuous robot pose
    (geo.calculate_pivot) — ARBITRARY voxel coordinates, not multiples of
    8.  This fuzz moves the window by unaligned steps and teleports to
    unaligned positions; it catches the three divergences a review fuzz
    found on the aligned-only suite: (a) the slab fit test ignoring the
    ox//8*8 snap slack, (b) the phase-1 cache patch with the same slack,
    (c) scrolled-out coc sites losing a distance tie (exiting delta
    boxes)."""
    rng = np.random.default_rng(100 + seed)
    frames = []
    pvt = np.zeros(3, int)
    for i in range(12):
        pvt = pvt + rng.integers(-6, 7, 3)
        if rng.random() < 0.12:
            pvt = rng.integers(-41, 41, 3)  # unaligned teleport
        voxels = [rng.integers(0, s, 3) % np.asarray((16, 16, 8))
                  for s in [(16, 16, 8)] * int(rng.integers(0, 5))]
        frames.append((_with(_free, *voxels), pvt.copy()))
    _run_scenario(frames, pmode=pmode)


@pytest.mark.parametrize("pmode", ["voxel", "block", "block+p1c"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_random_worlds(seed, pmode):
    rng = np.random.default_rng(seed)
    frames = []
    pvt = np.zeros(3, int)
    for i in range(10):
        move = rng.integers(-1, 2, 3) * rng.choice([0, 8])
        pvt = pvt + move
        if rng.random() < 0.1:
            pvt = rng.integers(-5, 6, 3) * 8  # teleport
        voxels = [rng.integers(0, s, 3) % np.asarray((16, 16, 8))
                  for s in [(16, 16, 8)] * int(rng.integers(0, 5))]
        base = _free
        if rng.random() < 0.3:
            def base(shape, k=int(rng.integers(1, 4))):
                inst = _free(shape)
                inst[:, : 4 * k] = VOX_UNKNOWN
                return inst
        frames.append((_with(base, *voxels), pvt.copy()))
    _run_scenario(frames, pmode=pmode)


# ---------------------------------------------------------------------------
# batch_edt_slab unit equality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_edt_slab_matches_full(seed):
    from gie_mapping_tpu.ops.edt_batch import batch_edt, batch_edt_slab

    rng = np.random.default_rng(seed)
    X, Y, Z = 48, 40, 16
    occ = (rng.random((X, Y, Z)) < 0.02)
    glb = np.where(occ, VOX_OCCUPIED, VOX_FREE).astype(np.int8)
    full = {k: np.asarray(v) for k, v in
            batch_edt(jnp.asarray(glb), max_width=X + Y + Z).items()}
    for (x0, y0, sx, sy) in [(0, 0, 16, 16), (8, 16, 24, 24), (32, 24, 16, 16),
                             (0, 0, X, Y), (40, 32, 8, 8)]:
        slab = {k: np.asarray(v) for k, v in
                batch_edt_slab(jnp.asarray(glb), jnp.int32(x0), jnp.int32(y0),
                               sx=sx, sy=sy, max_width=X + Y + Z).items()}
        for k in ("dist_sq", "coc", "valid"):
            np.testing.assert_array_equal(
                slab[k], full[k][x0:x0 + sx, y0:y0 + sy],
                err_msg=f"slab ({x0},{y0},{sx},{sy}) field {k!r}")


def test_batch_edt_slab_empty_canvas():
    from gie_mapping_tpu.ops.edt_batch import batch_edt_slab

    glb = np.full((24, 24, 8), VOX_FREE, np.int8)
    out = batch_edt_slab(jnp.asarray(glb), jnp.int32(8), jnp.int32(8),
                         sx=8, sy=8, max_width=56)
    assert not bool(np.asarray(out["valid"]).any())
    assert (np.asarray(out["dist_sq"]) == EMPTY_VALUE).all()


# ---------------------------------------------------------------------------
# mapper / replay integration (scroll_frame_step + replay_frames paths)
# ---------------------------------------------------------------------------


def _mapper_cfg(gate, **kw):
    return scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2,
                         fast_mode=False, cutoff_dist=2.0, max_blocks=2048,
                         for_motion_planner=False, edt_gate=gate,
                         edt_gate_min_vox=0,
                         max_raycast_points=512, fuse_raycast=True,
                         display_glb_edt=False, display_glb_ogm=False, **kw)


@pytest.mark.parametrize("extra", [{}, {"edt_p1_cache": True}])
def test_mapper_and_replay_paths_match(extra):
    """Per-frame vs scanned-replay equality, ungated vs gated (and gated
    with the phase-1 cache: the in-scan compacted scroll must clear
    p1c_ok through the lax.cond and the next merge must rebuild)."""
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.runtime.datasets import BoxWorld, circular_trajectory

    world = BoxWorld.corridor(seed=3, n_pillars=4, extent=1.4, height=1.6)
    poses = circular_trajectory(n_frames=6, radius=0.8, height=0.8)
    clouds = [world.pointcloud(p, n_rays=512, max_range=3.0, seed=i)
              for i, p in enumerate(poses)]

    finals = []
    for gate in (False, True):
        cfg = _mapper_cfg(gate, **(extra if gate else {}))
        m = VolumetricMapper(cfg)
        pts, val = m.stage_pointcloud_batch(clouds)
        # per-frame path (frame_step / scroll_frame_step)
        for i in range(3):
            m.process_pointcloud(poses[i], pts[i], val[i])
        # scanned replay path (replay_frames with in-scan scrolls)
        m.process_pointcloud_batch(poses[3:], pts[3:], val[3:], chunk=3)
        finals.append({f: np.asarray(getattr(m.state, f))
                       for f in STATE_FIELDS})
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(finals[0][k], finals[1][k],
                                      err_msg=f"state {k!r}")
