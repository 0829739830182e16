"""Plain-XLA paths that replaced hand-written kernels, each against an
independent numpy oracle: stream_extract's block rows, the projective
panorama lookup, the depth-image lookup (NaN and +-Inf pixels) and the
packed phase-1 word (with the merge's phase-1 cache)."""
import jax.numpy as jnp
import numpy as np
import pytest

from gie_mapping_tpu.map_state import (MapState, _dense_to_blocks,
                                       np_unpack_voxels, pack_voxels,
                                       stream_extract)
from gie_mapping_tpu.ops import raycast as rc
from gie_mapping_tpu.ops import scan_sensors as ss
from gie_mapping_tpu.ops.edt_batch import (batch_edt, phase1_fits,
                                           phase1_pack_bits, phase1_packed)
from gie_mapping_tpu.utils import geometry as geo
from gie_mapping_tpu.utils.config import scan2d_config
from gie_mapping_tpu.utils.constants import (SENS_FAR_DIST, VOX_FREE,
                                             VOX_OCCUPIED, VOX_UNKNOWN)


# ---- stream_extract ------------------------------------------------------

def _random_state(cfg, rng):
    import dataclasses

    cs = cfg.canvas_size
    return dataclasses.replace(
        MapState.create(cfg),
        occ_val=jnp.asarray(rng.integers(0, 255, cs, dtype=np.uint8)),
        vox_type=jnp.asarray(rng.integers(0, 4, cs).astype(np.int8)),
        dist_sq=jnp.asarray(rng.integers(0, 900, cs).astype(np.int32)),
        coc=jnp.asarray(rng.integers(-90, 90, cs + (3,)).astype(np.int16)))


@pytest.mark.parametrize("rot", [0, 5])
def test_stream_extract_rows_are_the_changed_columns(rot):
    cfg = scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2)
    rng = np.random.default_rng(rot)
    st = _random_state(cfg, rng)
    cbx, cby, cbz = cb = cfg.canvas_blocks
    changed = rng.random(cb) < 0.05
    k = 6
    ids, valid, rows, blk_mask, left = (np.asarray(a) for a in stream_extract(
        st, jnp.asarray(changed), jnp.zeros(cb, bool), jnp.int32(rot),
        cfg=cfg, k_cols=k))
    blocks = np.asarray(_dense_to_blocks(pack_voxels(
        st.occ_val, st.vox_type, st.dist_sq, st.coc), cb)).reshape(
            cbx * cby, cbz, 512, 3)
    cols = np.flatnonzero(changed.any(2).reshape(-1))
    order = sorted(cols, key=lambda c: (c - rot) % (cbx * cby))
    served = order[:k]
    assert list(ids[valid]) == served
    rows = rows.reshape(k, cbz, 512, 3)
    for j, c in enumerate(ids[valid]):
        np.testing.assert_array_equal(rows[j], blocks[c])
        np.testing.assert_array_equal(blk_mask[j],
                                      changed.reshape(-1, cbz)[c])
    left_cols = set(np.flatnonzero(left.any(2).reshape(-1)))
    assert left_cols == set(order[k:])
    # rows unpack to the state's own voxels
    occ, typ, dist, coc = np_unpack_voxels(rows[0, 0])
    c0 = ids[0]
    bx, by = divmod(c0, cby)
    sl = (slice(bx * 8, bx * 8 + 8), slice(by * 8, by * 8 + 8), slice(0, 8))
    np.testing.assert_array_equal(dist.reshape(8, 8, 8),
                                  np.asarray(st.dist_sq)[sl])


# ---- projective panorama lookup -----------------------------------------

def _np_panorama(points, origin, pvt, local_size, vw, nt, nph):
    """Per-voxel (min depth, ray count) of its (theta, phi) bin."""
    rel = points - origin
    r = np.linalg.norm(rel, axis=-1)
    bt = np.clip((np.arctan2(rel[:, 1], rel[:, 0]) + np.pi) * (nt / (2 * np.pi)),
                 0, nt - 1).astype(np.int64)
    rho = np.hypot(rel[:, 0], rel[:, 1])
    bp = np.clip((np.arctan2(rel[:, 2], rho) + np.pi / 2) * (nph / np.pi),
                 0, nph - 1).astype(np.int64)
    depth = np.full(nt * nph, 1e30, np.float32)
    np.minimum.at(depth, bt * nph + bp, r.astype(np.float32))
    cnt = np.bincount(bt * nph + bp, minlength=nt * nph)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in local_size],
                             indexing="ij"), -1)
    v = (g + pvt) * np.float32(vw) - origin
    vt = np.clip((np.arctan2(v[..., 1], v[..., 0]) + np.pi) * (nt / (2 * np.pi)),
                 0, nt - 1).astype(np.int64)
    vp = np.clip((np.arctan2(v[..., 2], np.hypot(v[..., 0], v[..., 1]))
                  + np.pi / 2) * (nph / np.pi), 0, nph - 1).astype(np.int64)
    return depth[vt * nph + vp], cnt[vt * nph + vp], np.linalg.norm(v, axis=-1)


def test_pointcloud_project_free_space_matches_panorama_oracle():
    rng = np.random.default_rng(3)
    local, vw = (20, 20, 10), 0.2
    pvt = np.array([-10, -10, -2], np.int32)
    origin = np.array([0.05, 0.03, 0.1], np.float32)
    pts = (rng.normal(size=(3000, 3)) * [1.5, 1.5, 0.5]).astype(np.float32)
    nt, nph = rc.panorama_bins(local)
    inst, cnt = rc.pointcloud_project(
        jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.asarray(origin),
        jnp.asarray(pvt), local_size=local, voxel_width=vw, ogm_min_h=-9.0,
        ogm_max_h=9.0, for_motion_planner=False, robot_r2_grids=0,
        n_theta=nt, n_phi=nph)
    inst, cnt = np.asarray(inst), np.asarray(cnt)
    vdepth, vcnt, vr = _np_panorama(pts, origin, pvt, local, vw, nt, nph)
    freed = (vdepth < 1e30) & (vr + vw < vdepth) & (vr <= 0.707 * local[0] * vw)
    # voxels off bin edges (float rounding decides edges) must agree
    edge = np.abs(vr + vw - vdepth) < 1e-4
    noend = cnt <= 0
    ok = noend & ~edge
    np.testing.assert_array_equal(cnt[ok & freed], -np.minimum(vcnt, 10)[ok & freed])
    assert (cnt[ok & ~freed] == 0).all()
    assert (inst[ok & freed] == VOX_FREE).all()
    assert freed.sum() > 100


# ---- depth-image lookup --------------------------------------------------

@pytest.mark.parametrize("valid_nan", [False, True])
def test_realsense_lookup_with_nan_and_inf_pixels(valid_nan):
    rows, cols = 24, 32
    rng = np.random.default_rng(9)
    depth = rng.uniform(0.5, 3.0, (rows, cols)).astype(np.float32)
    depth[::3, ::4] = np.nan
    depth[1::5, 2::7] = np.inf
    depth[2::6, 1::5] = -np.inf
    local, vw = (20, 16, 12), 0.2
    pvt = np.array([0, -8, -6], np.int32)
    proj = geo.Projection.identity()
    cam = ss.CamParam(jnp.float32(20.0), jnp.float32(20.0),
                      jnp.float32(cols / 2), jnp.float32(rows / 2),
                      jnp.asarray(depth))
    inst = np.asarray(ss.realsense_update(
        proj, cam, jnp.asarray(pvt), local_size=local, voxel_width=vw,
        ogm_min_h=-9.0, ogm_max_h=9.0, for_motion_planner=False,
        robot_r2_grids=0, valid_nan=valid_nan))
    # numpy oracle of the same inverse model
    g = np.stack(np.meshgrid(*[np.arange(s) for s in local], indexing="ij"),
                 -1)
    p = ((g + pvt) * np.float32(vw)).astype(np.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    safe = np.where(np.abs(x) > 1e-6, x, 1e-6).astype(np.float32)
    px = np.floor(-y * np.float32(20.0) / safe + cols / 2 + 0.5).astype(int)
    py = np.floor(-z * np.float32(20.0) / safe + rows / 2 + 0.5).astype(int)
    inf = (x > 0.3) & (x <= 6.0) & (px >= 0) & (px < cols) & (py >= 0) & (py < rows)
    img = np.where(np.isnan(depth), SENS_FAR_DIST if valid_nan else -1.0, depth)
    real = img[np.clip(py, 0, rows - 1), np.clip(px, 0, cols - 1)]
    ok = inf & (real > 0.21)
    free = ok & (x < real - vw)
    occ = ok & (x >= real - vw) & (x <= real + vw)
    want = np.where(occ, VOX_OCCUPIED, np.where(free, VOX_FREE, VOX_UNKNOWN))
    np.testing.assert_array_equal(inst, want)
    # +Inf pixels carve free space and never mark a hit; -Inf pixels are
    # no measurement
    hit_inf = inf & np.isposinf(real)
    assert hit_inf.any() and (inst[hit_inf] == VOX_FREE).all()
    assert (inst[inf & np.isneginf(real)] == VOX_UNKNOWN).all()


# ---- packed phase 1 ------------------------------------------------------

def _np_phase1_packed(occ, max_width):
    X, Y, Z = occ.shape
    yb = phase1_pack_bits(Y)
    out = np.zeros(occ.shape, np.int64)
    for x in range(X):
        for z in range(Z):
            sites = np.flatnonzero(occ[x, :, z])
            if not len(sites):
                continue
            for y in range(Y):
                d = np.abs(sites - y)
                j = d.argmin()  # first = lower-y site on ties
                g = min(d[j], max_width)
                if g < max_width:
                    out[x, y, z] = (g * g << (yb + 1)) | (sites[j] << 1) | 1
    return out


@pytest.mark.parametrize("shape", [(6, 50, 5), (4, 33, 7), (3, 8, 130)])
def test_phase1_packed_matches_bruteforce(shape):
    rng = np.random.default_rng(sum(shape))
    occ = rng.random(shape) < 0.05
    got = np.asarray(phase1_packed(jnp.asarray(occ), sum(shape)))
    np.testing.assert_array_equal(got, _np_phase1_packed(occ, sum(shape)))


def test_batch_edt_with_phase1_cache_matches_fresh_phase1():
    rng = np.random.default_rng(12)
    glb = np.where(rng.random((16, 24, 16)) < 0.02, VOX_OCCUPIED,
                   VOX_FREE).astype(np.int8)
    mw = sum(glb.shape)
    p1 = phase1_packed(jnp.asarray(glb) == VOX_OCCUPIED, mw)
    a = batch_edt(jnp.asarray(glb), max_width=mw)
    b = batch_edt(jnp.asarray(glb), max_width=mw, p1_packed=p1)
    for k in ("dist_sq", "coc", "valid"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_phase1_pack_budget():
    assert phase1_fits(1024) and not phase1_fits(1025)
    assert phase1_pack_bits(240) == 8
    with pytest.raises(ValueError, match="Y <= 1024"):
        phase1_pack_bits(2048)
