"""The canvas scroll (map_state._do_scroll, dense and compacted archive
paths) against a numpy oracle: shifted canvas with default fill, cocs
re-anchored, exiting present blocks archived with block-anchored cocs, and
an out-and-back scroll restoring every present block exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gie_mapping_tpu.map_state import (COC_INVALID16, MapState, _do_scroll,
                                       np_unpack_voxels)
from gie_mapping_tpu.utils.config import scan2d_config
from gie_mapping_tpu.utils.constants import EMPTY_VALUE, VOX_UNKNOWN

W = 8
SHIFTS = [(1, 0, 0), (0, -1, 0), (1, 1, -1), (2, 0, 1), (0, 0, 2),
          (1, 0, -3), (0, 1, 9)]


def _cfg():
    return scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2,
                         max_blocks=4096)


def _state(cfg, seed):
    """Random canvas content, random present blocks, empty archive."""
    rng = np.random.default_rng(seed)
    cs, cb = cfg.canvas_size, cfg.canvas_blocks
    coc = rng.integers(-100, 100, cs + (3,)).astype(np.int16)
    coc[rng.random(cs) < 0.2] = COC_INVALID16
    return dataclasses.replace(
        MapState.create(cfg),
        occ_val=jnp.asarray(rng.integers(0, 255, cs, dtype=np.uint8)),
        vox_type=jnp.asarray(rng.integers(0, 4, cs).astype(np.int8)),
        dist_sq=jnp.asarray(rng.integers(0, 900, cs).astype(np.int32)),
        coc=jnp.asarray(coc),
        present=jnp.asarray(rng.random(cb) < 0.7))


def _shift(a, s, fill):
    """out[i] = a[i + s] where in range, else fill (numpy)."""
    out = np.full_like(a, fill)
    src, dst = [], []
    for ax, k in enumerate(s):
        n = a.shape[ax]
        lo, hi = max(0, -k), min(n, n - k)
        if lo >= hi:
            return out
        dst.append(slice(lo, hi))
        src.append(slice(lo + k, hi + k))
    out[tuple(dst)] = a[tuple(src)]
    return out


def _oracle(st, shift):
    sv = np.asarray(shift) * W
    old = {k: np.asarray(getattr(st, k)) for k in
           ("occ_val", "vox_type", "dist_sq", "coc", "present")}
    coc = old["coc"].astype(np.int32)
    valid = coc[..., 0] != COC_INVALID16
    coc = np.where(valid[..., None], coc - sv, COC_INVALID16)
    want = {
        "occ_val": _shift(old["occ_val"], sv, 0),
        "vox_type": _shift(old["vox_type"], sv, VOX_UNKNOWN),
        "dist_sq": _shift(old["dist_sq"], sv, EMPTY_VALUE),
        "coc": _shift(coc.astype(np.int16), tuple(sv) + (0,), COC_INVALID16),
        "present": _shift(old["present"], shift, False),
    }
    # exiting present blocks, archived in linear block order
    cb = old["present"].shape
    keys, blocks = [], []
    for b in np.argwhere(old["present"]):
        nb = b - np.asarray(shift)
        if ((nb < 0) | (nb >= cb)).any():
            keys.append(b)
            blocks.append(b)
    return want, np.asarray(keys, np.int32).reshape(-1, 3), blocks


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shift", SHIFTS)
def test_scroll_matches_numpy_oracle(shift, compact):
    cfg = _cfg()
    st = _state(cfg, 7)
    nb = int(np.prod(cfg.canvas_blocks))
    new = _do_scroll(st, jnp.asarray(np.asarray(shift, np.int32)), cfg,
                     compact_rows=nb if compact else None)
    want, keys, blocks = _oracle(st, shift)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(getattr(new, k)), v,
                                      err_msg=k)
    n = len(keys)
    assert int(new.n_arch) == n and int(new.arch_dropped) == 0
    np.testing.assert_array_equal(np.asarray(new.arch_keys)[:n], keys)
    # archived rows: the block's voxels, cocs anchored to the block origin
    rows = np.asarray(new.a_packed)[:n].reshape(n, 512, 3)
    occ, typ, dist, coc = np_unpack_voxels(rows)
    old_coc = np.asarray(st.coc).astype(np.int32)
    for r, b in enumerate(blocks):
        sl = tuple(slice(c * W, c * W + W) for c in b)
        np.testing.assert_array_equal(
            dist[r].reshape(W, W, W), np.asarray(st.dist_sq)[sl])
        np.testing.assert_array_equal(
            typ[r].reshape(W, W, W), np.asarray(st.vox_type)[sl])
        c_old = old_coc[sl].reshape(-1, 3)
        ok = c_old[:, 0] != COC_INVALID16
        np.testing.assert_array_equal(coc[r][ok], c_old[ok] - b * W)
        assert (coc[r][~ok] == COC_INVALID16).all()


@pytest.mark.parametrize("compact", [False, True])
def test_scroll_out_and_back_restores_present_blocks(compact):
    cfg = _cfg()
    st = _state(cfg, 11)
    nb = int(np.prod(cfg.canvas_blocks))
    rows = nb if compact else None
    there = jnp.asarray(np.array([2, 1, 0], np.int32))
    back = jnp.zeros(3, jnp.int32)
    rt = _do_scroll(_do_scroll(st, there, cfg, compact_rows=rows), back, cfg,
                    compact_rows=rows)
    pres = np.asarray(st.present)
    np.testing.assert_array_equal(np.asarray(rt.present), pres)
    pv = np.repeat(np.repeat(np.repeat(pres, W, 0), W, 1), W, 2)
    for k in ("occ_val", "vox_type", "dist_sq", "coc"):
        a, b = np.asarray(getattr(rt, k)), np.asarray(getattr(st, k))
        np.testing.assert_array_equal(a[pv], b[pv], err_msg=k)
