"""Batch EDT vs scipy oracle + coc-correctness property tests.

The reference has no tests; its oracle is brute-force KNN RMSE
(/root/reference/include/gt_checker.h:30-80).  Here we use
scipy.ndimage.distance_transform_edt as the exact oracle and additionally
check the closest-obstacle-coordinate invariants the reference relies on.
"""
import numpy as np
import pytest
from scipy import ndimage

import jax.numpy as jnp

from gie_mapping_tpu.ops.edt_batch import batch_edt, lower_envelope
from gie_mapping_tpu.utils.constants import EMPTY_VALUE, VOX_OCCUPIED


def _random_types(rng, shape, p_occ=0.05):
    occ = rng.random(shape) < p_occ
    return (occ.astype(np.int8) * VOX_OCCUPIED), occ


def _check_against_scipy(types, occ):
    out = batch_edt(jnp.asarray(types), max_width=sum(types.shape))
    dist_sq = np.asarray(out["dist_sq"])
    coc = np.asarray(out["coc"])
    valid = np.asarray(out["valid"])

    if occ.any():
        ref = ndimage.distance_transform_edt(~occ)
        assert valid.all()
        np.testing.assert_allclose(np.sqrt(dist_sq), ref, rtol=0, atol=1e-5)
        # coc invariants: coc is an occupied voxel at exactly dist_sq away
        grid = np.stack(np.meshgrid(*[np.arange(s) for s in occ.shape], indexing="ij"), -1)
        d2 = ((grid - coc) ** 2).sum(-1)
        np.testing.assert_array_equal(d2, dist_sq)
        assert occ[coc[..., 0], coc[..., 1], coc[..., 2]].all()
    else:
        assert not valid.any()
        assert (dist_sq == EMPTY_VALUE).all()


def test_edt_empty(rng):
    types = np.zeros((12, 10, 6), np.int8)
    _check_against_scipy(types, types.astype(bool))


def test_edt_single_obstacle():
    types = np.zeros((16, 12, 8), np.int8)
    types[3, 4, 5] = VOX_OCCUPIED
    _check_against_scipy(types, types == VOX_OCCUPIED)


def test_edt_random_3d(rng):
    for p in (0.01, 0.1, 0.5):
        types, occ = _random_types(rng, (24, 20, 12), p)
        _check_against_scipy(types, occ)


def test_edt_random_2d(rng):
    types, occ = _random_types(rng, (32, 28, 1), 0.05)
    _check_against_scipy(types, occ)


def test_edt_full_occupied():
    types = np.full((8, 8, 4), VOX_OCCUPIED, np.int8)
    _check_against_scipy(types, types == VOX_OCCUPIED)


def test_edt_plane_obstacle():
    types = np.zeros((20, 20, 10), np.int8)
    types[:, :, 0] = VOX_OCCUPIED
    _check_against_scipy(types, types == VOX_OCCUPIED)


def test_lower_envelope_matches_bruteforce(rng):
    fsq = rng.integers(0, 100, size=(17, 5)).astype(np.int32)
    best, arg = lower_envelope(jnp.asarray(fsq))
    x = np.arange(17)[:, None, None]
    i = np.arange(17)[None, :, None]
    cand = (x - i) ** 2 + fsq[None, :, :]
    np.testing.assert_array_equal(np.asarray(best), cand.min(1))
    np.testing.assert_array_equal(np.asarray(arg), cand.argmin(1))


def test_batch_edt_zmajor_off_matches():
    """The legacy y-major lane ordering (zmajor=False A/B path) must stay
    equivalent to the default z-major path."""
    rng = np.random.default_rng(77)
    shape = (22, 18, 10)
    occ = rng.random(shape) < 0.05
    glb = jnp.asarray(np.where(occ, 2, 0).astype(np.int8))
    mw = sum(shape)
    a = batch_edt(glb, max_width=mw)
    b = batch_edt(glb, max_width=mw, zmajor=False)
    for k in ("dist_sq", "coc", "valid"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
