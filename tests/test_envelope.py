"""The EDT lower envelope (ops/edt_batch.lower_envelope) against numpy
brute force: dense and sparse site sets at site counts on both sides of the
packed key's index-bit boundaries, packed keys, ties and payload
selection."""
import jax.numpy as jnp
import numpy as np
import pytest

from gie_mapping_tpu.ops.edt_batch import env_idx_bits, lower_envelope

BIG = 1 << 28


def _brute(f, payloads=()):
    """(best, site, *payloads) by numpy: min over sites of the capped cost,
    ties to the smallest site."""
    n = f.shape[0]
    cap = (1 << (31 - env_idx_bits(n))) - 1
    x = np.arange(n).reshape((n, 1) + (1,) * (f.ndim - 1))
    i = np.arange(n).reshape((1, n) + (1,) * (f.ndim - 1))
    cand = np.minimum((x - i) ** 2 + np.minimum(f, cap)[None], cap)
    site = cand.argmin(1)  # first minimum = smallest index
    best = np.take_along_axis(cand, site[:, None], 1)[:, 0]
    return (best, site) + tuple(np.take_along_axis(p, site, 0)
                                for p in payloads)


def _sites(rng, shape, p_site):
    f = np.where(rng.random(shape) < p_site,
                 rng.integers(0, 400, shape), BIG).astype(np.int32)
    return f, rng.integers(0, 1 << 20, shape).astype(np.int32)


@pytest.mark.parametrize("shape", [(23, 6, 5), (16, 7, 3), (1, 4, 4)])
def test_lower_envelope_dense(shape):
    rng = np.random.default_rng(1)
    f, p = _sites(rng, shape, 0.8)
    got = lower_envelope(jnp.asarray(f), (jnp.asarray(p),))
    for g, w in zip(got, _brute(f, (p,))):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("n", [37, 128, 129])
def test_lower_envelope_sparse_multichunk(n):
    """Few sites, siteless lanes (all capped -> site 0)."""
    rng = np.random.default_rng(2)
    f, p = _sites(rng, (n, 40), 0.03)
    f[:, :4] = BIG
    got = lower_envelope(jnp.asarray(f), (jnp.asarray(p),))
    want = _brute(f, (p,))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert (np.asarray(got[1])[:, :4] == 0).all()


def test_lower_envelope_packed_matches_unpacked():
    rng = np.random.default_rng(3)
    f, p = _sites(rng, (30, 17), 0.2)
    ib = env_idx_bits(30)
    best, site, pay = lower_envelope(jnp.asarray(f), (jnp.asarray(p),))
    key, pay2 = lower_envelope(jnp.asarray(f), (jnp.asarray(p),),
                               packed_out=True)
    np.testing.assert_array_equal(np.asarray(key),
                                  (np.asarray(best) << ib) | np.asarray(site))
    np.testing.assert_array_equal(np.asarray(pay), np.asarray(pay2))


def test_lower_envelope_ties_take_the_smallest_site():
    """Two sites equidistant from x=2 (0 and 4, same cost) and equal costs
    everywhere: the smaller index wins every tie."""
    f = np.full((5, 3), BIG, np.int32)
    f[0], f[4] = 7, 7
    f[:, 2] = 5                                  # all sites tie on lane 2
    p = np.arange(15, dtype=np.int32).reshape(5, 3)
    best, site, pay = (np.asarray(a) for a in lower_envelope(
        jnp.asarray(f), (jnp.asarray(p),)))
    assert site[2, 0] == 0 and best[2, 0] == 4 + 7
    assert (site[:, 2] == np.arange(5)).all()  # own site: cost 5, dx 0
    np.testing.assert_array_equal(pay[:, 0], p[site[:, 0], 0])


def test_lower_envelope_matches_bruteforce_tail_shapes():
    rng = np.random.default_rng(4)
    f, p = _sites(rng, (9, 2, 3, 4), 0.5)
    got = lower_envelope(jnp.asarray(f), (jnp.asarray(p),))
    for g, w in zip(got, _brute(f, (p,))):
        np.testing.assert_array_equal(np.asarray(g), w)
