"""Exact 3-phase separable Euclidean distance transform with
closest-obstacle-coordinate (coc) tracking.

Dense redesign of the reference's batch local EDT
(/root/reference/src/kernel/edt/local_edt_core.h:14-193,
 src/kernel/edt/local_edt.cu:7-28):

* Phase 1 (along y) — the reference runs two serial per-column passes on the
  GPU.  Here it is two `lax.cummax`/`lax.cummin` scans (XLA parallel
  prefix), fully vectorised over all (x,z) lanes: the nearest occupied
  index at-or-below y IS the running cummax of `where(occ, y, -1)`, so no
  explicit loop survives.
* Phases 2/3 (lower envelope along x, then z) — the reference uses a serial
  Felzenszwalb parabola stack per line plus cuTT tensor transposes.  Here
  the exact envelope `min_i ((x-i)^2 + f(i))` is a dense min-reduction
  with no serial dependency: O(n^2) per line for n ~ 100-250, plain XLA on
  every platform (`lower_envelope`).  The cuTT transposes are XLA
  transposes.

The coc is carried exactly as in the reference (local_edt_core.h:116-134,
169-192): value and argmin come from ONE packed int32 key (cost << idx_bits
| site), unique per site, and each envelope pass co-selects its upstream
coc payload with the winning site.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
# "infinite" squared cost; safe from int32 overflow.  Deliberately a numpy
# scalar: a module-level jnp constant would initialise the JAX backend at
# import time (defeating later jax_platforms switches).
import numpy as _np

from ..utils.constants import EMPTY_VALUE, INVALID_COC, VOX_OCCUPIED
from . import backend

_BIG = _np.int32(1 << 28)


def phase1_fits(Y: int) -> bool:
    """True iff the packed phase-1 word has room: g1sq needs 2*yb bits,
    coc_y yb, valid 1 (Y <= 1024)."""
    yb = (Y - 1).bit_length() if Y > 1 else 1
    return 3 * yb + 1 <= 31


def phase1_pack_bits(Y: int) -> int:
    """yb such that packed = (g1sq << (yb+1)) | (coc_y << 1) | valid."""
    if not phase1_fits(Y):
        raise ValueError(f"phase-1 packing needs Y <= 1024, got {Y}")
    return (Y - 1).bit_length() if Y > 1 else 1


def _phase1_along_y(occ, max_width):
    """1-D distance-to-nearest-occupied along axis 1, with nearest index.

    Returns (g1, coc_y, valid): g1 int32 in [0, max_width], coc_y int32.
    Reference: EDTphase1 (local_edt_core.h:14-82); the tie at equal forward /
    backward distance resolves to the forward (lower-y) obstacle exactly as
    the reference's strict `<` comparison does (local_edt_core.h:69).
    """
    X, Y, Z = occ.shape
    y_idx = jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 1)
    big = jnp.int32(1 << 29)

    with jax.named_scope("edt_phase1"):
        last_le = jax.lax.cummax(jnp.where(occ, y_idx, -1), axis=1)
        next_ge = jax.lax.cummin(jnp.where(occ, y_idx, big), axis=1,
                                 reverse=True)

    d_fwd = jnp.where(last_le >= 0, y_idx - last_le, max_width)
    d_bwd = jnp.where(next_ge < big, next_ge - y_idx, max_width)

    g1 = jnp.minimum(jnp.minimum(d_fwd, d_bwd), max_width).astype(jnp.int32)
    coc_y = jnp.where(d_fwd <= d_bwd, last_le, next_ge).astype(jnp.int32)
    valid = g1 < max_width
    return g1, coc_y, valid


def phase1_packed(occ, max_width: int):
    """Phase 1 as ONE packed int32 word per voxel,

        packed = valid ? (g1^2 << (yb+1)) | (coc_y << 1) | 1 : 0,

    the representation of the merge's phase-1 cache (MapState.p1c,
    models/pipeline.py::_gated_canvas_merge).  g1^2 <= (Y-1)^2 < 2^(2*yb)
    always fits: valid implies a site in the column."""
    yb = phase1_pack_bits(occ.shape[1])
    g1, coc_y, valid = _phase1_along_y(occ, max_width)
    g1c = jnp.where(valid, g1, 0)
    cocc = jnp.where(valid, coc_y, 0)
    return jnp.where(valid, ((g1c * g1c) << (yb + 1)) | (cocc << 1) | 1, 0)


def _phase2_inputs(occ, max_width, p1_packed=None):
    """(site cost g1^2 or BIG, payload coc_y << 1 | valid), both [X,Y,Z],
    from a fresh phase 1 or from the packed cache word.  The two differ
    only in the payload of invalid voxels, which every consumer masks."""
    if p1_packed is not None:
        yb = phase1_pack_bits(occ.shape[1])
        return (jnp.where((p1_packed & 1) > 0, p1_packed >> (yb + 1), _BIG),
                p1_packed & ((1 << (yb + 1)) - 1))
    g1, coc_y1, valid1 = _phase1_along_y(occ, max_width)
    return (jnp.where(valid1, g1 * g1, _BIG),
            (coc_y1 << 1) | valid1.astype(jnp.int32))


def lower_envelope(fsq, payloads=(), packed_out: bool = False):
    """Exact lower envelope min_i ((x-i)^2 + fsq[i]) along axis 0.

    fsq: int32 [N, ...].  payloads: per-site int32 arrays [N, ...]; each
    returns the winning site's value (take_along_axis on the argmin).

    The minimum runs over ONE packed int32 key (cost << idx_bits | site),
    unique per site, so ties resolve to the smallest site index and value
    and argmin come from one reduction.  All output rows reduce at once;
    XLA fuses the reduction without materialising the [N, N, ...]
    candidates.

    Returns (best [N, ...], site [N, ...], *selected_payloads) — or, with
    packed_out, ((best << idx_bits | site), *selected_payloads).
    """
    N = fsq.shape[0]
    idx_bits = env_idx_bits(N)
    cap = (1 << (31 - idx_bits)) - 1
    i_idx = jnp.arange(N, dtype=jnp.int32)
    tail_shape = (1,) * (fsq.ndim - 1)
    i_b = i_idx.reshape((1, N) + tail_shape)
    dx = i_idx[:, None] - i_idx[None, :]
    dsq = (dx * dx).reshape((N, N) + tail_shape)
    cand = jnp.minimum(dsq + jnp.minimum(fsq, cap)[None], cap)
    key = jnp.min((cand << idx_bits) | i_b, axis=1)
    site = key & ((1 << idx_bits) - 1)
    outs = [key] if packed_out else [key >> idx_bits, site]
    for p in payloads:
        outs.append(jnp.take_along_axis(p, site, axis=0))
    return tuple(outs)


def env_idx_bits(n: int) -> int:
    """Site-index bit budget of the packed envelope key for an n-site axis —
    the single source of truth for the envelope and every packed-key
    consumer."""
    return (n - 1).bit_length() if n > 1 else 1


def _envelope(f, payload):
    """Packed envelope key and co-selected payload along axis 0."""
    backend.platform()  # refuse unsupported platforms at trace time
    with jax.named_scope("edt_envelope"):
        return lower_envelope(f, payloads=(payload,), packed_out=True)


def _edt_zmajor_core(occ, max_width: int, z_global: int, reshard1, reshard2,
                     p1_packed=None):
    """Phases 1-3 of the z-major EDT with pluggable phase-boundary reshards.

    reshard1: [Xl,Y,Z]-layout phase-1 output -> phase-2 [X,Zl,Y] layout
              (single device: transpose; sharded: transpose + all_to_all).
    reshard2: phase-2 [X,Zl,Y] output -> phase-3 [Z,Xl,Y] layout.
    `l` suffixes mark the axis a mesh may shard; z_global is the full Z
    extent (site axis of phase 3) for the coc_z bit budget.

    Returns (packed_c [Xl,Y,Z], pay3b [Xl,Y,Z], zbits): packed_c holds
    (dist << zbits+1 | coc_z << 1 | valid), pay3b (coc_x << 11 | coc_y << 1
    | valid)."""
    f1, pay1 = _phase2_inputs(occ, max_width, p1_packed)
    f2 = reshard1(f1)
    ib2 = env_idx_bits(f2.shape[0])
    pk2, pay2t = _envelope(f2, reshard1(pay1))
    d2t = pk2 >> ib2
    site2t = pk2 & ((1 << ib2) - 1)
    d2m = jnp.where((pay2t & 1) > 0, d2t, _BIG)        # [X,Zl,Y]
    pay3 = (site2t << 11) | pay2t
    zbits = (z_global - 1).bit_length() + 1
    f3 = reshard2(d2m)
    ib3 = env_idx_bits(f3.shape[0])
    pk3, pay3s = _envelope(f3, reshard2(pay3))
    d3, coc_z3 = pk3 >> ib3, pk3 & ((1 << ib3) - 1)
    d3c = jnp.minimum(d3, (1 << (30 - zbits)) - 1)
    packed_c = jnp.moveaxis(
        (d3c << (zbits + 1)) | (coc_z3 << 1) | (pay3s & 1), 0, 2)
    pay3b = jnp.moveaxis(pay3s, 0, 2)                  # [Xl,Y,Z]
    return packed_c, pay3b, zbits


def _edt_outputs(dist_sq, coc_x, coc_y, coc_z, valid):
    """{"dist_sq","coc","valid"} with EMPTY/INVALID where invalid."""
    dist_sq = jnp.where(valid, dist_sq, EMPTY_VALUE).astype(jnp.int32)
    inv = jnp.int32(INVALID_COC)
    coc = jnp.stack([jnp.where(valid, c, inv) for c in (coc_x, coc_y, coc_z)],
                    axis=-1)
    return {"dist_sq": dist_sq, "coc": coc, "valid": valid}


def _unpack_core(packed_c, pay3b, zbits):
    """_edt_zmajor_core's two packed words -> _edt_outputs."""
    return _edt_outputs(packed_c >> (zbits + 1),
                        pay3b >> 11,
                        (pay3b >> 1) & ((1 << 10) - 1),
                        (packed_c >> 1) & ((1 << zbits) - 1),
                        (packed_c & 1) > 0)


@partial(jax.jit, static_argnames=("max_width", "zmajor"))
def batch_edt(glb_type, max_width: int, zmajor: bool = True, p1_packed=None):
    """Batch local EDT over a dense grid.

    Args:
      glb_type: int8/int32 [X,Y,Z] voxel types; OCCUPIED voxels are sites.
      max_width: X+Y+Z 'infinite' 1-D distance (local_batch.h:46).
      zmajor: lane order of the phase-2/3 envelopes; False keeps the
        y-major layout (same outputs).
      p1_packed: optional precomputed packed phase-1 word [X,Y,Z]
        (phase1_packed / the merge's phase-1 cache) — must equal
        phase1_packed(glb_type == OCCUPIED); phase 1 is then skipped
        (zmajor 3-D path only; ignored in the 2-D/y-major layouts).

    Returns dict with:
      dist_sq: int32 [X,Y,Z] squared Euclidean distance (EMPTY_VALUE where no
               obstacle is reachable — matches the reference's "sees nothing"
               sentinel handling in MarkLimitedObserve,
               unify_helper.cuh:225-231).
      coc:     int32 [X,Y,Z,3] grid coordinate of the closest obstacle
               (INVALID_COC triple where invalid).
      valid:   bool [X,Y,Z].
    """
    occ = glb_type == VOX_OCCUPIED
    X, Y, Z = occ.shape

    # z-major lane order (z, y): the [X,Z,Y] layout is kept through the
    # phase-2/3 boundary, so [X,Z,Y] -> [Z,X,Y] is ONE transposed pass per
    # packed array, and the return to canvas layout packs (dist, coc_z,
    # valid) into one int32 (two passes, not three).
    if zmajor and Z > 1:
        return _unpack_core(*_edt_zmajor_core(
            occ, max_width, Z,
            reshard1=lambda a: jnp.transpose(a, (0, 2, 1)),
            reshard2=lambda a: jnp.moveaxis(a, 1, 0),
            p1_packed=p1_packed))

    tzy = (lambda a: jnp.transpose(a, (0, 2, 1))) if zmajor else (lambda a: a)
    g1sq, pay2 = _phase2_inputs(occ, max_width)
    f2 = tzy(g1sq)
    ib2 = env_idx_bits(f2.shape[0])
    pk2t, pay2t = _envelope(f2, tzy(pay2))
    d2t, site2t = pk2t >> ib2, pk2t & ((1 << ib2) - 1)
    d2, coc_x2, pay2s = tzy(d2t), tzy(site2t), tzy(pay2t)
    coc_y2 = pay2s >> 1
    valid2 = (pay2s & 1) > 0
    d2 = jnp.where(valid2, d2, _BIG)
    if Z == 1:
        return _edt_outputs(d2, coc_x2, coc_y2, jnp.zeros_like(coc_x2),
                            valid2)

    # ---- phase 3: lower envelope along z --------------------------------
    d2_z = jnp.moveaxis(d2, 2, 0)  # [Z,X,Y]
    pay3 = (
        (jnp.moveaxis(coc_x2, 2, 0) << 11)
        | (jnp.moveaxis(coc_y2, 2, 0) << 1)
        | jnp.moveaxis(valid2.astype(jnp.int32), 2, 0)
    )
    ib3 = env_idx_bits(d2_z.shape[0])
    pk3, pay3s = _envelope(d2_z, pay3)
    d3, coc_z3 = pk3 >> ib3, pk3 & ((1 << ib3) - 1)
    pay3b = jnp.moveaxis(pay3s, 0, 2)
    return _edt_outputs(jnp.moveaxis(d3, 0, 2), pay3b >> 11,
                        (pay3b >> 1) & ((1 << 10) - 1),
                        jnp.moveaxis(coc_z3, 0, 2), (pay3b & 1) > 0)


@partial(jax.jit, static_argnames=("sx", "sy", "max_width"))
def batch_edt_slab(glb_type, x0, y0, *, sx: int, sy: int, max_width: int,
                   p1_packed=None):
    """batch_edt restricted to the output slab [x0:x0+sx, y0:y0+sy, :].

    The change-gated merge (models/pipeline.py) recomputes the exact EDT
    only over the slab of voxels this frame's occupancy changes can affect.
    Sites are NEVER restricted — each phase scans a complete site axis —
    only the LANES are sliced, so slab outputs are bit-identical to the
    same voxels of a full batch_edt:

      phase 1 (scan along y)      full canvas        (sites for phase 2)
      phase 2 (envelope along x)  lanes (z, y-slab)  reads all x
      phase 3 (envelope along z)  lanes (x-slab, y-slab)  reads all z

    Phase-2/3 envelope traffic and the downstream merge selects then scale
    with the slab fraction instead of the canvas.

    Args:
      x0, y0: dynamic slab offsets (int32 scalars; caller clamps so the
        slab fits the canvas).  sx, sy: static slab extents.
      p1_packed: optional precomputed packed phase-1 word [X, Y, Z]
        (phase1_packed / the mapper's phase-1 cache, cfg.edt_p1_cache).
        Must equal phase1_packed(glb_type == OCCUPIED) — the caller owns
        that invariant; phase 1 is then skipped entirely and only the
        y-slab of the cache is read.
    Returns {"dist_sq","coc","valid"} shaped [sx, sy, Z] (coc values are
    CANVAS coordinates, exactly as batch_edt returns them).
    """
    occ = glb_type == VOX_OCCUPIED
    X, Y, Z = occ.shape
    if Z <= 1:
        raise ValueError("batch_edt_slab requires a 3-D canvas (Z > 1)")

    x0 = jnp.asarray(x0, jnp.int32)
    y0 = jnp.asarray(y0, jnp.int32)
    ysl = lambda a: jax.lax.dynamic_slice(a, (0, y0, 0), (X, sy, Z))
    tzy = lambda a: jnp.transpose(a, (0, 2, 1))

    # ---- phase 1: full canvas (or the cache); slice the y lanes ---------
    if p1_packed is not None:
        # the cache is sliced BEFORE the unpack, so phase 1's inputs are
        # read only over the y-slab
        f2, pay2 = _phase2_inputs(occ, max_width, tzy(ysl(p1_packed)))
    else:
        g1sq, pay2 = _phase2_inputs(occ, max_width)
        f2, pay2 = tzy(ysl(g1sq)), tzy(ysl(pay2))   # [X, Z, sy]
    ib2 = env_idx_bits(X)
    pk2, pay2t = _envelope(f2, pay2)
    d2t = pk2 >> ib2
    site2t = pk2 & ((1 << ib2) - 1)
    d2m = jnp.where((pay2t & 1) > 0, d2t, _BIG)     # [X, Z, sy]
    pay3 = (site2t << 11) | pay2t

    # ---- phase 3: slice the x lanes; sites = all z -----------------------
    xsl = lambda a: jax.lax.dynamic_slice(a, (x0, 0, 0), (sx, Z, sy))
    mvz = lambda a: jnp.moveaxis(a, 1, 0)           # [Z, sx, sy]
    ib3 = env_idx_bits(Z)
    pk3z, pay3z = _envelope(mvz(xsl(d2m)), mvz(xsl(pay3)))

    # ---- slab layout [sx, sy, Z] -----------------------------------------
    t_out = lambda a: jnp.transpose(jnp.moveaxis(a, 0, 1), (0, 2, 1))
    pk3 = t_out(pk3z)
    pay3b = t_out(pay3z)
    return _edt_outputs(pk3 >> ib3, pay3b >> 11,
                        (pay3b >> 1) & ((1 << 10) - 1),
                        pk3 & ((1 << ib3) - 1), (pay3b & 1) > 0)


def sharded_edt_ok(shape, mesh) -> bool:
    """Whether batch_edt_sharded supports this (shape, mesh)."""
    if mesh is None:
        return False
    X, Y, Z = shape
    n = mesh.size
    return n > 1 and Z > 1 and X % n == 0 and Z % n == 0


def _sharded_core(occ, y0, mesh, *, sy, max_width):
    """shard_map of _edt_zmajor_core over an x-sharded canvas: the two
    phase boundaries are all_to_all reshards; y0 (None = all of y) slices
    the y lanes before the first one."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import MESH_AXIS

    Z = occ.shape[2]

    def body(occ_l, y0_l):
        Xl = occ_l.shape[0]
        a2a = lambda a: jax.lax.all_to_all(a, MESH_AXIS, 1, 0, tiled=True)
        ysl = lambda a: jax.lax.dynamic_slice(a, (0, y0_l[0], 0),
                                              (Xl, sy, Z))
        packed_c, pay3b, _ = _edt_zmajor_core(
            occ_l, max_width, Z,
            reshard1=lambda a: a2a(jnp.transpose(ysl(a), (0, 2, 1))),
            reshard2=lambda a: a2a(jnp.moveaxis(a, 1, 0)))
        return packed_c, pay3b

    packed_c, pay3b = jax.shard_map(
        body, mesh=mesh, in_specs=(P(MESH_AXIS), P()),
        out_specs=P(MESH_AXIS),
    )(occ, jnp.broadcast_to(jnp.asarray(y0, jnp.int32), (1,)))
    return _unpack_core(packed_c, pay3b, (Z - 1).bit_length() + 1)


@partial(jax.jit, static_argnames=("sy", "max_width", "mesh"))
def batch_edt_sharded_slab(glb_type, y0, *, sy: int, max_width: int, mesh):
    """batch_edt_sharded restricted to the y-slab [y0:y0+sy] (all x, all z).

    The sharded change-gate slices ONLY the y lanes: x is the mesh-sharded
    axis (slicing it dynamically would fight GSPMD) and z is a site axis.
    Phase 1 runs on the full x-shard; the y-slice happens BEFORE the first
    all_to_all, so both reshards move sy/Y of the bytes; phases 2/3 run on
    (z, y-slab) / (x-shard, y-slab) lanes with complete site axes — slab
    outputs bit-identical to batch_edt_sharded's
    (tests/test_multichip.py::test_sharded_gate_matches_single_device).

    Returns {"dist_sq","coc","valid"} shaped [X, sy, Z], x-sharded."""
    return _sharded_core(glb_type == VOX_OCCUPIED, y0, mesh, sy=sy,
                         max_width=max_width)


@partial(jax.jit, static_argnames=("max_width", "mesh"))
def batch_edt_sharded(glb_type, max_width: int, mesh):
    """batch_edt over a canvas sharded along x on a 1-D device mesh.

    Distributed separable-transform layout (the classic sharded-FFT recipe,
    SURVEY.md §2 P9): every phase scans an axis that is locally complete, and
    the two phase boundaries are explicit `all_to_all` reshards — phase 1
    (scan along y) runs on the x-sharded canvas, phase 2 (envelope along x)
    on a z-sharded layout, phase 3 (envelope along z) on an x-sharded layout
    again, which is exactly the canvas sharding the merge pipeline needs
    downstream (no final collective).  Per-device compute is the SAME
    envelope as the single-device path (shard_map hands it local shards),
    and results are bit-identical to batch_edt (tests/test_multichip.py).

    Requires X and Z divisible by mesh.size (sharded_edt_ok); callers fall
    back to batch_edt otherwise.
    """
    occ = glb_type == VOX_OCCUPIED
    return _sharded_core(occ, 0, mesh, sy=occ.shape[1],
                         max_width=max_width)
