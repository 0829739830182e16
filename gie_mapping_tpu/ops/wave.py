"""Incremental global EDT: reconciliation + masked fixed-point relaxation.

Dense redesign of the reference's three level-synchronous BFS wavefronts
(raise_outside / lower_outside / lower_inside,
/root/reference/src/kernel/par_wave/wave_core.cuh:103-393, wave_helper.h:8-93)
and their seeding/merge kernels (unify_helper.cuh:201-523):

* The hierarchical shared-memory queues, gray-shade dedup and 64-bit packed
  atomic arg-min disappear entirely.  The equivalent fixed point is computed
  by repeated dense 6-neighbour (dist, coc) min-relaxation over the "canvas"
  (window + cutoff halo) inside `lax.while_loop`, converging when one sweep
  changes nothing (`psum`-able on a mesh) — SURVEY.md §2 P3/P4.
* raise_outside (obstacle disappeared) becomes a dense coc-equality flood
  over the stale coc field — the reference's own propagation rule
  (neighbour raises iff it stores the SAME dead obstacle,
  wave_core.cuh:172-194) applied as shift-compare sweeps, entirely
  gather-free; raised voxels are reset to "unseen" and re-lowered by the
  relaxation together with everything else.
* The per-level host readbacks of frontier counts (wave_helper.h:23,82) are
  gone: convergence is an on-device reduction, the whole merge is one XLA
  program.

Closest-obstacle coordinates are int16 CANVAS-RELATIVE voxel coordinates
(anchored at the canvas origin and re-anchored on scroll by the caller —
see map_state.scroll_canvas; sentinel COC_INVALID16); distances stay int32 squared
grid units.

Divergences (documented): invalidated voxels that no valid obstacle
re-reaches are stored as "unseen" (EMPTY/INVALID) rather than keeping the
raising neighbour's interim candidate; and relaxation runs to a *joint*
in/out fixed point, which is at least as converged as the reference's single
A->B->C pass.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import geometry as geo
from ..utils.constants import EMPTY_VALUE, VOX_OCCUPIED, VOX_UNKNOWN

COC_INVALID16 = np.int16(32767)


def _shift_fill(arr, axis, sign, fill):
    """Shift `arr` by one voxel along `axis` (sign=+1 brings the neighbour at
    +axis into each cell), filling the exposed face with `fill`."""
    pad = [(0, 0)] * arr.ndim
    if sign > 0:
        pad[axis] = (0, 1)
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(1, None)
    else:
        pad[axis] = (1, 0)
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, arr.shape[axis])
    return jnp.pad(arr, pad, constant_values=fill)[tuple(sl)]


def reconcile_window(batch, canvas_dist_win, canvas_coc_win, glb_type,
                     win_off, local_size):
    """MarkLimitedObserve semantics (unify_helper.cuh:201-273).

    Fresh batch-EDT values replace stored global values except when the new
    value only got *worse* because the true closest obstacle lies outside the
    local window ("limited observation") — then the stored value survives.

    Returns (seed_dist int32 [X,Y,Z], seed_coc int16 [X,Y,Z,3]
    canvas-relative) for the window, with EMPTY/INVALID where the voxel is
    unobserved or sees nothing.  win_off is the window offset inside the
    canvas (the coc anchor conversion window-local <-> canvas-relative).
    """
    observed = glb_type != VOX_UNKNOWN
    valid_new = batch["valid"]
    dist_new = jnp.where(valid_new, batch["dist_sq"], EMPTY_VALUE)
    coc_new = jnp.where(
        valid_new[..., None], (batch["coc"] + win_off).astype(jnp.int16),
        COC_INVALID16
    )

    dist_old = canvas_dist_win
    coc_old = canvas_coc_win
    old_valid = coc_old[..., 0] != COC_INVALID16
    coc_old_loc = coc_old.astype(jnp.int32) - win_off
    old_in_loc = geo.inside_volume(coc_old_loc, jnp.asarray(local_size, jnp.int32)) & old_valid

    limited = (dist_new > dist_old) & ~old_in_loc & old_valid
    dist_sel = jnp.where(limited, dist_old, dist_new)
    coc_sel = jnp.where(limited[..., None], coc_old, coc_new)

    seed_dist = jnp.where(observed, dist_sel, EMPTY_VALUE).astype(jnp.int32)
    seed_coc = jnp.where(observed[..., None], coc_sel, COC_INVALID16)
    return seed_dist, seed_coc


def invalidate_disappeared(dist, coc, outside_mask, stale_coc, dead_win,
                           win_off, *, max_sweeps: int,
                           sweeps_per_check: int = 4):
    """raise_outside as a dense coc-equality wave (wave_core.cuh:103-224).

    The reference raises a node and propagates to any neighbour whose stored
    closest obstacle is the SAME disappeared site (wave_core.cuh:172-194).
    That is exactly a flood over the stale coc field: seed at the dead sites'
    own voxels, and each sweep extends the raised set to 6-neighbours whose
    stale coc equals the raised voxel's.  This keeps the raise pass entirely
    gather-free (no per-voxel `glb_type[coc[v]]` lookup).  Faithfulness note: like the reference's wave (and unlike
    the old one-shot lookup), only stale-coc-CONNECTED voxels are reached;
    disconnected fragments of a dead site's discrete Voronoi cell keep their
    stale value until re-lowered.

    Args:
      dist/coc: canvas arrays (window already re-seeded; outside stale).
      outside_mask: bool canvas — voxels eligible for invalidation.
      stale_coc: int16 canvas coc field BEFORE window re-seeding (the wave
                 must cross the window boundary on stale pointers).
      dead_win: bool [local] — window voxels occupied before, not now.
      max_sweeps: static propagation bound (>= raise region diameter).

    Returns (dist, coc, inval_mask).
    """
    canvas_size = dist.shape
    dead_canvas = jax.lax.dynamic_update_slice(
        jnp.zeros(canvas_size, jnp.bool_), dead_win,
        (win_off[0], win_off[1], win_off[2]))
    coc_valid = stale_coc[..., 0] != COC_INVALID16

    # the coc-equality masks are loop-invariant: compute the six bool
    # canvases once so each sweep is 6 bool shift+and+or passes instead of
    # re-shifting/comparing the int16x3 coc field every iteration
    dirs = []
    for axis in range(3):
        for sign in (1, -1):
            n_c = _shift_fill(stale_coc, axis, sign, COC_INVALID16)
            same = jnp.all(stale_coc == n_c, axis=-1) & coc_valid
            dirs.append((axis, sign, same))

    def sweep(raised):
        out = raised
        for axis, sign, same in dirs:
            out = out | (_shift_fill(raised, axis, sign, False) & same)
        return out

    def body(state):
        raised, it, _ = state
        new = raised
        for _ in range(sweeps_per_check):
            new = sweep(new)
        return new, it + sweeps_per_check, jnp.any(new != raised)

    def cond(state):
        _, it, changed = state
        return changed & (it < max_sweeps)

    raised, _, _ = jax.lax.while_loop(
        cond, body, (dead_canvas, jnp.int32(0), jnp.bool_(True)))

    # outside voxels are invalidated in the working arrays (the window part
    # already holds this frame's fresh seeds); the caller must ALSO apply
    # `raised` to whatever old values its write-back gating can resurrect —
    # the reference's wave mutates the hash in place, so raised in-window
    # voxels without a fresh valid pair stay raised (wave_core.cuh:196-212)
    inval = raised & outside_mask
    dist = jnp.where(inval, EMPTY_VALUE, dist)
    coc = jnp.where(inval[..., None], COC_INVALID16, coc)
    return dist, coc, raised


@partial(jax.jit, static_argnames=("canvas_size", "max_iters", "cutoff_sq",
                                   "sweeps_per_check"))
def relax_fixed_point(dist, coc, can_update, outside_observed, window_mask,
                      *, canvas_size, cutoff_sq: int,
                      max_iters: int, sweeps_per_check: int = 4):
    """Masked 6-neighbour (dist, coc) min-relaxation to fixed point.

    Each sweep: every updatable voxel v considers, for each of its 6
    neighbours u that may act as a source, the exact squared Euclidean
    distance from u's closest obstacle to v, and keeps the minimum if it
    improves.  Repeating to fixed point yields exactly the limit the
    reference's lower_in/lower_out BFS converges to (same relaxation operator,
    exhaustively applied); the cutoff gates *expansion from* a voxel the same
    way the early-return does (wave_core.cuh:125-126,259-262).

    `sweeps_per_check` sweeps run between convergence reductions to amortise
    the while_loop condition.

    Returns (dist, coc, n_sweeps_upper_bound).  Cocs are canvas-relative, so
    voxel positions are plain canvas iotas (squared distances are
    shift-invariant).
    """
    gx = jax.lax.broadcasted_iota(jnp.int32, canvas_size, 0)
    gy = jax.lax.broadcasted_iota(jnp.int32, canvas_size, 1)
    gz = jax.lax.broadcasted_iota(jnp.int32, canvas_size, 2)

    def sweep(dist, coc):
        src_ok = (coc[..., 0] != COC_INVALID16) & (
            window_mask | (outside_observed & (dist <= cutoff_sq))
        )
        best_d = dist
        best_c = coc
        for axis in range(3):
            for sign in (1, -1):
                n_coc = _shift_fill(coc, axis, sign, COC_INVALID16)
                n_src = _shift_fill(src_ok, axis, sign, False)
                valid = n_src & (n_coc[..., 0] != COC_INVALID16)
                cx = jnp.where(valid, n_coc[..., 0].astype(jnp.int32), gx)
                cy = jnp.where(valid, n_coc[..., 1].astype(jnp.int32), gy)
                cz = jnp.where(valid, n_coc[..., 2].astype(jnp.int32), gz)
                dx, dy, dz = gx - cx, gy - cy, gz - cz
                cand = jnp.where(valid, dx * dx + dy * dy + dz * dz, EMPTY_VALUE)
                better = cand < best_d
                best_d = jnp.where(better, cand, best_d)
                best_c = jnp.where(better[..., None], n_coc, best_c)
        improve = (best_d < dist) & can_update
        return (
            jnp.where(improve, best_d, dist),
            jnp.where(improve[..., None], best_c, coc),
            jnp.any(improve),
        )

    def body(state):
        dist, coc, it, _ = state
        changed = jnp.bool_(False)
        for _ in range(sweeps_per_check):
            dist, coc, ch = sweep(dist, coc)
            changed |= ch
        return dist, coc, it + sweeps_per_check, changed

    def cond(state):
        _, _, it, changed = state
        return changed & (it < max_iters)

    dist, coc, iters, _ = jax.lax.while_loop(
        cond, body, (dist, coc, jnp.int32(0), jnp.bool_(True))
    )
    return dist, coc, iters


def mark_frontiers(canvas_vox_type, glb_type, win_off, local_size):
    """Exploration-frontier (VOXTYPE_FNT) extraction
    (unify_helper.cuh:441-444): FREE window voxels with an UNKNOWN 6-neighbour
    (absent blocks and beyond-canvas count as unknown).

    Works on a window+1-halo slice instead of dilating the full canvas: only
    the window's 6-neighbourhood can contribute, so this touches ~(L+2)^3
    voxels instead of the whole canvas (6x less traffic at cow-lady scale).
    The slice start is clamped into the canvas; a slice face can only lose
    its real halo when it coincides with a canvas face, where the shift's
    unknown-fill is exactly the beyond-canvas semantics."""
    from ..utils.constants import VOX_FREE, VOX_FNT

    cs = canvas_vox_type.shape
    ext = tuple(min(l + 2, c) for l, c in zip(local_size, cs))
    starts = [jnp.clip(win_off[a] - 1, 0, cs[a] - ext[a]) for a in range(3)]
    rel = [win_off[a] - starts[a] for a in range(3)]
    sl = jax.lax.dynamic_slice(canvas_vox_type, starts, ext)
    unknown = sl == VOX_UNKNOWN
    nbr_unknown = jnp.zeros_like(unknown)
    for axis in range(3):
        for sign in (1, -1):
            nbr_unknown |= _shift_fill(unknown, axis, sign, True)
    nbr_win = jax.lax.dynamic_slice(nbr_unknown, rel, local_size)
    fnt = (glb_type == VOX_FREE) & nbr_win
    return jnp.where(fnt, VOX_FNT, glb_type).astype(jnp.int8), fnt
