"""The jitted per-frame map-update pipeline (resident-canvas architecture).

Equivalent of the reference's publishMap hot path
(/root/reference/src/volumetric_mapper.cpp:138-224): one XLA program per frame
covering canvas scrolling, block allocation, occupancy fusion, batch local
EDT, reconciliation, raise/lower fixed-point relaxation, frontier extraction
and changed-block tracking — where the reference issues dozens of kernel
launches with per-level host readbacks (wave_helper.h:23,82), this dispatches
once and converges on-device.

The global map lives as a resident dense canvas (window + cutoff halo) that
scrolls with the robot, plus a block archive for regions that scroll out
(map_state.MapState) — the dense, lock-free replacement for the reference's
voxel-block hash map.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..map_state import MapState, scroll_canvas
from ..ops.edt_batch import batch_edt
from ..ops.fusion import _fence_mask, _lowpass
from ..ops.wave import (
    COC_INVALID16,
    invalidate_disappeared,
    mark_frontiers,
    reconcile_window,
    relax_fixed_point,
)
from ..utils import geometry as geo
from ..utils import constants as _c
from ..utils.config import MapConfig
from ..utils.constants import (
    EMPTY_VALUE,
    VB_WIDTH,
    VOX_FNT,
    VOX_FREE,
    VOX_UNKNOWN,
)


# depthcam-class steady slabs need 0.22-0.28 of the canvas (the 5/16 rung);
# cow-class ~0.58-0.60 (the 5/8 rung)
DEFAULT_MENU_FRACS = ((3, 16), (5, 16), (3, 8), (5, 8))


def _slab_menu(canvas_size, fracs=DEFAULT_MENU_FRACS):
    """Static (SX, SY) slab-size ladder for the change-gated EDT: ~3/16,
    5/16, 3/8 and 5/8 of the canvas per axis (multiples of 8, ascending).
    The fractions come from measured affected-slab distributions:
    depthcam-class frames need ~0.25-0.30,
    cow-class steady state ~0.58-0.60; anything larger takes the full
    branch.  `fracs` is overridable per config (cfg.edt_gate_menu)."""
    X, Y, _ = canvas_size
    r8 = lambda v, n: min(-(-v // 8) * 8, n)
    menu = []
    for num, den in fracs:
        sx, sy = r8(X * num // den, X), r8(Y * num // den, Y)
        if (sx, sy) not in menu and sx < X and sy < Y:
            menu.append((sx, sy))
    return menu


def _menu_fracs(cfg):
    return cfg.edt_gate_menu or DEFAULT_MENU_FRACS


def p1_cache_enabled(cfg) -> bool:
    """Whether this config maintains the phase-1 cache (MapState.p1c): the
    gated canvas EDT must be active and the packed phase-1 word must fit.
    Single source of truth for MapState.create's buffer sizing AND the
    merge's use — a mesh additionally disables USE at merge time (the canvas
    x axis is sharded; the cache path is single-device)."""
    from ..ops.edt_batch import phase1_fits

    X, Y, Z = cfg.canvas_size
    return (cfg.merge_mode == "canvas_edt" and cfg.edt_gate
            and cfg.edt_p1_cache and Z > 1
            and bool(_slab_menu(cfg.canvas_size, _menu_fracs(cfg)))
            and X * Y * Z >= cfg.edt_gate_min_vox and phase1_fits(Y))


def _axis_lohi(mask1d, n):
    """(first, last) true index of a bool [n] (sentinels (n, -1) if none)."""
    idx = jnp.arange(n, dtype=jnp.int32)
    lo = jnp.min(jnp.where(mask1d, idx, n))
    hi = jnp.max(jnp.where(mask1d, idx, -1))
    return lo, hi


def _gated_canvas_merge(state, canvas_type, old_type, new_type_win,
                        old_type_win, win_off, window_mask,
                        present_blk, enter_shift, *, cfg: MapConfig,
                        mesh=None, emit_outputs=True):
    """Change-gated exact canvas EDT (round 3, VERDICT r2 item 1).

    Per frame, the set of voxels whose stored (dist, coc) can differ from
    the previous frame's is bounded by the AFFECTED REGION

        aff = chg  ∪  { v observed : box_dist²(v, Δboxes) <= state.dist²(v) }

    where chg = this frame's occupancy-type flips (site appears/disappears,
    UNKNOWN transitions — all inside the window) and Δboxes = the bbox of
    the site flips plus the slabs entering on a scroll.  Proof sketch (the
    full case analysis lives in tests/test_edt_gate.py's property tests):
    a new site can only improve v if it is closer than v's stored value;
    a removed site only affects v if it WAS v's closest (distance = stored
    value); stored values are exact-or-kept-memory by induction; the one
    exception — observed voxels whose stored pair went stale through a
    zero-site epoch — forces the full branch (any-site guard below).

    The exact EDT then recomputes only the bounding slab of `aff`
    (batch_edt_slab: lanes sliced, sites complete — bit-identical on the
    slab), splicing unchanged state through with an in-place
    dynamic_update_slice; a lax.switch picks the smallest static slab from
    _slab_menu that covers it (full recompute otherwise).  All outputs are
    bit-identical to the ungated path (tests/test_edt_gate.py).

    Matches the reference's incremental property — wavefronts touch only
    frontier-reachable voxels (glb_hash_map.cu:146-207) — at the batch
    EDT's exactness (local_edt_core.h:14-193).

    Under a mesh the slab restricts ONLY the y lanes (x is the sharded
    axis, z a site axis): batch_edt_sharded_slab halves nothing in x but
    both all_to_all reshards and phases 2/3 scale with sy/Y.

    Returns (final_dist, final_coc, dist_win, coc_win, changed_blk_dist,
    gate_level, slab_vox)."""
    from ..ops.edt_batch import (batch_edt, batch_edt_slab,
                                 batch_edt_sharded, batch_edt_sharded_slab)
    from ..utils.constants import VOX_OCCUPIED

    canvas_size = cfg.canvas_size
    local_size = cfg.local_size
    X, Y, Z = canvas_size
    cs_arr = jnp.asarray(canvas_size, jnp.int32)
    if mesh is None:
        menu = _slab_menu(canvas_size, _menu_fracs(cfg))
    else:
        menu = [(X, sy) for _, sy in _slab_menu(canvas_size, _menu_fracs(cfg))]
    n_menu = len(menu)

    # ---- Δ: occupancy flips + UNKNOWN transitions (window-sized) ---------
    site_flip = (old_type_win == VOX_OCCUPIED) != (new_type_win == VOX_OCCUPIED)
    unk_flip = (old_type_win == VOX_UNKNOWN) != (new_type_win == VOX_UNKNOWN)
    chg = site_flip | unk_flip

    # site-flip bbox (canvas coords); dead box when no flips
    flo, fhi = [], []
    for a in range(3):
        ax = tuple(i for i in range(3) if i != a)
        lo, hi = _axis_lohi(jnp.any(site_flip, axis=ax), local_size[a])
        flo.append(lo + win_off[a])
        fhi.append(hi + win_off[a])
    boxes_lo = [jnp.stack(flo)]
    boxes_hi = [jnp.stack(fhi)]
    boxes_dead = [~jnp.any(site_flip)]

    # entering slabs on scroll frames (geometric: positions re-entering the
    # canvas — covers restored-archive sites AND re-entering stale cocs)
    for a in range(3):
        s = enter_shift[a]
        lo = jnp.asarray([0, 0, 0], jnp.int32).at[a].set(
            jnp.where(s > 0, cs_arr[a] - s, 0))
        hi = (cs_arr - 1).at[a].set(
            jnp.where(s > 0, cs_arr[a] - 1, -s - 1))
        boxes_lo.append(lo)
        boxes_hi.append(hi)
        boxes_dead.append(s == 0)

    # EXITING slabs too (their position in NEW canvas coords lies just
    # beyond the edge): a site that scrolls out is a REMOVED site for every
    # voxel that stored it as coc.  Strict worsenings keep the old pair
    # anyway (keep_old limited-observation memory — dist_state < new_dist),
    # but an exact distance TIE with a surviving in-canvas site takes the
    # NEW coc in the ungated path, so those voxels must be recomputed
    # (found by an unaligned-pivot fuzz: 9 stale coc voxels on a
    # [-1,+1,0]-scroll frame).
    for a in range(3):
        s = enter_shift[a]
        lo = jnp.asarray([0, 0, 0], jnp.int32).at[a].set(
            jnp.where(s > 0, -s, cs_arr[a]))
        hi = (cs_arr - 1).at[a].set(
            jnp.where(s > 0, -1, cs_arr[a] - s - 1))
        boxes_lo.append(lo)
        boxes_hi.append(hi)
        boxes_dead.append(s == 0)

    # ---- P pass ----------------------------------------------------------
    # "voxel": one fused full-canvas read of dist_sq (+ the type read shared
    # with fusion).  "block": the same box-distance test against the
    # maintained per-cell (4^3) dist bound (MapState.dmax_cell) — no
    # full-canvas read at all; conservative by at most one cell diameter
    # per axis, so the slab can only grow and outputs stay bit-identical.
    big = jnp.int32(1 << 30)

    def _box_dist_sq(axis_idx):
        """min-over-boxes squared box distance on the given per-axis index
        ranges: axis_idx[a] = (lo_idx, hi_idx) voxel spans per element."""
        out = None
        for lo, hi, dead in zip(boxes_lo, boxes_hi, boxes_dead):
            parts = []
            for a, n in enumerate(canvas_size):
                ilo, ihi = axis_idx[a]
                d = jnp.maximum(jnp.maximum(lo[a] - ihi, ilo - hi[a]), 0)
                d = jnp.minimum(d, jnp.int32(n))  # dead-box sentinel safety
                parts.append(d * d)
            b = (parts[0][:, None, None] + parts[1][None, :, None]
                 + parts[2][None, None, :])
            b = jnp.where(dead, big, b)
            out = b if out is None else jnp.minimum(out, b)
        return out

    # zero-site epochs invalidate the induction (stored pairs survive the
    # no-obstacle frames unrefreshed): force the full branch around them
    # (the any-reduces fuse into the canvas_type uncrop write).  Round 5
    # splits the epoch itself from its exit: while the canvas has NO sites
    # at all, the exact EDT output is a constant (no envelope can find a
    # site), so those frames take a dedicated constant-fill branch instead
    # of paying the full sweeps — the genuine full recompute happens only
    # on the single frame where sites REappear after an epoch (without it,
    # a jump into open space made EVERY subsequent frame pay the full EDT
    # until an obstacle was seen).
    any_site_new = jnp.any(canvas_type == VOX_OCCUPIED)
    any_site_old = jnp.any(old_type == VOX_OCCUPIED)
    force_full = ~(any_site_new & any_site_old)
    zero_now = ~any_site_new

    G = 4  # dmax_cell granularity (see MapState.dmax_cell)
    if cfg.edt_gate_pmode == "block":
        cgrid = tuple(c // G for c in canvas_size)
        cidx = [(jnp.arange(n, dtype=jnp.int32) * G,
                 jnp.arange(n, dtype=jnp.int32) * G + (G - 1)) for n in cgrid]
        P_cell = _box_dist_sq(cidx) <= state.dmax_cell
        if cfg.fast_mode:
            # fast_mode write-back is window-gated: only cells overlapping
            # the window can change
            ov = []
            for a, n in enumerate(cgrid):
                clo, chi_ = cidx[a]
                ov.append((clo <= win_off[a] + local_size[a] - 1)
                          & (chi_ >= win_off[a]))
            P_cell = (P_cell & ov[0][:, None, None] & ov[1][None, :, None]
                      & ov[2][None, None, :])
        bx_lo, bx_hi = _axis_lohi(jnp.any(P_cell, axis=(1, 2)), cgrid[0])
        by_lo, by_hi = _axis_lohi(jnp.any(P_cell, axis=(0, 2)), cgrid[1])
        # chg lives in the window: union its (window-reduce) bbox in
        cx_lo, cx_hi = _axis_lohi(jnp.any(chg, axis=(1, 2)), local_size[0])
        cy_lo, cy_hi = _axis_lohi(jnp.any(chg, axis=(0, 2)), local_size[1])
        x0 = jnp.minimum(bx_lo * G, cx_lo + win_off[0])
        x1 = jnp.maximum(bx_hi * G + (G - 1), cx_hi + win_off[0])
        y0 = jnp.minimum(by_lo * G, cy_lo + win_off[1])
        y1 = jnp.maximum(by_hi * G + (G - 1), cy_hi + win_off[1])
    else:
        vidx = [(jnp.arange(n, dtype=jnp.int32),) * 2 for n in canvas_size]
        bd = _box_dist_sq(vidx)
        observed_canvas = canvas_type != VOX_UNKNOWN
        P = observed_canvas & (bd <= state.dist_sq)
        if cfg.fast_mode:
            # fast_mode write-back is window-gated (reference lower_inside is
            # window-bounded): out-of-window voxels never change
            P = P & window_mask
        aff = P | _uncrop(jnp.zeros(canvas_size, jnp.bool_), chg, win_off)
        x0, x1 = _axis_lohi(jnp.any(aff, axis=(1, 2)), X)
        y0, y1 = _axis_lohi(jnp.any(aff, axis=(0, 2)), Y)
    # the branches snap the slab offset DOWN to a multiple of 8
    # (ox = clip(x0//8*8, 0, X-SX)), so the fit test must cover the bbox
    # from the SNAPPED start — ignoring the up-to-7-voxel slack let
    # unaligned window pivots leave affected voxels outside the slab
    # (silent divergence from the ungated path; caught by the
    # unaligned-pivot fuzz in tests/test_edt_gate.py)
    need_x = jnp.maximum(x1 - x0 // 8 * 8 + 1, 0)
    need_y = jnp.maximum(y1 - y0 // 8 * 8 + 1, 0)

    sel = jnp.int32(n_menu)  # full
    for k in range(n_menu - 1, -1, -1):
        fits = (need_x <= menu[k][0]) & (need_y <= menu[k][1])
        sel = jnp.where(fits, jnp.int32(k), sel)
    sel = jnp.where(force_full, jnp.int32(n_menu), sel)
    sel = jnp.where(zero_now, jnp.int32(n_menu + 1), sel)  # constant fill

    # ---- phase-1 cache update (cfg.edt_p1_cache) -------------------------
    # Sites change only inside the site-flip x-bbox on non-scroll frames
    # (fusion writes the window; FNT marks never touch OCCUPIED), so the
    # cached packed phase-1 word is patched over the covering x-slab; any
    # scroll clears p1c_ok (_do_scroll — the y site axis shifted) and the
    # full branch below rebuilds it.  Validity is INDEPENDENT of the EDT
    # slab choice: even force-full frames leave the patched cache exact.
    use_p1c = p1_cache_enabled(cfg) and mesh is None
    p1c_new = state.p1c
    if use_p1c:
        from ..ops.edt_batch import phase1_packed

        mw = sum(canvas_size)
        fx_menu = [sx for sx, _ in _slab_menu(canvas_size, _menu_fracs(cfg))]
        # cover from the SNAPPED patch start (o = clip(flo//8*8, ...)):
        # same alignment slack as the slab fit above
        pneed = jnp.maximum(fhi[0] - flo[0] // 8 * 8 + 1, 0)
        psel = jnp.int32(len(fx_menu))
        for k in range(len(fx_menu) - 1, -1, -1):
            psel = jnp.where(pneed <= fx_menu[k], jnp.int32(k), psel)
        psel = jnp.where(state.p1c_ok, psel, jnp.int32(len(fx_menu)))

        def mk_patch(FX):
            def br(p1ops):
                p1c, ct = p1ops
                o = jnp.clip(flo[0] // 8 * 8, 0, X - FX)
                occ_s = jax.lax.dynamic_slice(
                    ct, (o, 0, 0), (FX, Y, Z)) == VOX_OCCUPIED
                return jax.lax.dynamic_update_slice(
                    p1c, phase1_packed(occ_s, mw), (o, 0, 0))
            return br

        def full_p1(p1ops):
            _p1c, ct = p1ops
            return phase1_packed(ct == VOX_OCCUPIED, mw)

        p1c_new = jax.lax.switch(
            psel, [mk_patch(f) for f in fx_menu] + [full_p1],
            (state.p1c, canvas_type))

    # ---- branches --------------------------------------------------------
    ekw = dict(max_width=sum(canvas_size))

    def finalize_slab(dist_state_s, coc_state_s, slab, obs_s, pres_s, win_s):
        """keep_old + take select on slab crops (the slab-local mirror of
        the full branch's selects)."""
        new_dist = jnp.where(slab["valid"], slab["dist_sq"], EMPTY_VALUE)
        new_coc = jnp.where(slab["valid"][..., None],
                            slab["coc"].astype(jnp.int16), COC_INVALID16)
        old_rel = coc_state_s.astype(jnp.int32)
        old_valid = coc_state_s[..., 0] != COC_INVALID16
        old_in_canvas = jnp.all((old_rel >= 0) & (old_rel < cs_arr), -1)
        keep_old = old_valid & ~old_in_canvas & (dist_state_s < new_dist)
        dist_s = jnp.where(keep_old, dist_state_s, new_dist)
        coc_s = jnp.where(keep_old[..., None], coc_state_s, new_coc)
        take = win_s & obs_s & pres_s & (dist_s != EMPTY_VALUE)
        if not cfg.fast_mode:
            take = take | (obs_s & ~win_s)
        fin_d = jnp.where(take, dist_s, dist_state_s)
        fin_c = jnp.where(take[..., None], coc_s, coc_state_s)
        return fin_d, fin_c, dist_s, coc_s

    def make_gated(SX, SY):
        def branch(ops):
            dist_state, coc_state, ctype, pblk, bx0, by0, woff, dmax = ops
            ox = jnp.clip(bx0 // 8 * 8, 0, X - SX)
            oy = jnp.clip(by0 // 8 * 8, 0, Y - SY)
            # present expanded only over the slab (block-granular operand:
            # the old full-canvas repeat materialised as a switch operand)
            pres_s = _expand_blocks(jax.lax.dynamic_slice(
                pblk, (ox // 8, oy // 8, 0), (SX // 8, SY // 8, Z // 8)))
            if mesh is None:
                slab = batch_edt_slab(ctype, ox, oy, sx=SX, sy=SY,
                                      p1_packed=p1c_new if use_p1c else None,
                                      **ekw)
            else:
                slab = batch_edt_sharded_slab(ctype, oy, sy=SY, mesh=mesh,
                                              **ekw)
            sl = lambda a: jax.lax.dynamic_slice(
                a, (ox, oy, 0) + (0,) * (a.ndim - 3),
                (SX, SY, Z) + a.shape[3:])
            # window mask on slab coords (the slab may cover any part of it)
            si = [jax.lax.broadcasted_iota(jnp.int32, (SX, SY, Z), a)
                  + jnp.stack([ox, oy, jnp.int32(0)])[a] for a in range(3)]
            win_s = ((si[0] >= woff[0]) & (si[0] < woff[0] + local_size[0])
                     & (si[1] >= woff[1]) & (si[1] < woff[1] + local_size[1])
                     & (si[2] >= woff[2]) & (si[2] < woff[2] + local_size[2]))
            dist_state_s = sl(dist_state)
            coc_state_s = sl(coc_state)
            obs_s = sl(ctype) != VOX_UNKNOWN
            # (the pre-take crops equal the final crops on every voxel the
            # observed-masked outputs expose — gated branches only run when
            # sites exist; see the zero-site force-full guard)
            fin_d, fin_c, _, _ = finalize_slab(
                dist_state_s, coc_state_s, slab, obs_s, pres_s, win_s)
            final_dist = jax.lax.dynamic_update_slice(dist_state, fin_d,
                                                      (ox, oy, 0))
            final_coc = jax.lax.dynamic_update_slice(coc_state, fin_c,
                                                     (ox, oy, 0, 0))
            chg_blk = jnp.any(
                (fin_d != dist_state_s).reshape(SX // 8, 8, SY // 8, 8,
                                                Z // 8, 8), axis=(1, 3, 5))
            changed = jax.lax.dynamic_update_slice(
                jnp.zeros(cfg.canvas_blocks, jnp.bool_), chg_blk,
                (ox // 8, oy // 8, 0))
            # per-cell dist bound over the slab (fuses with the chg_blk
            # reduce's read of fin_d); outside the slab neither dist nor
            # observedness changed, so the stored bound stays valid
            dm_s = jnp.max(
                jnp.where(obs_s, fin_d, -1).reshape(SX // 4, 4, SY // 4, 4,
                                                    Z // 4, 4), axis=(1, 3, 5))
            new_dmax = jax.lax.dynamic_update_slice(dmax, dm_s,
                                                    (ox // 4, oy // 4, 0))
            dist_win = _crop(final_dist, woff, local_size)
            cw = (_crop(final_coc, woff, local_size),) if emit_outputs else ()
            return (final_dist, final_coc, dist_win) + cw + (
                changed, jnp.int32(SX * SY * Z), new_dmax)
        return branch

    def full_branch(ops, zero_site=False):
        dist_state, coc_state, ctype, pblk, _bx0, _by0, woff, dmax = ops
        pvox = _expand_blocks(pblk)
        if zero_site:
            # no sites anywhere: every envelope is empty, so the exact EDT
            # is the constant (valid=False -> EMPTY/INVALID) fill —
            # finalize/keep-old/changed logic below is identical
            full = {"valid": jnp.zeros(canvas_size, jnp.bool_),
                    "dist_sq": jnp.zeros(canvas_size, jnp.int32),
                    "coc": jnp.zeros(canvas_size + (3,), jnp.int32)}
        elif mesh is None:
            # reuse the freshly patched/rebuilt phase-1 cache: without it,
            # full-recompute frames with the cache on would scan phase 1
            # TWICE (once for the cache, once inside batch_edt)
            full = batch_edt(ctype, p1_packed=p1c_new if use_p1c else None,
                             **ekw)
        else:
            full = batch_edt_sharded(ctype, mesh=mesh, **ekw)
        win_s = window_mask
        obs = ctype != VOX_UNKNOWN
        fin_d, fin_c, dist_pre, coc_pre = finalize_slab(
            dist_state, coc_state, full, obs, pvox, win_s)
        changed = jnp.any(
            (fin_d != dist_state).reshape(
                X // 8, 8, Y // 8, 8, Z // 8, 8), axis=(1, 3, 5))
        new_dmax = jnp.max(
            jnp.where(obs, fin_d, -1).reshape(X // 4, 4, Y // 4, 4,
                                              Z // 4, 4), axis=(1, 3, 5))
        # the full branch covers the zero-site frames, where pre-take and
        # final window values can differ at observed voxels: report the
        # TRUE pre-take crops (exactly the ungated path's dist_win)
        dist_win = _crop(dist_pre, woff, local_size)
        cw = (_crop(coc_pre, woff, local_size),) if emit_outputs else ()
        return (fin_d, fin_c, dist_win) + cw + (
            changed, jnp.int32(0 if zero_site else X * Y * Z), new_dmax)

    branches = ([make_gated(sx, sy) for sx, sy in menu] + [full_branch]
                + [partial(full_branch, zero_site=True)])
    ops = (state.dist_sq, state.coc, canvas_type, present_blk,
           x0, y0, win_off, state.dmax_cell)
    res = jax.lax.switch(sel, branches, ops)
    if emit_outputs:
        (final_dist, final_coc, dist_win, coc_win, changed_blk_d,
         slab_vox, dmax_new) = res
    else:
        (final_dist, final_coc, dist_win, changed_blk_d,
         slab_vox, dmax_new) = res
        coc_win = None
    return (final_dist, final_coc, dist_win, coc_win, changed_blk_d,
            sel, slab_vox, dmax_new, p1c_new, jnp.asarray(use_p1c))


def _expand_blocks(blk):
    """bool block grid -> voxel grid (×VB_WIDTH per axis, broadcast)."""
    return jnp.repeat(jnp.repeat(jnp.repeat(blk, VB_WIDTH, 0),
                                 VB_WIDTH, 1), VB_WIDTH, 2)


def _crop(arr, off, shape):
    """dynamic_slice window crop of a canvas array (trailing dims kept)."""
    extra = arr.shape[3:]
    starts = (off[0], off[1], off[2]) + (0,) * len(extra)
    return jax.lax.dynamic_slice(arr, starts, tuple(shape) + extra)


def _uncrop(arr, patch, off):
    extra = arr.shape[3:]
    starts = (off[0], off[1], off[2]) + (0,) * len(extra)
    return jax.lax.dynamic_update_slice(arr, patch, starts)


def merge_frame_impl(
    state: MapState,
    inst_type,          # int8 [X,Y,Z] from a projection sensor (or raycaster)
    ray_count,          # int32 [X,Y,Z] (zeros for projection sensors)
    pvt,                # int32 [3] window pivot (glb voxel coord of window corner)
    canvas_origin_blk,  # int32 [3] target canvas origin for this frame
    win_off,            # int32 [3] window offset inside the canvas (voxels)
    fence_ll, fence_ur, fence_active, fence_n,
    points=None,        # [N,3] float32 world-frame endpoints (fused raycast)
    pts_valid=None,     # [N] bool
    sensor_origin=None, # (3,) float32
    enter_shift=None,   # int32 [3] this frame's scroll shift in VOXELS (the
                        # change-gated EDT's entering-slab boxes); zeros/None
                        # on non-scroll frames.  Computed internally when
                        # do_scroll=True.
    *,
    cfg: MapConfig,
    input_pointcloud: bool,
    mesh=None,          # jax.sharding.Mesh: shard canvas-x / archive-blocks
    do_scroll: bool = True,
    use_fence: bool = True,  # static: skip the AABB pass when no box is active
    fuse_raycast: bool = False,  # static: run the projective raycast in-program
    emit_outputs: bool = True,  # static: False drops the per-frame output
                        # tensors (edt/coc/dist_sq/glb_type/ogm_changed) from
                        # the program — the replay scan's non-final frames
                        # only consume state + scalars, and the reference's
                        # own timed hot path excludes publishing
                        # (volumetric_mapper.cpp:186-203 brackets OGM+EDT;
                        # convertCostMap runs after, untimed)
):
    """Fuse one local observation into the global map and refresh the EDT.

    Returns (state', outputs dict).

    `do_scroll=False` skips the in-program canvas scroll: the host calls the
    separate jitted `scroll_step` only on block crossings (a traced
    `lax.cond` identity branch still copies every state buffer, ~100 MB of
    pure waste on the common no-move frame).
    """
    local_size = cfg.local_size
    canvas_blocks = cfg.canvas_blocks
    canvas_size = cfg.canvas_size
    bx, by, bz = canvas_blocks

    # ---- scroll the resident canvas to this frame's origin --------------
    if do_scroll:
        if enter_shift is None:
            enter_shift = (canvas_origin_blk - state.origin_blk) * VB_WIDTH
        state = scroll_canvas(state, canvas_origin_blk, cfg)
    canvas_origin_vox = canvas_origin_blk * VB_WIDTH

    if mesh is not None:
        from ..parallel.mesh import canvas_sharding

        cs_shard = canvas_sharding(mesh)
        state = dataclasses.replace(
            state,
            occ_val=jax.lax.with_sharding_constraint(state.occ_val, cs_shard),
            vox_type=jax.lax.with_sharding_constraint(state.vox_type, cs_shard),
            dist_sq=jax.lax.with_sharding_constraint(state.dist_sq, cs_shard),
            coc=jax.lax.with_sharding_constraint(state.coc, cs_shard),
        )

    old_dist = state.dist_sq
    old_type = state.vox_type

    win = lambda a: _crop(a, win_off, local_size)

    if fuse_raycast:
        # projective pointcloud model inlined into the frame program: one
        # dispatch per frame, no intermediate HBM round trip
        from ..ops.raycast import panorama_bins, pointcloud_project

        nt, np_ = panorama_bins(local_size)
        inst_type, ray_count = pointcloud_project(
            points, pts_valid, sensor_origin, pvt,
            local_size=local_size, voxel_width=cfg.voxel_width,
            ogm_min_h=cfg.ogm_min_h, ogm_max_h=cfg.ogm_max_h,
            for_motion_planner=cfg.for_motion_planner,
            robot_r2_grids=cfg.robot_r2_grids, n_theta=nt, n_phi=np_,
        )

    observed = (ray_count != 0) if input_pointcloud else (inst_type != VOX_UNKNOWN)

    # ---- block allocation (dense: flip present flags) -------------------
    # `observed` lives only in the window and `present` is block-granular:
    # both the needed-block reduce and the window's present expansion run on
    # window/block-sized covering buffers instead of materialising two
    # full-canvas bool passes (the old uncrop→reduce + repeat→crop chain —
    # ~17 MB/frame of pure waste on depthcam-class halo canvases).  A
    # window straddles at most local//8+2 blocks per axis; the covering
    # patch may hang up to 2 (all-False) blocks past the canvas edge, so
    # the block splice runs on a +2-padded block buffer (tiny) to keep the
    # dynamic_update_slice from clamp-shifting.
    lb = tuple(ls // VB_WIDTH + 2 for ls in local_size)
    start_bk = win_off // VB_WIDTH
    sub = win_off - start_bk * VB_WIDTH  # 0..7 per axis
    cov = jnp.zeros(tuple(b * VB_WIDTH for b in lb), jnp.bool_)
    cov = jax.lax.dynamic_update_slice(cov, observed, (sub[0], sub[1], sub[2]))
    nb = cov.reshape(lb[0], VB_WIDTH, lb[1], VB_WIDTH,
                     lb[2], VB_WIDTH).any((1, 3, 5))
    pad_blk = jnp.zeros(tuple(b + 2 for b in canvas_blocks), jnp.bool_)
    needed_blk = jax.lax.dynamic_update_slice(
        pad_blk, nb, (start_bk[0], start_bk[1], start_bk[2]))[:bx, :by, :bz]
    present = state.present | needed_blk

    pres_cov = jax.lax.dynamic_slice(
        pad_blk.at[:bx, :by, :bz].set(present),
        (start_bk[0], start_bk[1], start_bk[2]), lb)
    present_vox_win = jax.lax.dynamic_slice(
        _expand_blocks(pres_cov), (sub[0], sub[1], sub[2]), local_size)

    # ---- occupancy fusion (unify_helper.cuh:35-197) ---------------------
    loc_grid = geo.local_coord_grid(local_size)
    glb_pos = geo.coord2pos(loc_grid + pvt[None, None, None, :], cfg.voxel_width)

    old_occ_win = win(state.occ_val)
    old_type_win = win(state.vox_type)
    if use_fence:
        occ_flag = _fence_mask(glb_pos, fence_ll, fence_ur, fence_active, fence_n)
    else:
        occ_flag = jnp.zeros(local_size, jnp.bool_)

    if input_pointcloud:
        # hit-count probability fusion (unify_helper.cuh:89-97)
        hit = (ray_count > 0) | occ_flag
        miss = (ray_count < 0) & ~hit
        pbty = jnp.minimum(1.0, (-ray_count).astype(jnp.float32) / 10.0)
        occ_h, type_h = _lowpass(old_occ_win, old_type_win, _c.OCC_HIT_VAL, 1.0,
                                 cfg.occupancy_threshold)
        occ_m, type_m = _lowpass(old_occ_win, old_type_win, _c.OCC_FREE_VAL, pbty,
                                 cfg.occupancy_threshold)
    else:
        # fixed 0.8 / 0.5 low-pass (unify_helper.cuh:170-177)
        hit = (inst_type == _c.VOX_OCCUPIED) | occ_flag
        miss = (inst_type == VOX_FREE) & ~hit
        occ_h, type_h = _lowpass(old_occ_win, old_type_win, _c.OCC_HIT_VAL,
                                 _c.LOWPASS_SENSOR_OCC, cfg.occupancy_threshold)
        occ_m, type_m = _lowpass(old_occ_win, old_type_win, _c.OCC_FREE_VAL,
                                 _c.LOWPASS_SENSOR_FREE, cfg.occupancy_threshold)

    upd = present_vox_win & (hit | miss)
    new_occ_win = jnp.where(upd, jnp.where(hit, occ_h, occ_m), old_occ_win)
    new_type_win = jnp.where(upd, jnp.where(hit, type_h, type_m), old_type_win)

    # window copy used by the batch EDT (set_vox_glb_type back-copy,
    # unify_helper.cuh:101,182); absent blocks read UNKNOWN
    glb_type = jnp.where(present_vox_win, new_type_win, VOX_UNKNOWN).astype(jnp.int8)
    ogm_changed = present_vox_win & (new_type_win != old_type_win)

    canvas_occ = _uncrop(state.occ_val, new_occ_win, win_off)
    canvas_type = _uncrop(state.vox_type, new_type_win, win_off)

    # ---- masks ----------------------------------------------------------
    window_mask = _uncrop(
        jnp.zeros(canvas_size, jnp.bool_), jnp.ones(local_size, jnp.bool_), win_off
    )
    observed_canvas = canvas_type != VOX_UNKNOWN
    outside_observed = observed_canvas & ~window_mask

    gated = None
    from ..ops.edt_batch import sharded_edt_ok as _sh_ok
    if cfg.merge_mode == "canvas_edt" and cfg.edt_gate \
            and canvas_size[2] > 1 \
            and _slab_menu(canvas_size, _menu_fracs(cfg)) \
            and (mesh is None or _sh_ok(canvas_size, mesh)) \
            and (canvas_size[0] * canvas_size[1] * canvas_size[2]
                 >= cfg.edt_gate_min_vox):
        # ---- change-gated exact canvas EDT (see _gated_canvas_merge) -----
        if enter_shift is None:
            enter_shift = jnp.zeros(3, jnp.int32)
        gated = _gated_canvas_merge(
            state, canvas_type, old_type, new_type_win, old_type_win,
            win_off, window_mask, present, enter_shift, cfg=cfg,
            mesh=mesh, emit_outputs=emit_outputs)
        (final_dist, final_coc, dist_win_g, coc_win_g, changed_blk_d,
         gate_level, slab_vox, dmax_new, p1c_new, p1c_ok_new) = gated
        relax_iters = jnp.int32(0)
    elif cfg.merge_mode == "canvas_edt":
        # ---- one exact separable EDT over the whole canvas --------------
        # Replaces the reference's batch-EDT + MarkLimitedObserve +
        # raise/lower wavefront composition (local_edt_core.h +
        # unify_helper.cuh:201-446 + wave_core.cuh) with a single dense
        # 3-phase transform over the CURRENT observed-occupied set: the
        # active region is bounded and dense, so an exact recompute is
        # both cheaper than iterating the wavefront fixed point and more
        # accurate (true Voronoi; disappeared obstacles — the raise wave —
        # fall out automatically because the site set is the live occupancy).
        from ..ops.edt_batch import batch_edt_sharded, sharded_edt_ok

        if sharded_edt_ok(canvas_size, mesh):
            # shard_map + all_to_all phase boundaries: per-device envelopes
            # on local shards (GSPMD would replicate a kernel)
            full = batch_edt_sharded(canvas_type, max_width=sum(canvas_size),
                                     mesh=mesh)
        else:
            full = batch_edt(canvas_type, max_width=sum(canvas_size))
        new_dist = jnp.where(full["valid"], full["dist_sq"], EMPTY_VALUE)
        # cocs are stored canvas-relative (map_state docstring): batch_edt's
        # canvas indices ARE the stored representation
        new_coc = jnp.where(
            full["valid"][..., None],
            full["coc"].astype(jnp.int16),
            COC_INVALID16,
        )
        # limited observation, canvas scale (MarkLimitedObserve semantics,
        # unify_helper.cuh:249-255): memory of obstacles BEYOND the canvas
        # survives when it is closer than anything observable now
        old_coc_rel = state.coc.astype(jnp.int32)
        old_valid = state.coc[..., 0] != COC_INVALID16
        cs_arr = jnp.asarray(canvas_size, jnp.int32)
        old_in_canvas = jnp.all((old_coc_rel >= 0) & (old_coc_rel < cs_arr), -1)
        keep_old = old_valid & ~old_in_canvas & (state.dist_sq < new_dist)
        dist = jnp.where(keep_old, state.dist_sq, new_dist)
        coc = jnp.where(keep_old[..., None], state.coc, new_coc)
        relax_iters = jnp.int32(0)
    else:
        # ---- iterative wavefront-equivalent path ("relax") ---------------
        batch = batch_edt(glb_type, max_width=cfg.max_width)
        seed_dist, seed_coc = reconcile_window(
            batch, win(state.dist_sq), win(state.coc), glb_type, win_off,
            local_size
        )
        dist = _uncrop(state.dist_sq, seed_dist, win_off)
        coc = _uncrop(state.coc, seed_coc, win_off)

        # raise: invalidate disappeared obstacles (wave A) — a dense
        # coc-equality wave over the STALE canvas coc field (gather-free)
        raised = None
        if not cfg.fast_mode:
            from ..utils.constants import VOX_OCCUPIED

            dead_win = ((win(old_type) == VOX_OCCUPIED)
                        & (glb_type != VOX_OCCUPIED)
                        & (glb_type != VOX_UNKNOWN))
            dist, coc, raised = invalidate_disappeared(
                dist, coc, outside_observed, state.coc, dead_win, win_off,
                max_sweeps=cfg.relax_iters,
            )

        # lower in/out fixed point (waves B + C)
        can_update = window_mask if cfg.fast_mode else (window_mask | outside_observed)
        dist, coc, relax_iters = relax_fixed_point(
            dist, coc, can_update, outside_observed, window_mask,
            canvas_size=canvas_size, cutoff_sq=cfg.cutoff_grids_sq,
            max_iters=cfg.relax_iters,
        )

    # ---- frontiers (obtainFrontiers FNT marking) ------------------------
    glb_type_out, fnt = mark_frontiers(canvas_type, glb_type, win_off, local_size)

    # ---- finalize write-back (UpdateHashBatch) --------------------------
    if gated is not None:
        dist_win, coc_win = dist_win_g, coc_win_g
    else:
        dist_win = win(dist)
        # the relax path's state write-back reads coc_win (the canvas_edt
        # path splices final_coc from `take` instead) — only the canvas
        # path may drop it outputs-light
        coc_win = (win(coc)
                   if emit_outputs or cfg.merge_mode != "canvas_edt"
                   else None)
    pair_valid = dist_win != EMPTY_VALUE
    observed_win = glb_type != VOX_UNKNOWN
    writeback = observed_win & pair_valid

    if gated is not None:
        pass  # final_dist/final_coc spliced inside the gated switch
    elif cfg.merge_mode == "canvas_edt":
        # ONE fused select per buffer: in-window voxels take the candidate
        # where observed with a valid pair; outside-window voxels take it
        # where observed and the full wavefront set is active (fast_mode
        # skips lower/raise-out, glb_hash_map.cu:174-192).  Equivalent to
        # the writable-gate + window write-back crop/uncrop chain, but each
        # of those passes materialised full dist (7 MB) + coc (11 MB).
        take = window_mask & observed_canvas & _expand_blocks(present) \
            & (dist != EMPTY_VALUE)
        if not cfg.fast_mode:
            take = take | outside_observed
        final_dist = jnp.where(take, dist, state.dist_sq)
        final_coc = jnp.where(take[..., None], coc, state.coc)
    else:
        # write-back fallback for pair-invalid window voxels: the OLD stored
        # value, except where the raise wave invalidated it (the reference's
        # wave mutates the hash in place, so a raised voxel without a fresh
        # valid pair stays raised)
        old_dist_win = win(old_dist)
        old_coc_win = win(state.coc)
        if raised is not None:
            rw = win(raised)
            old_dist_win = jnp.where(rw, EMPTY_VALUE, old_dist_win)
            old_coc_win = jnp.where(rw[..., None], COC_INVALID16, old_coc_win)
        final_dist = _uncrop(dist, jnp.where(writeback, dist_win, old_dist_win),
                             win_off)
        final_coc = _uncrop(coc, jnp.where(writeback[..., None], coc_win,
                                           old_coc_win), win_off)
    vt_win = jnp.where(fnt & writeback, jnp.int8(VOX_FNT), new_type_win)
    canvas_type = _uncrop(canvas_type, vt_win, win_off)

    # EDT output for the motion planner: sqrt of squared grid distance;
    # "sees nothing" voxels get _max_loc_dist_sq exactly like the reference
    # (unify_helper.cuh:467-475,499)
    if emit_outputs:
        edt = jnp.where(
            observed_win,
            jnp.where(pair_valid, jnp.sqrt(dist_win.astype(jnp.float32)),
                      jnp.float32(cfg.max_loc_dist_sq)),
            0.0,
        )

    # ---- changed-block tracking for D2H streaming -----------------------
    # occ-VALUE changes count as changed even when the type doesn't flip:
    # the reference's fusion kernels record a changed VB key for every
    # updated voxel (unify_helper.cuh stream_VB_keys), and the host mirror
    # must converge on occ_val too (tests/test_stream_soak.py caught the
    # occ-only staleness).  Occ changes only happen inside the window.
    occ_changed_win = new_occ_win != old_occ_win
    if gated is not None:
        # dist changes live inside the gated slab (changed_blk_d from the
        # branch); type/occ changes only inside the window — block-reduce
        # the union without re-reading the full dist canvases
        win_changed = _uncrop(jnp.zeros(canvas_size, jnp.bool_),
                              (vt_win != old_type_win) | occ_changed_win,
                              win_off)
        changed_blk = (
            (changed_blk_d
             | win_changed.reshape(bx, VB_WIDTH, by, VB_WIDTH, bz,
                                   VB_WIDTH).any((1, 3, 5)))
            & present
        )
    else:
        changed_vox = ((final_dist != old_dist) | (canvas_type != old_type)
                       | _uncrop(jnp.zeros(canvas_size, jnp.bool_),
                                 occ_changed_win, win_off))
        changed_blk = (
            changed_vox.reshape(bx, VB_WIDTH, by, VB_WIDTH, bz,
                                VB_WIDTH).any((1, 3, 5))
            & present
        )

    # blocks RE-ENTERING the canvas are reported changed: a block can exit
    # with un-streamed changes still in the round-robin backlog (the carry
    # mask is clipped to the canvas on scroll), so the host mirror heals on
    # re-entry by re-streaming the restored content (tests/test_stream_soak)
    if enter_shift is not None:
        sh_blk = enter_shift // VB_WIDTH
        cb_arr = jnp.asarray(canvas_blocks, jnp.int32)
        entering_blk = jnp.zeros(canvas_blocks, jnp.bool_)
        for a in range(3):
            bi = jax.lax.broadcasted_iota(jnp.int32, canvas_blocks, a)
            entering_blk |= jnp.where(
                sh_blk[a] > 0, bi >= cb_arr[a] - sh_blk[a], bi < -sh_blk[a])
        changed_blk = changed_blk | (entering_blk & present)

    state = dataclasses.replace(
        state,
        occ_val=canvas_occ,
        vox_type=canvas_type,
        dist_sq=final_dist,
        coc=final_coc,
        present=present,
        # per-cell dist bound: maintained by the gated branches; reset to
        # the conservative max on ungated paths (nothing reads it there, and
        # a later gated run self-heals from it via the full branch)
        dmax_cell=(dmax_new if gated is not None
                   else jnp.full(tuple(c // 4 for c in canvas_size),
                                 EMPTY_VALUE, jnp.int32)),
        p1c=p1c_new if gated is not None else state.p1c,
        p1c_ok=(p1c_ok_new if gated is not None
                else jnp.zeros((), jnp.bool_)),
    )

    # published cocs are GLOBAL int32 (the stored canvas-relative int16 plus
    # the canvas origin) — world extent is unbounded, output invalids keep
    # the COC_INVALID16 sentinel value.  dist_sq/coc outputs are masked to
    # OBSERVED voxels (round 3): unobserved voxels' fresh-EDT values were
    # never stored (write-back gating) nor published by the reference
    # (convertCostMap reads the hash, local_batch.h:382-391), and masking
    # makes the outputs a pure function of the stored state — the contract
    # the change-gated EDT splice preserves bit-exactly.
    outputs = {
        "changed_blk": changed_blk,      # bool [bx,by,bz]
        "relax_iters": relax_iters,
        "arch_dropped": state.arch_dropped,
        "fnt_count": jnp.sum(fnt.astype(jnp.int32)),
        # change-gated EDT observability (VERDICT r3): taken slab-menu level
        # (len(menu) = full recompute; -1 = gating off) and recomputed voxels
        "gate_level": gate_level if gated is not None else jnp.int32(-1),
        "gate_slab_vox": (slab_vox if gated is not None
                          else jnp.int32(canvas_size[0] * canvas_size[1]
                                         * canvas_size[2])),
    }
    if emit_outputs:
        coc_glb_win = jnp.where(
            (observed_win & (coc_win[..., 0] != COC_INVALID16))[..., None],
            coc_win.astype(jnp.int32) + canvas_origin_vox,
            jnp.int32(COC_INVALID16),
        )
        outputs.update({
            "edt": edt,                  # float32 [X,Y,Z]
            "glb_type": glb_type_out,    # int8 [X,Y,Z] incl. FNT marks
            "dist_sq": jnp.where(observed_win, dist_win, EMPTY_VALUE),
            "coc": coc_glb_win,          # int32 [X,Y,Z,3] global coords
            "ogm_changed": ogm_changed,
        })
    return state, outputs


merge_frame = partial(jax.jit,
                      static_argnames=("cfg", "input_pointcloud", "mesh",
                                       "do_scroll", "use_fence", "fuse_raycast",
                                       "emit_outputs"),
                      donate_argnums=(0,))(merge_frame_impl)


def _unpack_pose(pose):
    """float32 [9,3] packed per-frame pose -> (pvt, origin_blk, off int32;
    rot [3,3], origin [3], s1 [3], s2 [3] float32).  Integer rows ride the
    float array exactly (|values| << 2^24); rows 7-8 carry per-sensor
    scalars (theta/phi bins or camera intrinsics)."""
    pose_i = pose[:3].astype(jnp.int32)
    return (pose_i[0], pose_i[1], pose_i[2], pose[3:6], pose[6], pose[7],
            pose[8])


def _fused_sensor(sensor_kind, sensor_data, rot, origin, s1, s2, pvt,
                  cfg: MapConfig):
    """Run a projection sensor model inside the frame program (the in-program
    analogue of fuse_raycast, for the hokuyo/realsense/vlp16 pipelines):
    one dispatch per frame, scalars riding the packed pose upload."""
    from ..ops import scan_sensors as ss

    projc = geo.Projection(rot, origin)
    common = dict(local_size=cfg.local_size, voxel_width=cfg.voxel_width,
                  ogm_min_h=cfg.ogm_min_h, ogm_max_h=cfg.ogm_max_h,
                  for_motion_planner=cfg.for_motion_planner,
                  robot_r2_grids=cfg.robot_r2_grids)
    if sensor_kind == "scan":
        param = ss.ScanParam(theta_min=s1[0], theta_inc=s1[1],
                             ranges=sensor_data)
        inst = ss.hokuyo_update(projc, param, pvt, **common)
    elif sensor_kind == "depth":
        param = ss.CamParam(fx=s1[0], fy=s1[1], cx=s1[2], cy=s2[0],
                            depth=sensor_data)
        inst = ss.realsense_update(projc, param, pvt,
                                   valid_nan=cfg.valid_nan, **common)
    elif sensor_kind == "multiscan":
        param = ss.MulScanParam(theta_min=s1[0], theta_inc=s1[1],
                                phi_min=s1[2], phi_inc=s2[0],
                                rings=sensor_data)
        inst = ss.vlp16_update(projc, param, pvt, **common)
    else:  # pragma: no cover
        raise KeyError(sensor_kind)
    return inst, jnp.zeros(cfg.local_size, jnp.int32)


@partial(jax.jit,
         static_argnames=("cfg", "input_pointcloud", "mesh", "use_fence",
                          "fuse_raycast", "sensor_kind"),
         donate_argnums=(0,))
def frame_step(state, pose, fence_ll, fence_ur, fence_active, fence_n,
               inst_type=None, ray_count=None, points=None, pts_valid=None,
               sensor_data=None, *,
               cfg: MapConfig, input_pointcloud: bool, mesh=None,
               use_fence: bool = True, fuse_raycast: bool = False,
               sensor_kind: str | None = None):
    """Low-latency per-frame entry used by the mapper (merge_frame with the
    per-frame scalars packed).

    Every small host->device transfer is a separate enqueue, so ALL
    per-frame pose data rides ONE float32 [9,3] array:
    rows 0-2 the integer pvt / canvas_origin_blk / win_off (exact in f32),
    rows 3-5 the sensor rotation, row 6 the sensor origin.  With
    fuse_raycast the sensor->world point transform runs in-program too,
    removing the per-frame l2g dispatch; with sensor_kind one of
    scan/depth/multiscan, the projection sensor model runs in-program
    (sensor_data = the staged ranges/depth/rings array): a frame is ONE
    108-byte upload + one dispatch."""
    pvt, origin_blk, off, rot, origin, s1, s2 = _unpack_pose(pose)
    kw = {}
    if fuse_raycast:
        inst_type = jnp.zeros(cfg.local_size, jnp.int8)
        ray_count = jnp.zeros(cfg.local_size, jnp.int32)
        kw = dict(points=geo.rigid_transform(points, rot, origin),
                  pts_valid=pts_valid, sensor_origin=origin)
    elif sensor_kind is not None:
        inst_type, ray_count = _fused_sensor(
            sensor_kind, sensor_data, rot, origin, s1, s2, pvt, cfg)
    return merge_frame_impl(
        state, inst_type, ray_count, pvt, origin_blk, off,
        fence_ll, fence_ur, fence_active, fence_n,
        cfg=cfg, input_pointcloud=input_pointcloud, mesh=mesh,
        do_scroll=False, use_fence=use_fence, fuse_raycast=fuse_raycast, **kw)


@partial(jax.jit,
         static_argnames=("cfg", "input_pointcloud", "mesh", "use_fence",
                          "fuse_raycast", "sensor_kind", "compact_rows"),
         donate_argnums=(0,))
def scroll_frame_step(state, pose, fence_ll, fence_ur, fence_active,
                      fence_n, inst_type=None, ray_count=None, points=None,
                      pts_valid=None, sensor_data=None, *,
                      cfg: MapConfig, input_pointcloud: bool,
                      mesh=None, use_fence: bool = True,
                      fuse_raycast: bool = False,
                      sensor_kind: str | None = None,
                      compact_rows: int | None = None):
    """frame_step with the compacted canvas scroll fused in: on block-crossing
    frames this replaces the scroll_step + frame_step dispatch pair with ONE
    program, letting XLA overlap archive I/O with the frame's early passes.
    The target canvas origin rides pose row 1."""
    from ..map_state import _do_scroll

    pvt, origin_blk, off, rot, origin, s1, s2 = _unpack_pose(pose)
    enter_shift = (origin_blk - state.origin_blk) * VB_WIDTH
    state = _do_scroll(state, origin_blk, cfg, compact_rows=compact_rows)
    kw = {}
    if fuse_raycast:
        inst_type = jnp.zeros(cfg.local_size, jnp.int8)
        ray_count = jnp.zeros(cfg.local_size, jnp.int32)
        kw = dict(points=geo.rigid_transform(points, rot, origin),
                  pts_valid=pts_valid, sensor_origin=origin)
    elif sensor_kind is not None:
        inst_type, ray_count = _fused_sensor(
            sensor_kind, sensor_data, rot, origin, s1, s2, pvt, cfg)
    return merge_frame_impl(
        state, inst_type, ray_count, pvt, origin_blk, off,
        fence_ll, fence_ur, fence_active, fence_n,
        enter_shift=enter_shift,
        cfg=cfg, input_pointcloud=input_pointcloud, mesh=mesh,
        do_scroll=False, use_fence=use_fence, fuse_raycast=fuse_raycast, **kw)


def replay_frames(state, poses, scrolled, *args, has_scrolls: bool = True,
                  **kw):
    """Un-jitted contract guard over `_replay_frames_impl` (ADVICE r4).

    `has_scrolls=False` compiles the scan body WITHOUT the scroll cond; a
    caller passing a scrolling frame under it would silently skip the scroll
    and corrupt origin/canvas state.  `scrolled` is concrete at every call
    site (host-planned), so check it here before dispatch."""
    if not has_scrolls:
        import numpy as _np

        if bool(_np.asarray(scrolled).any()):
            raise ValueError(
                "replay_frames(has_scrolls=False) requires scrolled[k] == "
                "False for every frame; got a scrolling frame. Pass "
                "has_scrolls=True (or plan per-run like VolumetricMapper).")
    return _replay_frames_impl(state, poses, scrolled, *args,
                               has_scrolls=has_scrolls, **kw)


@partial(jax.jit,
         static_argnames=("cfg", "input_pointcloud", "use_fence",
                          "fuse_raycast", "sensor_kind", "compact_rows",
                          "mesh", "has_scrolls"),
         donate_argnums=(0,))
def _replay_frames_impl(state, poses, scrolled, fence_ll, fence_ur, fence_active,
                  fence_n, inst_type=None, ray_count=None, points=None,
                  pts_valid=None, sensor_data=None, *,
                  cfg: MapConfig, input_pointcloud: bool,
                  use_fence: bool = True, fuse_raycast: bool = False,
                  sensor_kind: str | None = None,
                  compact_rows: int | None = None, mesh=None,
                  has_scrolls: bool = True):
    """Throughput/replay mode: K frames in ONE jitted `lax.scan` program.

    The per-frame entries (frame_step / scroll_frame_step) pay one
    host->device dispatch each.  For offline map
    building from recorded logs (the reference's own evaluation mode: rosbag
    replay, README.md:102-145) the poses are known ahead, so the host
    pre-computes each frame's window geometry and scroll decision and the
    whole batch runs as one scan: per-frame cost drops to pure device time.

    Scrolls run INSIDE the scan via `lax.cond` over the compacted archive
    path (`compact_rows` bounds the moved block rows;
    the mapper verifies every scroll in the batch fits and falls back to the
    per-frame path otherwise).  State evolution is bit-identical to the
    per-frame loop (tests/test_replay_batch.py).

    `has_scrolls=False` (static) compiles the scan body WITHOUT the scroll
    cond: a traced `lax.cond` identity branch copies every carried canvas
    buffer each iteration, so scroll-free runs
    — stationary robots, slow sensors, the frozen-state engine A/B — pay a
    full-state copy per frame for nothing.  The mapper passes it per run
    from the host-side plan; callers setting it must pass scrolled=False
    for every frame (enforced by the un-jitted `replay_frames` wrapper).

    Args (scanned along axis 0, length K):
      poses:    float32 [K,9,3] packed per-frame pose (see _unpack_pose).
      scrolled: bool [K] — whether this frame's canvas origin differs from
                the previous frame's (host-computed).
      points/pts_valid ([K,N,3]/[K,N]) with fuse_raycast;
      sensor_data [K,...] with sensor_kind; else inst_type/ray_count [K,...].

    Returns (state', last_outputs, changed_union [bx,by,bz], per_frame) with
    per_frame a dict of [K] arrays (relax_iters, fnt_count, arch_dropped).
    """
    from ..map_state import _do_scroll, shift_block_mask

    fence = (fence_ll, fence_ur, fence_active, fence_n)

    def scroll_branch(op):
        s, mask, origin_blk = op
        shift = origin_blk - s.origin_blk
        s2 = _do_scroll(s, origin_blk, cfg, compact_rows=compact_rows)
        return s2, shift_block_mask(mask, shift)

    SCALAR_YS = ("relax_iters", "fnt_count", "arch_dropped", "gate_level",
                 "gate_slab_vox")

    def frame(carry, xs, emit):
        s, changed_union = carry
        pvt, origin_blk, off, rot, origin, s1, s2 = _unpack_pose(xs["pose"])
        if has_scrolls:
            enter_shift = jnp.where(xs["scrolled"],
                                    (origin_blk - s.origin_blk) * VB_WIDTH, 0)
            s, changed_union = jax.lax.cond(
                xs["scrolled"], scroll_branch, lambda op: (op[0], op[1]),
                (s, changed_union, origin_blk),
            )
        else:
            enter_shift = jnp.zeros_like(origin_blk)
        kw = {}
        if fuse_raycast:
            inst = jnp.zeros(cfg.local_size, jnp.int8)
            cnt = jnp.zeros(cfg.local_size, jnp.int32)
            kw = dict(points=geo.rigid_transform(xs["points"], rot, origin),
                      pts_valid=xs["pts_valid"], sensor_origin=origin)
        elif sensor_kind is not None:
            inst, cnt = _fused_sensor(
                sensor_kind, xs["sensor_data"], rot, origin, s1, s2, pvt, cfg)
        else:
            inst, cnt = xs["inst_type"], xs["ray_count"]
        s, out = merge_frame_impl(
            s, inst, cnt, pvt, origin_blk, off, *fence,
            enter_shift=enter_shift,
            cfg=cfg, input_pointcloud=input_pointcloud, mesh=mesh,
            do_scroll=False, use_fence=use_fence, fuse_raycast=fuse_raycast,
            emit_outputs=emit, **kw)
        changed_union = changed_union | out["changed_blk"]
        ys = {k: out[k] for k in SCALAR_YS}
        return (s, changed_union), out, ys

    def body(carry, xs):
        # non-final frames run outputs-light: only state + scalars leave the
        # frame, so the per-frame output tensors (edt, global coc, masked
        # dist_sq, ogm_changed — ~8-20 MB/frame) are dead code the compiler
        # drops; the reference's timed hot path excludes publishing too
        carry, _, ys = frame(carry, xs, emit=False)
        return carry, ys

    xs = {"pose": poses, "scrolled": scrolled}
    if fuse_raycast:
        xs["points"], xs["pts_valid"] = points, pts_valid
    elif sensor_kind is not None:
        xs["sensor_data"] = sensor_data
    else:
        xs["inst_type"], xs["ray_count"] = inst_type, ray_count

    init = (state, jnp.zeros(cfg.canvas_blocks, jnp.bool_))
    head = jax.tree.map(lambda a: a[:-1], xs)
    tail = jax.tree.map(lambda a: a[-1], xs)
    carry, per_frame = jax.lax.scan(body, init, head)
    # the final frame runs unrolled with full outputs (the chunk's published
    # FrameOutput) — state evolution is identical to the all-in-scan form
    carry, last_out, last_ys = frame(carry, tail, emit=True)
    state, changed_union = carry
    per_frame = {k: jnp.concatenate([per_frame[k], last_ys[k][None]])
                 for k in SCALAR_YS}
    return state, last_out, changed_union, per_frame


@partial(jax.jit, static_argnames=("cfg", "compact_rows"),
         donate_argnums=(0,))
def scroll_step(state: MapState, new_origin_blk, *, cfg: MapConfig,
                compact_rows: int | None = None) -> MapState:
    """Host-gated canvas scroll: called only when the canvas origin actually
    moves (a block crossing), so the common frame pays nothing.

    compact_rows: when the host knows the exiting/entering block count is
    bounded (ordinary +-1-block scrolls move thin slabs), the archive
    put/get runs over a compacted id list of this static size: ~200 rows
    instead of all ~3.6k canvas blocks."""
    from ..map_state import _do_scroll

    return _do_scroll(state, new_origin_blk, cfg, compact_rows=compact_rows)
