"""Map state: the resident scrolling canvas + voxel-block archive.

Dense replacement of the reference's GPU hash table + spinlock block
allocator (/root/reference/include/vox_hash/vhashing.h:20-628, blockalloc.h,
lockset.h) and of the GlbHashMap manager
(src/kernel/par_wave/glb_hash_map.cu:9-113):

* The authoritative working set is a dense **canvas** (window + cutoff halo)
  that scrolls with the robot; the open-addressed, bucket-locked hash map
  becomes a flat block **archive** for regions that scroll out, looked up via
  a dense directory built with one scatter per scroll.  There are no locks,
  chains, or retry loops; "allocation" is flipping dense `present` flags.
* Closest-obstacle coordinates are int16 *canvas-relative* voxel coordinates,
  re-anchored on scroll (archive rows anchor to their own block's origin) —
  the same trick as the reference's per-frame wave-range re-anchoring
  (local_batch.h:159-208), which exists there so (dist, coc) fits a 64-bit
  atomic CAS.  Relative cocs are always in range (|coc - voxel| < 1000
  because dist_sq < EMPTY_VALUE, and the voxel is in the canvas), so the
  world extent is unbounded (int32 pivot: ±2^31 voxels).
"""
from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp
import numpy as np

from .utils.config import MapConfig
from .utils.constants import EMPTY_VALUE, VB_WIDTH, VOX_UNKNOWN

EMPTY_KEY = np.int32(EMPTY_VALUE)


def _blocks_to_dense(arr, canvas_blocks):
    """[bx,by,bz,8,8,8,...] -> [bx*8, by*8, bz*8, ...]."""
    bx, by, bz = canvas_blocks
    extra = arr.shape[6:]
    arr = jnp.transpose(arr, (0, 3, 1, 4, 2, 5) + tuple(range(6, arr.ndim)))
    return arr.reshape((bx * VB_WIDTH, by * VB_WIDTH, bz * VB_WIDTH) + extra)


def _dense_to_blocks(arr, canvas_blocks):
    bx, by, bz = canvas_blocks
    extra = arr.shape[3:]
    arr = arr.reshape((bx, VB_WIDTH, by, VB_WIDTH, bz, VB_WIDTH) + extra)
    return jnp.transpose(arr, (0, 2, 4, 1, 3, 5) + tuple(range(6, arr.ndim)))


# ===========================================================================
# Resident-canvas state (v2): the authoritative working set is a scrolling
# dense canvas; the block pool becomes an ARCHIVE for blocks that scroll out.
#
# Rationale: materialising the whole canvas from the pool every frame would
# cost two full row-gather/row-scatter passes over ~3.6k blocks, while the
# robot crosses a block boundary only every few frames.  Keeping the canvas resident makes the
# common case (no crossing) completely free and reduces crossings to thin
# slab archive/load transfers.  This is also the natural multi-chip layout:
# the canvas stays sharded across the mesh between frames.
#
# Closest-obstacle coords are stored as int16 CANVAS-RELATIVE voxel
# coordinates (half the memory traffic of int32 triples in every sweep).
# A stored coc is always within ~1000 voxels of its canvas voxel (dist_sq
# is bounded by EMPTY_VALUE), so relative coords never overflow int16 no
# matter how far the robot travels; scrolls re-anchor by the shift, archive
# rows re-anchor to their block origin (shift_packed_coc).
# ===========================================================================

COC_INVALID16 = np.int16(32767)
VB_SIZE_ = VB_WIDTH ** 3


# ---- packed voxel payload --------------------------------------------------
# One voxel's full payload packs into 3 uint32 words so archive traffic and
# canvas rolls touch ONE array instead of four (XLA row scatters cost per
# index per operand here):
#   w0 = dist_sq (20 bits; values <= EMPTY_VALUE=999999 < 2^20)
#        | occ_val << 20 (8 bits) | vox_type << 28 (4 bits; 0..3)
#   w1 = coc_x (u16) | coc_y << 16
#   w2 = coc_z (u16)

def pack_voxels(occ_val, vox_type, dist_sq, coc):
    """Dense [..., ] fields -> packed uint32 [..., 3]."""
    w0 = (dist_sq.astype(jnp.uint32)
          | (occ_val.astype(jnp.uint32) << 20)
          | ((vox_type.astype(jnp.uint32) & 0xF) << 28))
    cu = coc.astype(jnp.int32).astype(jnp.uint32) & 0xFFFF
    w1 = cu[..., 0] | (cu[..., 1] << 16)
    w2 = cu[..., 2]
    return jnp.stack([w0, w1, w2], axis=-1)


def unpack_voxels(packed):
    """Packed uint32 [..., 3] -> (occ_val u8, vox_type i8, dist_sq i32, coc i16[...,3])."""
    w0 = packed[..., 0]
    dist = (w0 & 0xFFFFF).astype(jnp.int32)
    occ = ((w0 >> 20) & 0xFF).astype(jnp.uint8)
    typ = ((w0 >> 28) & 0xF).astype(jnp.int8)

    def s16(v):
        return ((v.astype(jnp.int32) ^ 0x8000) - 0x8000).astype(jnp.int16)

    cx = s16(packed[..., 1] & 0xFFFF)
    cy = s16((packed[..., 1] >> 16) & 0xFFFF)
    cz = s16(packed[..., 2] & 0xFFFF)
    return occ, typ, dist, jnp.stack([cx, cy, cz], axis=-1)


def shift_packed_coc(rows, delta):
    """Re-anchor the packed coc fields of uint32 [..., 3] rows by adding
    int32 delta [..., 3] (broadcastable); the COC_INVALID16 sentinel passes
    through.  Used at the canvas<->archive boundary: archive rows anchor
    cocs to their own block origin, canvas voxels to the canvas origin, so
    neither frame ever overflows int16 regardless of world extent (the
    dense analogue of the reference's wave-range re-anchoring,
    local_batch.h:159-208)."""
    s16 = lambda v: (v.astype(jnp.int32) ^ 0x8000) - 0x8000
    cx = s16(rows[..., 1] & 0xFFFF)
    cy = s16((rows[..., 1] >> 16) & 0xFFFF)
    cz = s16(rows[..., 2] & 0xFFFF)
    valid = cx != COC_INVALID16
    inv = jnp.int32(COC_INVALID16)
    nx = jnp.where(valid, cx + delta[..., 0], inv)
    ny = jnp.where(valid, cy + delta[..., 1], inv)
    nz = jnp.where(valid, cz + delta[..., 2], inv)
    u16 = lambda v: v.astype(jnp.uint32) & 0xFFFF
    w1 = u16(nx) | (u16(ny) << 16)
    w2 = u16(nz)
    return jnp.stack([rows[..., 0], w1, w2], axis=-1)


def _block_pos_vox(linear_ids, canvas_blocks):
    """Canvas voxel position [..., 3] of linear block ids (bx*cby*cbz +
    by*cbz + bz order)."""
    cby, cbz = canvas_blocks[1], canvas_blocks[2]
    bx = linear_ids // (cby * cbz)
    by = (linear_ids // cbz) % cby
    bz = linear_ids % cbz
    return jnp.stack([bx, by, bz], axis=-1).astype(jnp.int32) * VB_WIDTH


_PACKED_DEFAULT = np.asarray(
    [np.uint32(EMPTY_VALUE),  # dist=EMPTY, occ=0, type=UNKNOWN
     np.uint32((np.uint16(COC_INVALID16)) | (np.uint32(np.uint16(COC_INVALID16)) << 16)),
     np.uint32(np.uint16(COC_INVALID16))],
    dtype=np.uint32,
)

# Archive rows are stored FLAT: one uint32[1536] word-row per block.  A
# 2-D [B,1536] leaf keeps the row-major {1,0} layout, so every row view is
# a free bitcast and one archive row is one contiguous 6 KB copy.
ROW_WORDS = VB_SIZE_ * 3
_PACKED_DEFAULT_ROW = np.tile(_PACKED_DEFAULT, VB_SIZE_)


def _rows3(rows):
    """[..., 1536] flat word-rows -> [..., 512, 3] per-voxel view."""
    return rows.reshape(rows.shape[:-1] + (VB_SIZE_, 3))


def _p1c_on(cfg) -> bool:
    """Whether this config runs the gated EDT with the phase-1 cache (sizes
    MapState.p1c; the pipeline's use must match — single source of truth)."""
    from .models.pipeline import p1_cache_enabled  # lazy: no import cycle

    return p1_cache_enabled(cfg)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MapState:
    """Scrolling resident canvas + block archive."""

    origin_blk: jnp.ndarray  # int32 [3] canvas origin (block coords)
    # dense canvas [Xc,Yc,Zc(,3)]
    occ_val: jnp.ndarray     # uint8
    vox_type: jnp.ndarray    # int8
    dist_sq: jnp.ndarray     # int32
    coc: jnp.ndarray         # int16, CANVAS-RELATIVE voxel coords
    present: jnp.ndarray     # bool [bx,by,bz] block-allocated flags
    # archive of scrolled-out blocks
    arch_keys: jnp.ndarray   # int32 [B,3]
    n_arch: jnp.ndarray      # int32
    a_packed: jnp.ndarray    # uint32 [B,1536] FLAT packed word-rows (see
    # pack_voxels / ROW_WORDS: [512,3] per-voxel payload flattened row-major)
    arch_dropped: jnp.ndarray  # int32
    # per-CELL (4x4x4 subblock) UPPER bound of stored dist_sq over observed
    # voxels — the change-gated EDT's cell-granular affected-region test
    # reads this tiny canvas/64 grid instead of the full dist_sq canvas
    # (models/pipeline.py::_gated_canvas_merge, cfg.edt_gate_pmode="block").
    # 4-voxel granularity keeps the affected bbox within +-3 voxels of the
    # exact one (8-voxel blocks measurably pushed steady-state cow past the
    # largest menu slab -> full recompute).  Conservative by invariant:
    # EMPTY_VALUE (the max storable dist) wherever unknown/stale — scroll
    # fills entering cells with it, checkpoint load resets it, and any
    # inflation only grows the recompute slab (outputs stay bit-identical).
    # Not serialized (checkpoints stay format v3).
    dmax_cell: jnp.ndarray   # int32 [Xc/4, Yc/4, Zc/4]
    # phase-1 cache for the change-gated EDT (cfg.edt_p1_cache): the packed
    # per-voxel phase-1 word (ops/edt_batch.py::phase1_packed) of the CURRENT
    # canvas occupancy.  Sites only change inside the window's flip bbox on
    # non-scroll frames, so the merge patches the x-slab that covers it
    # instead of rescanning the canvas; p1c_ok goes False on any scroll
    # (the y site axis shifts) and the next merge rebuilds it in full.
    # Shaped [1,1,1] when the feature is off; not serialized.
    p1c: jnp.ndarray         # int32 [Xc,Yc,Zc] (or [1,1,1])
    p1c_ok: jnp.ndarray      # bool scalar

    def tree_flatten(self):
        f = dataclasses.fields(self)
        return tuple(getattr(self, x.name) for x in f), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def create(cfg: MapConfig) -> "MapState":
        cs = cfg.canvas_size
        cb = cfg.canvas_blocks
        B = cfg.max_blocks
        W = VB_WIDTH
        return MapState(
            origin_blk=jnp.zeros(3, jnp.int32),
            occ_val=jnp.zeros(cs, jnp.uint8),
            vox_type=jnp.full(cs, VOX_UNKNOWN, jnp.int8),
            dist_sq=jnp.full(cs, EMPTY_VALUE, jnp.int32),
            coc=jnp.full(cs + (3,), COC_INVALID16, jnp.int16),
            present=jnp.zeros(cb, jnp.bool_),
            arch_keys=jnp.full((B, 3), EMPTY_KEY, jnp.int32),
            n_arch=jnp.zeros((), jnp.int32),
            # device_put of a host array pins the canonical {1,0} row-major
            # layout
            a_packed=jnp.asarray(
                np.broadcast_to(_PACKED_DEFAULT_ROW,
                                (B, ROW_WORDS)).copy()),
            arch_dropped=jnp.zeros((), jnp.int32),
            dmax_cell=jnp.full(tuple(c // 4 for c in cs), EMPTY_VALUE,
                               jnp.int32),
            p1c=jnp.zeros(cs if _p1c_on(cfg) else (1, 1, 1), jnp.int32),
            p1c_ok=jnp.zeros((), jnp.bool_),
        )


@jax.jit
def shift_block_mask(m, shift):
    """Move a [bx,by,bz] block mask with a canvas scroll: new index i held
    the block at old index i + shift; exposed entries become False."""
    bx, by, bz = m.shape
    src = [jax.lax.broadcasted_iota(jnp.int32, m.shape, a) + shift[a]
           for a in range(3)]
    valid = ((src[0] >= 0) & (src[0] < bx) & (src[1] >= 0) & (src[1] < by)
             & (src[2] >= 0) & (src[2] < bz))
    rolled = jnp.roll(m, (-shift[0], -shift[1], -shift[2]), axis=(0, 1, 2))
    return rolled & valid


def _arch_directory(keys, n_arch, origin_blk, canvas_blocks):
    """Archive-slot directory over a canvas-aligned region (one scatter)."""
    B = keys.shape[0]
    rel = keys - origin_blk[None, :]
    shape = jnp.asarray(canvas_blocks, jnp.int32)
    active = jnp.arange(B, dtype=jnp.int32) < n_arch
    inside = jnp.all((rel >= 0) & (rel < shape), axis=-1) & active
    idx = jnp.where(inside[:, None], rel, shape)
    directory = jnp.full(canvas_blocks, -1, jnp.int32)
    return directory.at[idx[:, 0], idx[:, 1], idx[:, 2]].set(
        jnp.arange(B, dtype=jnp.int32), mode="drop"
    )


def _canvas_as_blocks(arr, canvas_blocks):
    return _dense_to_blocks(arr, canvas_blocks)


def scroll_canvas(state: MapState, new_origin_blk, cfg: MapConfig) -> MapState:
    """Shift the resident canvas to a new origin.

    Outgoing present blocks are archived (overwriting an existing archive
    entry for the same key, else appended); the exposed region is reset to
    defaults and then refilled from the archive where entries exist.  A zero
    shift (the common case — the robot crosses a block boundary only every
    few frames) skips all of this via lax.cond.
    """
    shift_blk = new_origin_blk - state.origin_blk
    no_move = jnp.all(shift_blk == 0)
    return jax.lax.cond(
        no_move,
        lambda s: s,
        lambda s: _do_scroll(s, new_origin_blk, cfg),
        state,
    )


def _compact_ids(flags_flat, s_max):
    """Indices of the (at most s_max) set flags, via one small sort.

    Returns (ids int32 [s_max], valid bool [s_max]): the later row
    gather/scatter then touches s_max rows instead of every canvas block.
    """
    nb = flags_flat.shape[0]
    rank = jnp.arange(nb, dtype=jnp.int32)
    key = jnp.where(flags_flat, rank, nb)
    ids = jax.lax.sort(key)[:s_max]
    valid = ids < nb
    return jnp.where(valid, ids, 0), valid


def _do_scroll(state: MapState, new_origin_blk, cfg: MapConfig,
               compact_rows: int | None = None) -> MapState:
    with jax.named_scope("scroll"):
        return _do_scroll_impl(state, new_origin_blk, cfg, compact_rows)


def _do_scroll_impl(state, new_origin_blk, cfg, compact_rows):
    cb = cfg.canvas_blocks
    cs = cfg.canvas_size
    B = state.arch_keys.shape[0]
    if compact_rows is not None:
        compact_rows = min(compact_rows, cb[0] * cb[1] * cb[2])
    shift_blk = new_origin_blk - state.origin_blk

    bxi = jax.lax.broadcasted_iota(jnp.int32, cb, 0)
    byi = jax.lax.broadcasted_iota(jnp.int32, cb, 1)
    bzi = jax.lax.broadcasted_iota(jnp.int32, cb, 2)
    shp = jnp.asarray(cb, jnp.int32)

    # ---- 1. archive outgoing present blocks -----------------------------
    new_pos = jnp.stack([bxi - shift_blk[0], byi - shift_blk[1], bzi - shift_blk[2]], -1)
    exits = jnp.any((new_pos < 0) | (new_pos >= shp), -1) & state.present

    old_dir = _arch_directory(state.arch_keys, state.n_arch, state.origin_blk, cb)
    have_slot = old_dir >= 0
    need_new = exits & ~have_slot
    order = jnp.cumsum(need_new.reshape(-1).astype(jnp.int32)) - 1
    slot_new = state.n_arch + order
    ok_new = need_new.reshape(-1) & (slot_new < B)
    slot = jnp.where(
        have_slot.reshape(-1), old_dir.reshape(-1),
        jnp.where(ok_new, slot_new, B),
    )
    slot = jnp.where(exits.reshape(-1), slot, B)  # only outgoing blocks write

    abs_key = jnp.stack([bxi, byi, bzi], -1).reshape(-1, 3) + state.origin_blk[None, :]
    new_keys = state.arch_keys.at[slot].set(abs_key, mode="drop")
    granted = jnp.minimum(jnp.sum(need_new.astype(jnp.int32)), B - state.n_arch)
    dropped = jnp.sum(need_new.astype(jnp.int32)) - granted

    # pack the whole canvas payload once: all archive traffic and the roll
    # then touch ONE array
    packed = pack_voxels(state.occ_val, state.vox_type, state.dist_sq, state.coc)

    # archive rows anchor cocs to their OWN block origin (canvas-rel minus
    # the block's canvas position); see shift_packed_coc
    if compact_rows is None:
        nb_all = cb[0] * cb[1] * cb[2]
        rows = _canvas_as_blocks(packed, cb).reshape(-1, VB_SIZE_, 3)
        rows = shift_packed_coc(
            rows, -_block_pos_vox(jnp.arange(nb_all, dtype=jnp.int32), cb)[:, None, :])
        a_packed = state.a_packed.at[slot].set(
            rows.reshape(-1, ROW_WORDS), mode="drop")
    else:
        # ordinary scrolls move out only thin slabs: touch exactly those rows
        # (host guarantees the exiting-block bound fits compact_rows)
        ids, idv = _compact_ids(exits.reshape(-1), compact_rows)
        cslot = jnp.where(idv, slot[ids], B)
        crows = _canvas_as_blocks(packed, cb).reshape(-1, VB_SIZE_, 3)[ids]
        crows = shift_packed_coc(crows, -_block_pos_vox(ids, cb)[:, None, :])
        a_packed = state.a_packed.at[cslot].set(
            crows.reshape(-1, ROW_WORDS), mode="drop")
    n_arch = state.n_arch + granted

    # ---- 2. dense shift of the canvas (roll + exposed-region fill) ------
    sv = shift_blk * VB_WIDTH

    def shift_nd(arr, fill, shifts, sizes):
        out = arr
        for ax in range(3):
            out = jnp.roll(out, -shifts[ax], axis=ax)
        # positions whose source index fell outside the old canvas
        exposed = jnp.zeros(sizes, jnp.bool_)
        for ax in range(3):
            idx = jax.lax.broadcasted_iota(jnp.int32, sizes, ax)
            src = idx + shifts[ax]
            exposed |= (src < 0) | (src >= sizes[ax])
        mask = exposed[(...,) + (None,) * (arr.ndim - 3)]
        return jnp.where(mask, jnp.asarray(fill, arr.dtype), out)

    packed = shift_nd(packed, jnp.asarray(_PACKED_DEFAULT), sv, cs)
    present = shift_nd(state.present[..., None], False, shift_blk, cb)[..., 0]
    # cell-granular dist bound rolls with the canvas (block shifts are
    # multiples of 2 cells).  Exposed cells whose content resets to UNKNOWN
    # get -1 (unobserved voxels never enter the P test — leaving the
    # conservative max here made every later frame's affected bbox span to
    # the canvas edge); archive-restored cells get the conservative max
    # below and are refreshed the same frame (the gate's entering slabs put
    # them inside the recompute slab).
    dmax_cell = shift_nd(state.dmax_cell[..., None], -1,
                         shift_blk * 2, tuple(c // 4 for c in cs))[..., 0]
    # the phase-1 cache's y site axis shifted: stale until the next merge
    # rebuilds it (it is NOT rolled — scroll frames rescan in full anyway)

    # ---- 3. load entering blocks from the archive (one gather) ----------
    new_dir = _arch_directory(new_keys, n_arch, new_origin_blk, cb)
    entering = ~present & (new_dir >= 0)
    gslot = jnp.where(entering, new_dir, 0).reshape(-1)
    # restored blocks carry real (dist, coc) content: conservative max until
    # the gate's entering-slab recompute refreshes their cells this frame
    ent2 = entering
    for ax in range(3):
        ent2 = jnp.repeat(ent2, 2, axis=ax)
    dmax_cell = jnp.where(ent2, jnp.int32(EMPTY_VALUE), dmax_cell)

    nb = gslot.shape[0]
    # entering rows re-anchor block-relative -> new-canvas-relative
    if compact_rows is None:
        rows_in = shift_packed_coc(
            _rows3(a_packed[gslot]),
            _block_pos_vox(jnp.arange(nb, dtype=jnp.int32), cb)[:, None, :]
        ).reshape(cb + (VB_WIDTH, VB_WIDTH, VB_WIDTH, 3))
        pblocks = _canvas_as_blocks(packed, cb)
        pblocks = jnp.where(entering[..., None, None, None, None], rows_in, pblocks)
        packed = _blocks_to_dense(pblocks, cb)
    else:
        ids2, idv2 = _compact_ids(entering.reshape(-1), compact_rows)
        grows = _rows3(a_packed[jnp.where(idv2, gslot[ids2], 0)])
        grows = shift_packed_coc(grows, _block_pos_vox(ids2, cb)[:, None, :])
        pbrows = _canvas_as_blocks(packed, cb).reshape(-1, VB_SIZE_, 3)
        pbrows = pbrows.at[jnp.where(idv2, ids2, nb)].set(grows, mode="drop")
        packed = _blocks_to_dense(
            pbrows.reshape(cb + (VB_WIDTH, VB_WIDTH, VB_WIDTH, 3)), cb)
    present = present | entering

    occ_val, vox_type, dist_sq, coc = unpack_voxels(packed)
    # re-anchor to the new canvas origin: entering blocks were written
    # new-anchored above; surviving voxels shift by -sv
    enter_vox = jnp.repeat(
        jnp.repeat(jnp.repeat(entering, VB_WIDTH, 0), VB_WIDTH, 1),
        VB_WIDTH, 2)
    cvalid = coc[..., 0] != COC_INVALID16
    adj = jnp.where(enter_vox[..., None], 0, sv.astype(jnp.int32))
    coc = jnp.where(cvalid[..., None],
                    (coc.astype(jnp.int32) - adj).astype(jnp.int16),
                    jnp.int16(COC_INVALID16))

    return dataclasses.replace(
        state,
        origin_blk=new_origin_blk,
        occ_val=occ_val, vox_type=vox_type, dist_sq=dist_sq, coc=coc,
        present=present,
        arch_keys=new_keys, n_arch=n_arch,
        a_packed=a_packed,
        arch_dropped=state.arch_dropped + dropped,
        dmax_cell=dmax_cell,
        p1c_ok=jnp.zeros((), jnp.bool_),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "k_cols"))
def stream_extract(state: MapState, changed_blk, carry_blk, rot=0, *,
                   cfg: MapConfig, k_cols: int):
    """Compact changed voxel blocks into archive-format rows for D2H
    streaming (streamPipeline equivalent, glb_hash_map.cu:209-247).

    The reference issues one small cudaMemcpy per changed block after a
    thrust sort/unique; here the changed set is compacted to (x,y)
    block-COLUMN granularity and extracted as packed uint32 rows in one
    gather.  The host starts an async copy and
    ingests the rows on the NEXT visualization tick, so the transfer rides
    under subsequent frame dispatches instead of stalling the pipeline.

    Args:
      changed_blk: bool [bx,by,bz] this frame's changed blocks (& present).
      carry_blk:   bool [bx,by,bz] blocks left over from previous ticks
                   (k_cols cap); OR-ed in, returned unserved.
      rot: int32 round-robin offset — service order is (rank - rot) mod
           ncols, so when more than k_cols columns change persistently every
           tick, every column is still served once per ceil(ncols/k_cols)
           ticks (bounded mirror staleness) instead of the rank-order tail
           starving forever.  The caller advances it by k_cols per tick.
      k_cols: static max block-columns per tick.

    Returns (col_ids [k], col_valid [k], rows [k*cbz,512,3] u32,
             blk_mask [k,cbz] bool, leftover_blk [bx,by,bz] bool).
    """
    cb = cfg.canvas_blocks
    cbx, cby, cbz = cb
    ncols = cbx * cby
    want = changed_blk | carry_blk
    col_changed = want.any(axis=2).reshape(-1)
    # rotated service order, one small sort: key = rot_rank * ncols + rank
    # (ncols^2 < 2^31 for every realistic canvas), so ids recover as key %
    # ncols and the served set is key <= k-th smallest (no scatter)
    rank = jnp.arange(ncols, dtype=jnp.int32)
    rot_rank = jnp.remainder(rank - rot, ncols)
    big = jnp.int32(ncols * ncols)
    key = jnp.where(col_changed, rot_rank * ncols + rank, big)
    skey = jax.lax.sort(key)[:k_cols]
    valid = skey < big
    ids = jnp.where(valid, skey % ncols, 0)
    served = col_changed & (key <= skey[k_cols - 1])
    leftover = want & ~served.reshape(cbx, cby, 1)

    with jax.named_scope("stream_extract"):
        packed = pack_voxels(state.occ_val, state.vox_type, state.dist_sq,
                             state.coc)
        bv = _dense_to_blocks(packed, cb).reshape(ncols, cbz, VB_SIZE_, 3)
        rows = bv[ids].reshape(k_cols * cbz, VB_SIZE_, 3)
    blk_mask = want.reshape(ncols, cbz)[ids] & valid[:, None]
    return ids, valid, rows, blk_mask, leftover


def np_unpack_voxels(rows: np.ndarray):
    """Host-side unpack of packed uint32 [...,3] rows (numpy mirror of
    unpack_voxels, for the streaming consumer)."""
    w0 = rows[..., 0]
    dist = (w0 & 0xFFFFF).astype(np.int32)
    occ = ((w0 >> 20) & 0xFF).astype(np.uint8)
    typ = ((w0 >> 28) & 0xF).astype(np.int8)
    cx = (rows[..., 1] & 0xFFFF).astype(np.uint16).view(np.int16)
    cy = ((rows[..., 1] >> 16) & 0xFFFF).astype(np.uint16).view(np.int16)
    cz = (rows[..., 2] & 0xFFFF).astype(np.uint16).view(np.int16)
    return occ, typ, dist, np.stack([cx, cy, cz], axis=-1)


def canvas_geometry(cfg: MapConfig, pvt: np.ndarray, motion=None):
    """Host-side: canvas origin (block-aligned) for a pivot.

    Returns (canvas_origin_blk int32[3], canvas_origin_vox int32[3],
    window_offset int32[3]) with window_offset = pvt - canvas_origin_vox.

    Placement is motion-biased (round 5, ROADMAP perf candidate 0): with
    `motion` (the pivot's per-frame delta) given, a fraction
    cfg.scroll_bias of each axis's position slack is placed AHEAD of the
    motion direction, so straight-line travel covers ~2*bias the distance
    between scrolls that centred placement gives.  bias=0.5 reproduces the
    centred split; the 0.75 default keeps a 25% reserve behind the robot so
    an immediate reversal doesn't scroll straight back (a host-side sim
    over the suite trajectories counted ugv 143 -> 95 scrolls / 8 loops).
    Placement is an implementation detail: window contents are pinned by
    tests regardless of where the canvas sits.
    """
    pvt = np.asarray(pvt, np.int64)
    # cocs are canvas-relative (re-anchored on scroll), so world extent is
    # bounded only by the int32 voxel coordinates themselves
    if np.abs(pvt).max() > (1 << 30):
        raise ValueError("pivot beyond +-2^30 voxels: int32 grid coordinates "
                         "would overflow")
    halo = cfg.halo_grids
    cb = np.asarray(cfg.canvas_blocks, np.int64)
    cs = cb * VB_WIDTH
    local = np.asarray(cfg.local_size, np.int64)
    # centred default: equal slack on both sides (placing at pvt-halo leaves
    # zero low-side slack and forces a scroll on the next negative step)
    centered = np.floor((pvt + local // 2 - cs // 2) / VB_WIDTH + 0.5).astype(np.int64)
    o_min = -(-(pvt + local + halo - cs) // VB_WIDTH)  # ceil div
    o_max = np.floor_divide(pvt - halo, VB_WIDTH)
    tgt = centered.copy()
    bias = getattr(cfg, "scroll_bias", 0.5)
    if motion is not None and bias != 0.5:
        m = np.asarray(motion)
        for ax in range(3):
            # headroom ahead of +ax motion grows as origin grows toward
            # o_max (off shrinks toward halo); -ax motion mirrors to o_min
            if m[ax] > 0:
                tgt[ax] = round(centered[ax]
                                + (o_max[ax] - centered[ax]) * (2 * bias - 1))
            elif m[ax] < 0:
                tgt[ax] = round(centered[ax]
                                + (o_min[ax] - centered[ax]) * (2 * bias - 1))
    origin_blk = np.clip(tgt, o_min, o_max)
    origin_vox = origin_blk * VB_WIDTH
    off = pvt - origin_vox
    assert np.all(off >= halo)
    assert np.all(off + local + halo <= cs), "window+halo must fit inside canvas"
    return origin_blk.astype(np.int32), origin_vox.astype(np.int32), off.astype(np.int32)
