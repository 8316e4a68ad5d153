"""Batched rank (Occ) queries over the segment-checkpointed BWT.

This is the hot primitive of the whole framework — the array replacement for
the reference's wavelet-tree walk + RLE-gamma bitvector scan
(/root/reference/src/main/wtree.c:635 bseq_rank, index.c:2037-2090).  One
rank(c, r) is: a scalar checkpoint gather + a SEG-wide vectorized
compare-and-count of the row's segment.  Batched over thousands of queries it
is two gathers and one vector reduction — no per-query control flow.

Design note: this gather-bound loop is plain JAX left to XLA; whether a
hand-written rank kernel pays on the GPU is an open measurement
(ROADMAP speed item 7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import ALPHA_SIZE
from ..fmindex import FMArrays

# ---------------------------------------------------------------------------
# Tier dispatch (all static, on dtypes/shapes):
#   * bwt dtype uint16  -> dense symbol rows
#   * bwt dtype uint32  -> bit-packed codes, 32//bits codes per word
#   * C shape != ALPHA_SIZE+1 -> dense per-index alphabet (alpha_map /
#     alpha_rev remapping at the op boundary) — the behavioral stand-in for
#     the reference's per-bucket Huffman character mapping (index.c:309,
#     inUse16 tables): unused symbols cost nothing anywhere in the index.
# ---------------------------------------------------------------------------


def seg_size(arrays: FMArrays) -> int:
    """Rows per segment (from the always-unpacked mark bitmap)."""
    return arrays.mark_bits.shape[1] * 32


def _bwt_row(arrays: FMArrays, s: jax.Array) -> jax.Array:
    """Serving-row gather for the row tiers.  With seg_slot set (paged
    serving, paged.PagedIndex), `bwt` is a device row CACHE and true
    segment ids map through the indirection — the driver guarantees
    every touched segment is mapped before dispatch (uncached segments
    point at dummy slot 0 and are never touched)."""
    if arrays.seg_slot is not None:
        s = jnp.take(arrays.seg_slot, s, axis=0)
    return jnp.take(arrays.bwt, s, axis=0)


def n_segments(arrays: FMArrays) -> int:
    """Segment count (vseg keeps checkpoints inside its serving rows and
    occ_ckpt is a 1-row dtype marker there).  Paged serving: `bwt` is a
    CACHE, so the true count comes from the seg_slot indirection."""
    if arrays.seg_slot is not None:
        return arrays.seg_slot.shape[0]
    if arrays.seg_nsym is not None:
        return arrays.bwt.shape[0]
    return arrays.occ_ckpt.shape[0]


def is_row_tier(arrays: FMArrays) -> bool:
    """One-row serving layout (vseg or vrle): per-segment symbol lists,
    marks + relative occ checkpoints inside the main row, overflow side
    table.  Every layout helper below (_vseg_*) serves both; the two
    tiers differ only in how the row's CODE AREA decodes."""
    return arrays.seg_nsym is not None


def is_vrle(arrays: FMArrays) -> bool:
    """Run-length coded row tier (round 4): the code area holds either u8
    RLE slots (seg_woff == -1) or fixed-width codes (seg_woff == 0);
    seg_rle is a [1, w_main] static marker."""
    return arrays.seg_rle is not None


def is_vseg(arrays: FMArrays) -> bool:
    """Fixed-width compressed serving tier (fmindex.FMArrays docstring)."""
    return is_row_tier(arrays) and not is_vrle(arrays)


def is_packed(arrays: FMArrays) -> bool:
    return arrays.bwt.dtype == jnp.uint32 and not is_row_tier(arrays)


def is_remapped(arrays: FMArrays) -> bool:
    return (arrays.C.shape[0] != ALPHA_SIZE + 1 or is_packed(arrays)
            or is_row_tier(arrays))


def alpha_count(arrays: FMArrays) -> int:
    """Dense alphabet size K (261 for identity tiers)."""
    return arrays.C.shape[0] - 1


def map_char(arrays: FMArrays, c: jax.Array) -> jax.Array:
    """Alphabet code -> dense code; invalid/absent symbols -> -1 (which
    counts nothing everywhere).  The ONE place the char-validity contract
    lives — identity tiers included."""
    ok = (c >= 0) & (c < ALPHA_SIZE)
    if not is_remapped(arrays):
        return jnp.where(ok, c, -1)
    return jnp.where(ok, arrays.alpha_map[jnp.where(ok, c, 0)], -1)


def unmap_char(arrays: FMArrays, c: jax.Array) -> jax.Array:
    """Dense code -> alphabet code."""
    if not is_remapped(arrays):
        return c
    return arrays.alpha_rev[c]


def _pack_geometry(arrays: FMArrays):
    """(per_word, bits) of the packed BWT, derived from shapes."""
    seg = seg_size(arrays)
    W = arrays.bwt.shape[1]
    per_word = -(-seg // W)
    return per_word, 32 // per_word


def gather_segments(arrays: FMArrays, s: jax.Array) -> jax.Array:
    """Dense int32[B, SEG] symbol rows for segment ids s (unpacking the
    bit-packed tiers in registers; pad slots of the packed tier hold an
    all-ones code >= K; vseg tail-pad rows decode to an arbitrary present
    code, which is safe because no query ever counts past row n)."""
    if is_row_tier(arrays):
        return _gather_segments_vseg(arrays, s)
    if not is_packed(arrays):
        return jnp.take(arrays.bwt, s, axis=0).astype(jnp.int32)
    seg = seg_size(arrays)
    words = jnp.take(arrays.bwt, s, axis=0)              # [B, W] uint32
    per_word, bits = _pack_geometry(arrays)
    mask = jnp.uint32((1 << bits) - 1)
    shifts = jnp.arange(per_word, dtype=jnp.uint32) * jnp.uint32(bits)
    vals = (words[:, :, None] >> shifts[None, None, :]) & mask
    return vals.reshape(words.shape[0], -1)[:, :seg].astype(jnp.int32)


class _VsegGeom:
    """Static layout of a row-tier main row (all derived from array
    shapes): [code area W | symbol list Wsym | mark words seg/32 |
    mark ckpt 1 | uint16-relative occ ckpts ceil(K/2)].

    vseg: the code area IS the fixed-width row (Wmode == W, w_main
    re-derived from W).  vrle: the code area is A words holding either
    u8 RLE slots or fixed w_main-bit codes (w_main from the seg_rle
    marker's shape; Wmode = the W-mode slice of the area)."""

    __slots__ = ("seg", "w_main", "W", "Wmode", "Wsym", "off_syms",
                 "off_mk", "Wmk", "off_mck", "off_rel", "w_side")

    def __init__(self, arrays: FMArrays):
        self.seg = seg_size(arrays)
        SMAX = arrays.seg_syms.shape[1]
        per = 2 if arrays.seg_syms.dtype == jnp.uint16 else 4
        self.Wsym = SMAX // per
        self.Wmk = self.seg // 32
        K = arrays.C.shape[0] - 1
        Wrel = -(-K // 2)
        total = arrays.bwt.shape[1]
        self.W = total - self.Wsym - self.Wmk - 1 - Wrel
        if arrays.seg_rle is not None:
            self.w_main = arrays.seg_rle.shape[1]
            self.Wmode = -(-self.seg // (32 // self.w_main))
        else:
            self.w_main = 32 // (-(-self.seg // self.W))
            self.Wmode = self.W
        self.off_syms = self.W
        self.off_mk = self.W + self.Wsym
        self.off_mck = self.off_mk + self.Wmk
        self.off_rel = self.off_mck + 1
        Ws = arrays.seg_ovf.shape[1]
        self.w_side = (32 // (-(-self.seg // Ws))
                       if arrays.seg_ovf.shape[0] > 1 else 8)


def _vseg_geom(arrays: FMArrays) -> _VsegGeom:
    return _VsegGeom(arrays)


def _l1_grp(arrays: FMArrays) -> int:
    """Segments per L1 checkpoint group, derived from shapes (the build
    pads n_seg to a multiple of the group, so the division is exact)."""
    return max(1, n_segments(arrays) // arrays.occ_l1.shape[0])


def _vseg_syms_from_row(arrays: FMArrays, row: jax.Array) -> jax.Array:
    """int32[B, SMAX] sorted symbol list unpacked from the gathered main
    row (pads = dtype max: never below a real code)."""
    g = _vseg_geom(arrays)
    SMAX = arrays.seg_syms.shape[1]
    wide = arrays.seg_syms.dtype == jnp.uint16
    per = 2 if wide else 4
    unit = 32 // per
    sw = row[:, g.off_syms: g.off_syms + g.Wsym]
    k = np.arange(SMAX)
    widx = jnp.asarray((k // per).astype(np.int32))
    shift = jnp.asarray(((k % per) * unit).astype(np.uint32))
    mask = jnp.uint32(0xFFFF if wide else 0xFF)
    return ((sw[:, widx] >> shift[None, :]) & mask).astype(jnp.int32)


def _vseg_base_from_row(arrays: FMArrays, row: jax.Array, s: jax.Array,
                        c: jax.Array) -> jax.Array:
    """Absolute occ base before segment s for dense code c: the
    uint16-relative checkpoint comes from the already-gathered row; only
    the small L1 point is a separate stream."""
    g = _vseg_geom(arrays)
    word = jnp.take_along_axis(
        row, (g.off_rel + c // 2)[:, None], axis=1)[:, 0]
    rel = (word >> ((c & 1).astype(jnp.uint32) * 16)) & jnp.uint32(0xFFFF)
    return (arrays.occ_l1[s // _l1_grp(arrays), c]
            + rel.astype(jnp.int32))


def _vseg_marks_from_row(arrays: FMArrays, row: jax.Array, r: jax.Array):
    """(is_marked bool[B], grank int32[B]) from the gathered row's mark
    words + mark-rank checkpoint."""
    g = _vseg_geom(arrays)
    words = row[:, g.off_mk: g.off_mk + g.Wmk]
    off = r % g.seg
    w_local = off // 32
    word = jnp.take_along_axis(words, w_local[:, None], axis=1)[:, 0]
    bit = ((word >> (r % 32).astype(jnp.uint32)) & jnp.uint32(1)) != 0
    widx = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
    full = jnp.where(widx < w_local[:, None], words, jnp.uint32(0))
    cnt = jnp.sum(jax.lax.population_count(full), axis=1).astype(jnp.int32)
    pmask = (jnp.uint32(1) << (r % 32).astype(jnp.uint32)) - jnp.uint32(1)
    part = jax.lax.population_count(word & pmask).astype(jnp.int32)
    mck = row[:, g.off_mck].astype(jnp.int32)
    return bit, mck + cnt + part


def _decode_static(words: jax.Array, w: int, seg: int) -> jax.Array:
    """[B, W] words at STATIC width w -> int32[B, seg] codes.  The word
    select uses constant indices (a broadcast/slice, not a data gather),
    so decode is pure vector work."""
    per_word = 32 // w
    pos = np.arange(seg)
    widx = jnp.asarray((pos // per_word).astype(np.int32))
    shift = jnp.asarray(((pos % per_word) * w).astype(np.uint32))
    word = words[:, widx]                                   # [B, seg]
    return ((word >> shift[None, :])
            & jnp.uint32((1 << w) - 1)).astype(jnp.int32)


def _swar_L(w: int) -> int:
    """Field-LSB mask: bit f*w set for every field f of a 32-bit word."""
    per = 32 // w
    return sum(1 << (f * w) for f in range(per))


def _count_eq_packed(words: jax.Array, w: int, lq: jax.Array,
                     off: jax.Array) -> jax.Array:
    """SWAR rank (round 5): #fields equal to lq among the first `off`
    w-bit fields of each lane's packed words — WITHOUT materializing the
    [B, seg] code grid.  Per word: XOR with the replicated query code,
    OR-reduce each field onto its LSB (shift reach capped at w-1 so
    fields never contaminate a neighbor's LSB), mask to the off-prefix,
    popcount.  ~3x fewer vector ops than the grid compare and 32/w x less
    intermediate data — the decode was the row tiers' serving bottleneck
    at seg >= 1024.  lq outside [0, 2^w) counts nothing."""
    per = 32 // w
    L = jnp.uint32(_swar_L(w))
    pat = lq.astype(jnp.uint32)[:, None] * L
    z = words ^ pat
    total, s = 0, 1
    while total < w - 1:
        step = min(s, w - 1 - total)
        z = z | (z >> jnp.uint32(step))
        total += step
        s *= 2
    eqbits = (~z) & L
    wi = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
    opw = off // per
    k = (off % per).astype(jnp.uint32)
    partial = L & ((jnp.uint32(1) << (k * jnp.uint32(w))) - jnp.uint32(1))
    mask = jnp.where(wi < opw[:, None], L,
                     jnp.where(wi == opw[:, None], partial[:, None],
                               jnp.uint32(0)))
    cnt = jnp.sum(jax.lax.population_count(eqbits & mask),
                  axis=1).astype(jnp.int32)
    valid = (lq >= 0) & (lq < (1 << w))
    return jnp.where(valid, cnt, 0)


def _field_at(words: jax.Array, w: int, off: jax.Array) -> jax.Array:
    """int32[B]: the w-bit field at position off of each lane's words
    (one take_along_axis, no grid)."""
    per = 32 // w
    W = words.shape[1]
    word = jnp.take_along_axis(
        words, jnp.minimum(off // per, W - 1)[:, None], axis=1)[:, 0]
    sh = ((off % per).astype(jnp.uint32) * jnp.uint32(w))
    return ((word >> sh) & jnp.uint32((1 << w) - 1)).astype(jnp.int32)


def _vrle_ws(nsym):
    """Per-segment RLE symbol width (serve-side twin of
    build_ops._vrle_ws): ceil(log2(max(nsym, 2))) capped at 6."""
    n = nsym.astype(jnp.int32)
    return (1 + (n > 2).astype(jnp.int32) + (n > 4) + (n > 8) + (n > 16)
            + (n > 32)).astype(jnp.int32)


# serve-side twin of build_ops.VRLE_SLOT_WIDTHS / _vrle_slot_geom
_VRLE_SLOT_WIDTHS = (6, 8, 10)


def _vrle_slot_geom(nsym):
    """(w_slot, lenbits): the sub-byte slot geometry, a pure function of
    the segment's symbol count (no extra storage)."""
    ws = _vrle_ws(nsym)
    w_slot = 6 + 2 * ((ws > 2).astype(jnp.int32) + (ws > 4).astype(jnp.int32))
    return w_slot, w_slot - ws


def _u8_stream(words: jax.Array) -> jax.Array:
    """uint32[B, W] -> uint32[B, 4W] little-endian byte stream (constant
    indices: a broadcast/slice, not a data gather)."""
    k = np.arange(words.shape[1] * 4)
    widx = jnp.asarray((k // 4).astype(np.int32))
    shift = jnp.asarray(((k % 4) * 8).astype(np.uint32))
    return (words[:, widx] >> shift[None, :]) & jnp.uint32(0xFF)


def _bit_slot_stream(words: jax.Array, w: int, NS: int) -> jax.Array:
    """uint32[B, Wtot] -> uint32[B, NS] w-bit little-endian bit fields
    (slot k = bits [k*w, k*w + w), straddling words; constant indices).
    Fields past the bit capacity are zero (len-0 padding slots)."""
    Wtot = words.shape[1]
    ns_real = (Wtot * 32) // w
    k = np.arange(min(NS, ns_real))
    wi = (k * w) >> 5
    sh = ((k * w) & 31).astype(np.uint32)
    wi2 = np.minimum(wi + 1, Wtot - 1)
    shd = jnp.asarray(sh)
    lo = words[:, jnp.asarray(wi.astype(np.int32))] >> shd[None, :]
    hi = jnp.where(
        shd[None, :] == 0, jnp.uint32(0),
        words[:, jnp.asarray(wi2.astype(np.int32))]
        << ((jnp.uint32(32) - shd) & jnp.uint32(31))[None, :])
    out = (lo | hi) & jnp.uint32((1 << w) - 1)
    if out.shape[1] < NS:
        out = jnp.concatenate(
            [out, jnp.zeros((out.shape[0], NS - out.shape[1]), jnp.uint32)],
            axis=1)
    return out


def vrle_has_rle(arrays: FMArrays) -> bool:
    """STATIC: does this vrle index contain any RLE/continuation rows?
    Encoded in the marker's leading dim (build: 3 = sub-byte slots,
    2 = legacy u8 slots, 1 = none) so pure fixed-width vrle indexes
    (zipf/DNA-shaped corpora) skip the slot machinery entirely and serve
    at vseg speed."""
    return arrays.seg_rle is not None and arrays.seg_rle.shape[0] > 1


def vrle_subbyte(arrays: FMArrays) -> bool:
    """STATIC: sub-byte (6/8/10-bit) slot scheme vs legacy u8 slots."""
    return arrays.seg_rle is not None and arrays.seg_rle.shape[0] >= 3


def vrle_flat_cont(arrays: FMArrays) -> bool:
    """STATIC: continuations live in a FLAT word store (seg_woff ==
    -(2 + word offset); serving gathers a fixed window) vs the per-row
    table of older indexes."""
    return arrays.seg_rle is not None and arrays.seg_rle.shape[0] >= 4


def _vrle_slots_from_row(arrays: FMArrays, row: jax.Array, s: jax.Array,
                         geom: "_VsegGeom"):
    """(lsym, slen, starts) int32[B, NS] slot view of RLE-mode rows (plus
    the continuation stream when present) — the HOT decode: rank and
    code-at reduce over slots directly (clamp-sum / one-hot), with no
    [B, seg] grid materialization and no per-step scatter.

    Sub-byte scheme (marker dim 3): the code-area words (main +
    continuation, concatenated at WORD level — a slot may straddle the
    boundary) are decoded by three STATIC-width extractors (6/8/10 bits,
    pure shifts on constant indices) and selected per lane by the
    segment's slot geometry.  Legacy u8 indexes keep the byte stream."""
    words = row[:, :geom.W]
    if vrle_flat_cont(arrays):
        # flat continuation store: fetch ngr whole GRANULE ROWS at the
        # segment's (granule-aligned) word offset — a [B, ngr] row
        # gather instead of an element-level window gather.  Non-continued lanes read offset 0
        # and lanes near the end read the zero guard rows — both decode
        # to slots that start at >= seg (every true stream's lengths sum
        # to exactly seg) and contribute nothing.
        G = arrays.seg_cont.shape[1]
        ngr = arrays.seg_rle.shape[0] - 3
        X = arrays.seg_cont.shape[0]
        woff = arrays.seg_woff[s]
        g0 = jnp.maximum(-woff - 2, 0) // G
        gidx = jnp.minimum(
            g0[:, None] + jnp.arange(ngr, dtype=jnp.int32)[None, :], X - 1)
        cw = jnp.take(arrays.seg_cont, gidx, axis=0)       # [B, ngr, G]
        words = jnp.concatenate(
            [words, cw.reshape(cw.shape[0], ngr * G)], axis=1)
    elif arrays.seg_cont is not None and arrays.seg_cont.shape[0] > 1:
        woff = arrays.seg_woff[s]
        cont_row = jnp.clip(-woff - 1, 0, arrays.seg_cont.shape[0] - 1)
        cw = jnp.take(arrays.seg_cont, cont_row, axis=0)
        words = jnp.concatenate([words, cw], axis=1)
    if vrle_subbyte(arrays):
        w_slot, lenbits = _vrle_slot_geom(arrays.seg_nsym[s])
        NS = (words.shape[1] * 32) // min(_VRLE_SLOT_WIDTHS)
        slots = _bit_slot_stream(words, _VRLE_SLOT_WIDTHS[0], NS)
        for w in _VRLE_SLOT_WIDTHS[1:]:
            slots = jnp.where((w_slot == w)[:, None],
                              _bit_slot_stream(words, w, NS), slots)
        lb = lenbits.astype(jnp.uint32)[:, None]
    else:
        slots = _u8_stream(words)
        ws = _vrle_ws(arrays.seg_nsym[s])
        lb = (8 - ws).astype(jnp.uint32)[:, None]
    lmask = (jnp.uint32(1) << lb) - jnp.uint32(1)
    lsym = (slots >> lb).astype(jnp.int32)
    slen = (slots & lmask).astype(jnp.int32)
    starts = jnp.cumsum(slen, axis=1) - slen
    return lsym, slen, starts


def _vrle_within(slot_view, lq: jax.Array, off: jax.Array) -> jax.Array:
    """#occurrences of local code lq among the first `off` positions."""
    lsym, slen, starts = slot_view
    contrib = jnp.clip(off[:, None] - starts, 0, slen)
    return jnp.sum(
        jnp.where(lsym == lq[:, None], contrib, 0), axis=1
    ).astype(jnp.int32)


def _vrle_code_at(slot_view, off: jax.Array) -> jax.Array:
    """Local code at offset `off` (0 for pad rows beyond the stream —
    an arbitrary present code, same contract as the fixed-width tiers)."""
    lsym, slen, starts = slot_view
    hit = (starts <= off[:, None]) & (off[:, None] < starts + slen)
    return jnp.sum(jnp.where(hit, lsym, 0), axis=1).astype(jnp.int32)


def _vrle_grid_from_row(arrays: FMArrays, row: jax.Array, s: jax.Array,
                        geom: "_VsegGeom") -> jax.Array:
    """Decode RLE-mode rows to the per-lane LOCAL code grid int32[B, seg]
    (cold path — gather_segments): take the slot view, scatter each
    slot's symbol at its start position and forward-fill (cummax of
    (start << 8 | sym+1)).  Position 0 of every real segment starts a
    slot, so real positions always fill; tail-pad rows decode to an
    arbitrary present code (same contract as the fixed-width tiers).

    Continuation segments (seg_woff == -(1 + cont_row)) concatenate their
    seg_cont words after the main stream inside _vrle_slots_from_row —
    padding slots have len 0 and contribute nothing, so non-continued
    lanes (reading the all-zero dummy row 0) are unaffected."""
    seg = geom.seg
    B = row.shape[0]
    lsym, slen, starts = _vrle_slots_from_row(arrays, row, s, geom)
    rowb = jax.lax.broadcasted_iota(jnp.int32, lsym.shape, 0)
    tgt = jnp.where(slen > 0, jnp.minimum(starts, seg), seg)
    pk = (starts << 8) | (lsym + 1)
    z = jnp.zeros((B, seg + 1), jnp.int32).at[rowb, tgt].set(
        pk, mode="drop")[:, :seg]
    filled = jax.lax.cummax(z, axis=1)
    return jnp.maximum(filled & 0xFF, 1) - 1


def _vseg_local_grid(arrays: FMArrays, s: jax.Array):
    """(codes int32[B, SEG] in PER-LANE space, is_side bool[B], main row
    uint32[B, W+Wsym]): one main row gather — which also carries the
    symbol list — plus a lax.cond side gather only when some lane's
    segment lives in the overflow table.  vrle rows additionally decode
    their RLE mode in-register (zero extra gathers)."""
    geom = _vseg_geom(arrays)
    seg = geom.seg
    row = _bwt_row(arrays, s)                         # [B, total] rows
    g = _decode_static(row[:, :geom.Wmode], geom.w_main, seg)
    if arrays.seg_rle is not None:
        g_rle = _vrle_grid_from_row(arrays, row, s, geom)
        mode_rle = arrays.seg_woff[s] < 0
        g = jnp.where(mode_rle[:, None], g_rle, g)
    ovf = arrays.seg_woff[s]
    is_side = ovf > 0
    if arrays.seg_ovf.shape[0] > 1:
        n_side = arrays.seg_ovf.shape[0]

        def with_side(g):
            side = jnp.take(arrays.seg_ovf,
                            jnp.clip(ovf, 0, n_side - 1), axis=0)
            gs = _decode_static(side, geom.w_side, seg)
            return jnp.where(is_side[:, None], gs, g)

        g = jax.lax.cond(jnp.any(is_side), with_side, lambda g: g, g)
    return g, is_side, row


def _row_ctx(arrays: FMArrays, s: jax.Array):
    """Hot-path per-lane decode context for the row tiers:
    (geom, row, side_row, is_side, mode_rle, slot_view).  Round 5: the
    [B, seg] code grid is GONE from the hot path — rank counts run as
    SWAR popcounts directly over the packed words (_count_eq_packed) and
    single-code reads are field extractions (_field_at); side rows are
    fetched once (zeros when no lane is overflow) and served the same
    way.  RLE-mode lanes serve from the slot view (clamp-sum).  Pure-W
    vrle indexes (vrle_has_rle False) skip the slot machinery
    statically."""
    geom = _vseg_geom(arrays)
    row = _bwt_row(arrays, s)
    ovf = arrays.seg_woff[s]
    is_side = ovf > 0
    side_row = None
    if arrays.seg_ovf.shape[0] > 1:
        n_side = arrays.seg_ovf.shape[0]
        Ws = arrays.seg_ovf.shape[1]

        def fetch(o):
            return jnp.take(arrays.seg_ovf,
                            jnp.clip(o, 0, n_side - 1), axis=0)

        def skip(o):
            # zeros DERIVED from the varying operand so both cond
            # branches agree on shard_map varying-axis types
            return jnp.zeros((s.shape[0], Ws), jnp.uint32) \
                + (o[:, None] & 0).astype(jnp.uint32)

        side_row = jax.lax.cond(jnp.any(is_side), fetch, skip, ovf)
    mode_rle = None
    sv = None
    if vrle_has_rle(arrays):
        mode_rle = ovf < 0
        sv = _vrle_slots_from_row(arrays, row, s, geom)
    return geom, row, side_row, is_side, mode_rle, sv


def _ctx_within(geom: "_VsegGeom", row, side_row, is_side, mode_rle, sv,
                lq: jax.Array, off: jax.Array) -> jax.Array:
    """#occurrences of per-lane code lq in the first `off` rows of each
    lane's segment, from the _row_ctx context (SWAR, no grid)."""
    w = _count_eq_packed(row[:, :geom.Wmode], geom.w_main, lq, off)
    if side_row is not None:
        ws = _count_eq_packed(side_row, geom.w_side, lq, off)
        w = jnp.where(is_side, ws, w)
    if sv is not None:
        w = jnp.where(mode_rle, _vrle_within(sv, lq, off), w)
    return w


def _ctx_code_at(geom: "_VsegGeom", row, side_row, is_side, mode_rle, sv,
                 off: jax.Array) -> jax.Array:
    """Per-lane code at in-segment offset `off` (LOCAL space for main
    lanes, GLOBAL for side lanes), from the _row_ctx context."""
    lc = _field_at(row[:, :geom.Wmode], geom.w_main, off)
    if side_row is not None:
        lc = jnp.where(is_side, _field_at(side_row, geom.w_side, off), lc)
    if sv is not None:
        lc = jnp.where(mode_rle, _vrle_code_at(sv, off), lc)
    return lc


def _vseg_query_code(arrays: FMArrays, row: jax.Array, is_side: jax.Array,
                     cd: jax.Array):
    """Per-lane-space code of dense code cd (side segments use global
    codes; absent symbols get a -1 sentinel that matches nothing).  The
    symbol list comes from the already-gathered main row."""
    syms = _vseg_syms_from_row(arrays, row)
    SMAX = syms.shape[1]
    ins = jnp.sum((syms < cd[:, None]).astype(jnp.int32), axis=1)
    at = jnp.take_along_axis(
        syms, jnp.minimum(ins, SMAX - 1)[:, None], axis=1)[:, 0]
    present = at == cd
    return jnp.where(is_side, cd, jnp.where(present, ins, -1))


def _gather_segments_vseg(arrays: FMArrays, s: jax.Array) -> jax.Array:
    """Generic (cold-path) vseg decode to GLOBAL dense codes: grid decode
    + per-position mapping through the segment symbol list.  Hot paths
    (_occ_dense / lf_grank_step) compare in LOCAL code space instead and
    skip the [B, SEG] mapping."""
    grid, is_side, row = _vseg_local_grid(arrays, s)
    syms = _vseg_syms_from_row(arrays, row)
    SMAX = syms.shape[1]
    mapped = jnp.take_along_axis(
        syms, jnp.clip(grid, 0, SMAX - 1), axis=1)
    return jnp.where(is_side[:, None], grid, mapped)


def bwt_code_at(arrays: FMArrays, r: jax.Array) -> jax.Array:
    """Dense BWT code at each row (int32[B])."""
    seg = seg_size(arrays)
    s = r // seg
    off = r - s * seg
    if is_row_tier(arrays):
        geom, rowm, side_row, is_side, mode_rle, sv = _row_ctx(arrays, s)
        lc = _ctx_code_at(geom, rowm, side_row, is_side, mode_rle, sv, off)
        syms = _vseg_syms_from_row(arrays, rowm)
        SMAX = syms.shape[1]
        cg = jnp.take_along_axis(
            syms, jnp.clip(lc, 0, SMAX - 1)[:, None], axis=1)[:, 0]
        return jnp.where(is_side, lc, cg)
    if not is_packed(arrays):
        return arrays.bwt[s, off].astype(jnp.int32)
    per_word, bits = _pack_geometry(arrays)
    word = arrays.bwt[s, off // per_word]
    shift = ((off % per_word) * bits).astype(jnp.uint32)
    return ((word >> shift) & jnp.uint32((1 << bits) - 1)).astype(jnp.int32)


def ckpt_base(arrays: FMArrays, s: jax.Array, c: jax.Array) -> jax.Array:
    """Absolute occurrence count before segment s for DENSE code c, under
    any checkpoint tier (dispatch is static: on occ_ckpt.dtype).

    The compact/packed/vseg tiers all use the uint16-relative scheme
    (the same bytes as int8 interpolation at L1_GROUP=16, one
    gather stream fewer per rank); vseg stores the relative row INSIDE
    the serving row (generic callers pay one row gather here — the hot
    paths share the row they already gathered)."""
    if is_row_tier(arrays):
        row = _bwt_row(arrays, s)
        return _vseg_base_from_row(arrays, row, s, c)
    if arrays.occ_ckpt.dtype == jnp.uint16:
        rel = arrays.occ_ckpt[s, c].astype(jnp.int32)
        return arrays.occ_l1[s // _l1_grp(arrays), c] + rel
    return arrays.occ_ckpt[s, c]


def _occ_dense_vseg(arrays: FMArrays, cd: jax.Array,
                    r: jax.Array) -> jax.Array:
    """vseg occ: compare in LOCAL code space (one main-row gather + the
    symbol-list row; no [B, SEG] global mapping)."""
    seg = seg_size(arrays)
    n_rows_total = n_segments(arrays) * seg
    valid = cd >= 0
    cc = jnp.where(valid, cd, 0)
    at_end = r >= n_rows_total
    s = jnp.minimum(r // seg, n_segments(arrays) - 1)
    off = r - s * seg
    geom, row, side_row, is_side, mode_rle, sv = _row_ctx(arrays, s)
    base = _vseg_base_from_row(arrays, row, s, cc)
    lq = _vseg_query_code(arrays, row, is_side, cc)
    within = _ctx_within(geom, row, side_row, is_side, mode_rle, sv,
                         lq, off)
    total = arrays.C[cc + 1] - arrays.C[cc]
    return jnp.where(valid, jnp.where(at_end, total, base + within), 0)


def _occ_dense(arrays: FMArrays, cd: jax.Array, r: jax.Array) -> jax.Array:
    """occ for dense codes; cd < 0 counts nothing."""
    if is_row_tier(arrays):
        return _occ_dense_vseg(arrays, cd, r.astype(jnp.int32))
    seg = seg_size(arrays)
    n_rows_total = n_segments(arrays) * seg
    valid = cd >= 0
    cc = jnp.where(valid, cd, 0)
    # r == n_rows_total happens for padded sharded indexes (row space fills
    # every segment exactly): occ(c, n_rows) = total count = C[c+1] - C[c]
    at_end = r >= n_rows_total
    s = jnp.minimum(r // seg, n_segments(arrays) - 1)
    off = r - s * seg
    base = ckpt_base(arrays, s, cc)                  # [B] gather(s)
    segdata = gather_segments(arrays, s)             # [B, SEG]
    iota = jax.lax.broadcasted_iota(jnp.int32, segdata.shape, 1)
    within = jnp.sum(
        (segdata == cc[:, None]) & (iota < off[:, None]), axis=1
    ).astype(jnp.int32)
    total = arrays.C[cc + 1] - arrays.C[cc]
    return jnp.where(valid, jnp.where(at_end, total, base + within), 0)


def occ(arrays: FMArrays, c: jax.Array, r: jax.Array) -> jax.Array:
    """occ[i] = #occurrences of c[i] in BWT[0 : r[i]).  c,r: int32[B];
    c in ALPHABET space.  Entries outside [0, ALPHA_SIZE) (or absent from
    the index) count nothing, so padded lanes are harmless."""
    c = c.astype(jnp.int32)
    cd = map_char(arrays, c)
    return _occ_dense(arrays, cd, r.astype(jnp.int32))


def backward_step_pair(arrays: FMArrays, c: jax.Array,
                       first: jax.Array, last: jax.Array):
    """One FM backward step for alphabet chars c: returns the new
    (first, last).  Absent/invalid chars yield an empty (0, 0) range.
    This is THE central step all engines share (server.c:769-777)."""
    c = c.astype(jnp.int32)
    cd = map_char(arrays, c)
    valid = cd >= 0
    base = arrays.C[jnp.where(valid, cd, 0)]
    o1 = _occ_dense(arrays, cd, first.astype(jnp.int32))
    o2 = _occ_dense(arrays, cd, last.astype(jnp.int32))
    z = jnp.zeros_like(first)
    return (jnp.where(valid, base + o1, z), jnp.where(valid, base + o2, z))


def occ2(arrays: FMArrays, c: jax.Array, r1: jax.Array, r2: jax.Array):
    """Fused pair rank for backward search: (occ(c,r1), occ(c,r2)), c in
    alphabet space."""
    c = c.astype(jnp.int32)
    cd = map_char(arrays, c)
    return (_occ_dense(arrays, cd, r1.astype(jnp.int32)),
            _occ_dense(arrays, cd, r2.astype(jnp.int32)))


def _occ_dense_parts(arrays: FMArrays, cd: jax.Array, r: jax.Array):
    """_occ_dense, also returning (segdata, base, s) so a second bound in
    the SAME segment can be served without another gather."""
    seg = seg_size(arrays)
    n_rows_total = n_segments(arrays) * seg
    valid = cd >= 0
    cc = jnp.where(valid, cd, 0)
    at_end = r >= n_rows_total
    s = jnp.minimum(r // seg, n_segments(arrays) - 1)
    off = r - s * seg
    base = ckpt_base(arrays, s, cc)
    segdata = gather_segments(arrays, s)
    iota = jax.lax.broadcasted_iota(jnp.int32, segdata.shape, 1)
    within = jnp.sum(
        (segdata == cc[:, None]) & (iota < off[:, None]), axis=1
    ).astype(jnp.int32)
    total = arrays.C[cc + 1] - arrays.C[cc]
    occ1 = jnp.where(valid, jnp.where(at_end, total, base + within), 0)
    return occ1, segdata, base, s


def occ2_shared(arrays: FMArrays, cd: jax.Array, r1: jax.Array,
                r2: jax.Array, compact_cap: int = 0):
    """(occ(cd, r1), occ(cd, r2)) for DENSE codes, serving r2 from r1's
    already-gathered segment row whenever both bounds share a segment.

    If gather ROWS are the count kernel's budget (a hypothesis to
    re-measure, PERF.md; there is no duplicate-row dedupe in hardware),
    the win requires actually issuing fewer rows: with compact_cap > 0
    the differing-segment lanes are compacted into a [compact_cap]
    sub-batch on device (cumsum + scatter, no host sync) and only those
    lanes gather a second segment row; when more than compact_cap lanes
    differ (early steps), a lax.cond falls back to the full-width second
    gather.  ~Converged searches (long patterns) issue ~half the rows."""
    occ1, segdata1, base1, s1 = _occ_dense_parts(arrays, cd, r1)
    seg = seg_size(arrays)
    n_rows_total = n_segments(arrays) * seg
    valid = cd >= 0
    cc = jnp.where(valid, cd, 0)
    at_end2 = r2 >= n_rows_total
    s2 = jnp.minimum(r2 // seg, n_segments(arrays) - 1)
    off2 = r2 - s2 * seg
    iota = jax.lax.broadcasted_iota(jnp.int32, segdata1.shape, 1)
    within2_shared = jnp.sum(
        (segdata1 == cc[:, None]) & (iota < off2[:, None]), axis=1
    ).astype(jnp.int32)
    total = arrays.C[cc + 1] - arrays.C[cc]
    same = (s2 == s1) & valid & ~at_end2
    o2_shared = base1 + within2_shared

    B = cd.shape[0]
    need = valid & ~at_end2 & ~same
    if compact_cap <= 0 or compact_cap >= B:
        o2_full = _occ_dense(arrays, cd, r2)
        o2 = jnp.where(same, o2_shared, o2_full)
        return occ1, jnp.where(valid, jnp.where(at_end2, total, o2), 0)

    nd = jnp.sum(need.astype(jnp.int32))

    def compacted(_):
        pos = jnp.cumsum(need.astype(jnp.int32)) - 1
        tgt = jnp.where(need & (pos < compact_cap), pos, compact_cap)
        sub_s = jnp.zeros((compact_cap + 1,), jnp.int32).at[tgt].set(
            s2, mode="drop")[:compact_cap]
        sub_c = jnp.zeros((compact_cap + 1,), jnp.int32).at[tgt].set(
            cc, mode="drop")[:compact_cap]
        sub_off = jnp.zeros((compact_cap + 1,), jnp.int32).at[tgt].set(
            off2, mode="drop")[:compact_cap]
        sub_base = ckpt_base(arrays, sub_s, sub_c)
        sub_seg = gather_segments(arrays, sub_s)
        sub_iota = jax.lax.broadcasted_iota(jnp.int32, sub_seg.shape, 1)
        sub_within = jnp.sum(
            (sub_seg == sub_c[:, None]) & (sub_iota < sub_off[:, None]),
            axis=1,
        ).astype(jnp.int32)
        sub_o = sub_base + sub_within                    # [cap]
        # lane i's answer sits at sub slot pos[i]
        return jnp.where(
            need, sub_o[jnp.clip(pos, 0, compact_cap - 1)], 0)

    def full(_):
        return jnp.where(need, _occ_dense(arrays, cd, r2), 0)

    o2_diff = jax.lax.cond(nd <= compact_cap, compacted, full, 0)
    o2 = jnp.where(same, o2_shared, o2_diff)
    return occ1, jnp.where(valid, jnp.where(at_end2, total, o2), 0)


def bwt_at(arrays: FMArrays, r: jax.Array) -> jax.Array:
    """BWT symbol at each row, in ALPHABET space (int32[B])."""
    return unmap_char(arrays, bwt_code_at(arrays, r))


def lf_step(arrays: FMArrays, r: jax.Array) -> jax.Array:
    """LF mapping: row of the suffix starting one position earlier.

    LF(r) = C[BWT[r]] + occ(BWT[r], r) — the reference's back_query
    (server.c:2228) as one batched op.
    """
    cd = bwt_code_at(arrays, r)
    return arrays.C[cd] + _occ_dense(arrays, cd, r)


def marked(arrays: FMArrays, r: jax.Array) -> jax.Array:
    """bool[B]: is row r mark-sampled?"""
    seg = seg_size(arrays)
    if is_row_tier(arrays):
        row = _bwt_row(arrays, r // seg)
        bit, _ = _vseg_marks_from_row(arrays, row, r)
        return bit
    words_per_seg = seg // 32
    w = r // 32
    word = arrays.mark_bits[w // words_per_seg, w % words_per_seg]
    return ((word >> (r % 32).astype(jnp.uint32)) & jnp.uint32(1)) != 0


def mark_rank(arrays: FMArrays, r: jax.Array) -> jax.Array:
    """#marked rows before row r (index into mark_vals)."""
    seg = seg_size(arrays)
    if is_row_tier(arrays):
        row = _bwt_row(arrays, r // seg)
        _, grank = _vseg_marks_from_row(arrays, row, r)
        return grank
    words_per_seg = seg // 32
    s = r // seg
    base = arrays.mark_ckpt[s]
    words = jnp.take(arrays.mark_bits, s, axis=0)  # [B, words_per_seg]
    widx = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
    local_word = (r % seg) // 32
    full = jnp.where(widx < local_word[:, None], words, jnp.uint32(0))
    cnt_full = jnp.sum(jax.lax.population_count(full), axis=1).astype(jnp.int32)
    word = words[jnp.arange(words.shape[0]), local_word]
    mask = (jnp.uint32(1) << (r % 32).astype(jnp.uint32)) - jnp.uint32(1)
    cnt_part = jax.lax.population_count(word & mask).astype(jnp.int32)
    return base + cnt_full + cnt_part


def mark_offset(arrays: FMArrays, granks: jax.Array) -> jax.Array:
    """Decode the stored text offset for mark rank g (int32[B]).

    The packed store (build_ops.mark_pack_geom / _pack_mark_vals) keeps
    grid marks as k = offset // period in `bits`-wide bit slots and the
    few non-grid marks (doc starts/SEOFs) as k = exc_base + j indexes
    into the int32 exception region appended to the same uint32 array;
    decode is two word gathers + shifts, executed ONCE per locate result
    (never inside the walk loop).  Legacy indexes (mark_meta None) store
    raw int32 offsets."""
    if arrays.mark_meta is None:
        return arrays.mark_vals[granks]
    mm = arrays.mark_meta
    bits = mm[0]
    exc_base = mm[1]
    period = mm[2]
    exc_off = mm[3]
    cap = mm[4]
    g = jnp.clip(granks, 0, cap - 1)
    bp = g * bits
    wi = bp >> 5
    sh = (bp & 31).astype(jnp.uint32)
    w1 = arrays.mark_vals[wi]
    w2 = arrays.mark_vals[wi + 1]
    lo = w1 >> sh
    hi = jnp.where(sh == 0, jnp.uint32(0),
                   w2 << ((jnp.uint32(32) - sh) & jnp.uint32(31)))
    mask = (jnp.uint32(1) << bits.astype(jnp.uint32)) - jnp.uint32(1)
    k = ((lo | hi) & mask).astype(jnp.int32)
    is_exc = k >= exc_base
    total = arrays.mark_vals.shape[0]
    eidx = jnp.clip(exc_off + (k - exc_base), 0, total - 1)
    exc = jax.lax.bitcast_convert_type(arrays.mark_vals[eidx], jnp.int32)
    return jnp.where(is_exc, exc, k * period)


def mark_value(arrays: FMArrays, r: jax.Array) -> jax.Array:
    """Sampled text offset stored for marked row r (undefined if unmarked)."""
    return mark_offset(arrays, mark_rank(arrays, r))


def lf_grank_step(arrays: FMArrays, r: jax.Array):
    """Fused locate step: one segment gather serves both the BWT symbol
    read and the in-segment occurrence count, alongside the mark bitmap
    lookups.  Returns (lf_row, is_marked, mark_rank) — the mark VALUE
    gather is deferred to one batched lookup after the walk (callers do
    mark_vals[grank]), cutting a gather stream from every loop iteration
    (gather rows are the locate budget)."""
    seg = seg_size(arrays)
    words_per_seg = seg // 32
    s = r // seg
    off = r - s * seg

    if is_row_tier(arrays):
        # ONE-row walk step: codes, the symbol map, the occ base, the
        # mark bit AND the mark rank all come from the same gathered row
        # (plus the small L1 point) — 5 gather streams collapsed to 2
        geom, rowm, side_row, is_side, mode_rle, sv = _row_ctx(arrays, s)
        lc = _ctx_code_at(geom, rowm, side_row, is_side, mode_rle, sv,
                          off)
        syms = _vseg_syms_from_row(arrays, rowm)
        SMAX = syms.shape[1]
        cg = jnp.take_along_axis(
            syms, jnp.clip(lc, 0, SMAX - 1)[:, None], axis=1)[:, 0]
        c = jnp.where(is_side, lc, cg)
        base = _vseg_base_from_row(arrays, rowm, s, c)
        within = _ctx_within(geom, rowm, side_row, is_side, mode_rle, sv,
                             lc, off)
        bit, grank = _vseg_marks_from_row(arrays, rowm, r)
        return arrays.C[c] + base + within, bit, grank

    segdata = gather_segments(arrays, s)                 # [B, SEG] int32
    c = segdata[jnp.arange(r.shape[0]), off]
    base = ckpt_base(arrays, s, c)                       # [B]
    iota = jax.lax.broadcasted_iota(jnp.int32, segdata.shape, 1)
    within = jnp.sum(
        (segdata == c[:, None]) & (iota < off[:, None]), axis=1
    ).astype(jnp.int32)
    lf = arrays.C[c] + base + within

    words = jnp.take(arrays.mark_bits, s, axis=0)            # [B, W]
    w_local = off // 32
    word = words[jnp.arange(r.shape[0]), w_local]
    bit = ((word >> (r % 32).astype(jnp.uint32)) & jnp.uint32(1)) != 0
    widx = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
    full = jnp.where(widx < w_local[:, None], words, jnp.uint32(0))
    cnt = jnp.sum(jax.lax.population_count(full), axis=1).astype(jnp.int32)
    pmask = (jnp.uint32(1) << (r % 32).astype(jnp.uint32)) - jnp.uint32(1)
    part = jax.lax.population_count(word & pmask).astype(jnp.int32)
    grank = arrays.mark_ckpt[s] + cnt + part
    return lf, bit, grank


def lf_mark_step(arrays: FMArrays, r: jax.Array):
    """lf_grank_step + immediate mark-value resolution (legacy wrapper)."""
    lf, bit, grank = lf_grank_step(arrays, r)
    return lf, bit, mark_offset(arrays, grank)
