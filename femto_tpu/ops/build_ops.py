"""On-device index assembly: BWT, occ checkpoints, mark sampling.

The reference's constructor (/root/reference/src/main/construct.c:41-160,
index.c:309-740 compress_bucket) serializes buckets CPU-side; here the whole
packaging is a handful of scatter/cumsum/gather passes that run on the
accelerator right after the suffix sort, so "build" stays on-device from raw
text to queryable index.

The assembly is split into several small jitted stages (BWT, occ, marks,
ISA) instead of one fused graph: very large fused graphs compile slowly,
while the stages compile in seconds and the intermediate arrays stay on
device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import ALPHA_SIZE, INVALID_ALPHA
from ..fmindex import FMArrays


def mark_cap(n: int, ndocs: int, mark_period: int, seg: int) -> int:
    """Static upper bound on the number of marked rows."""
    if mark_period == 0:
        # no sampled marks, but the SEOF-row compaction in _marks_finish
        # still needs room for the per-doc tag rows in its sorted prefix
        base = 2 * ndocs + 2
    else:
        base = n // mark_period + 2 * ndocs + 2
    return -(-base // 128) * 128


@functools.partial(jax.jit, static_argnames=("n", "n_pad"))
def _bwt_stage(text, sa, *, n, n_pad):
    prev = jnp.where(sa == 0, n - 1, sa - 1)
    bwt_chars = jnp.take(text, prev, axis=0).astype(jnp.int32)
    pad = jnp.full((n_pad - n,), INVALID_ALPHA, jnp.uint16)
    bwt = jnp.concatenate([bwt_chars.astype(jnp.uint16), pad])
    return bwt, bwt_chars


def _aux_positions(doc_starts, *, n, mark_period, ndocs):
    """Per-position aux word: bit0 = should_mark (index_types.h:134-144,
    via an O(n) cummax doc-start propagation), bits1.. = doc id + 1 at the
    doc's SEOF position.

    Degenerate (empty) docs — the trailing doc_starts padding of a
    shape-bucketed build (fmindex.build_index pad_shape) — are dropped
    from the SEOF scatter so their duplicate boundary offsets cannot
    overwrite the real last doc's tag."""
    idx = jnp.arange(n, dtype=jnp.int32)
    nonempty = doc_starts[1:] > doc_starts[:-1]
    seof_pos = jnp.where(nonempty, doc_starts[1:] - 1, n)
    tag = jnp.zeros((n,), jnp.int32).at[seof_pos].set(
        jnp.arange(1, ndocs + 1, dtype=jnp.int32), mode="drop"
    )
    if mark_period == 0:
        marked_pos = jnp.zeros((n,), bool)
    else:
        # GRID sampling (round 4): positions on the global grid
        # (idx % period == 0) plus doc starts/SEOFs.  The walk bound is
        # unchanged (any position reaches its grid point in < period LF
        # steps), and grid values are multiples of the period, so the
        # packed mark-value store (mark_pack_geom) needs only
        # ~log2(n/period) bits per mark instead of 32.
        is_start = jnp.zeros((n,), bool).at[doc_starts[:-1]].set(True)
        marked_pos = is_start | (tag > 0) | (idx % mark_period == 0)
    return marked_pos.astype(jnp.int32) | (tag << 1)


# aux co-packs with the 9-bit symbol in one int32 word iff the doc tag fits
_FUSE_DOC_LIMIT = 1 << 21


@functools.partial(jax.jit, static_argnames=("n", "mark_period", "ndocs"))
def build_sa_payload(text, doc_starts, *, n, mark_period, ndocs):
    """Suffix-sort payload whose pull IS the fused BWT + aux word.

    payload[p] = text[p-1 mod n] | aux[p] << 9, so suffix_array's
    pull[r] = payload[sa[r]] = (BWT symbol, mark/SEOF aux of row r) — the
    O(n) random gather of _bwt_aux_stage carried by the sort as one more
    payload operand."""
    aux = _aux_positions(doc_starts, n=n, mark_period=mark_period,
                         ndocs=ndocs)
    packed = text.astype(jnp.int32) | (jnp.roll(aux, -1) << 9)
    return jnp.roll(packed, 1)


@functools.partial(jax.jit, static_argnames=("n", "n_pad"))
def _split_pull(pull, *, n, n_pad):
    """(bwt uint16[n_pad], bwt_chars int32[n], a_row int32[n]) from the
    sort-carried pull words."""
    bwt_chars = pull & 511
    a_row = pull >> 9
    pad = jnp.full((n_pad - n,), INVALID_ALPHA, jnp.uint16)
    bwt = jnp.concatenate([bwt_chars.astype(jnp.uint16), pad])
    return bwt, bwt_chars, a_row


@functools.partial(
    jax.jit, static_argnames=("n", "n_pad", "mark_period", "ndocs")
)
def _bwt_aux_stage(text, sa, doc_starts, *, n, n_pad, mark_period, ndocs):
    """Fused BWT + mark/SEOF pull: ONE n-row random gather serves both.

    packed[p] = text[p] | aux[p+1 mod n] << 9, so gathering at
    prev = sa-1 (mod n) yields BWT[r] = text[sa[r]-1] in the low bits and
    aux[sa[r]] (the row's mark/SEOF info) in the high bits — halving the
    random-access passes of the build."""
    aux = _aux_positions(doc_starts, n=n, mark_period=mark_period,
                         ndocs=ndocs)
    packed = text.astype(jnp.int32) | (jnp.roll(aux, -1) << 9)
    prev = jnp.where(sa == 0, n - 1, sa - 1)
    pull = jnp.take(packed, prev, axis=0)
    bwt_chars = pull & 511
    a_row = pull >> 9
    pad = jnp.full((n_pad - n,), INVALID_ALPHA, jnp.uint16)
    bwt = jnp.concatenate([bwt_chars.astype(jnp.uint16), pad])
    return bwt, bwt_chars, a_row


def seg_hist(codes2d, alpha: int):
    """Per-segment symbol histogram int32[n_seg, alpha] of int32[n_seg,
    seg] symbol rows, by one scatter-add.  Symbols outside [0, alpha)
    (the -1 pads, INVALID_ALPHA in a narrower alphabet) count nothing."""
    rows = jax.lax.broadcasted_iota(jnp.int32, codes2d.shape, 0)
    cols = jnp.where((codes2d >= 0) & (codes2d < alpha), codes2d, alpha)
    return jnp.zeros((codes2d.shape[0], alpha), jnp.int32).at[
        rows, cols].add(1, mode="drop")


@functools.partial(jax.jit, static_argnames=("n_seg", "seg", "alpha"))
def _hist_stage(bwt_chars, *, n_seg, seg, alpha=ALPHA_SIZE):
    """Per-segment symbol histogram int32[n_seg, alpha] (see seg_hist)."""
    b2 = jnp.full((n_seg * seg,), -1, jnp.int32)
    b2 = jax.lax.dynamic_update_slice(b2, bwt_chars, (0,))
    return seg_hist(b2.reshape(n_seg, seg), alpha)


@functools.partial(jax.jit, static_argnames=("compact", "group"))
def _ckpt_stage(per_seg, *, compact=False, group=0):
    """C array + exclusive per-segment checkpoints from the histogram."""
    n_seg, alpha = per_seg.shape
    counts = per_seg.sum(axis=0)
    C = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts).astype(jnp.int32)]
    )
    occ_ckpt = jnp.concatenate(
        [
            jnp.zeros((1, alpha), jnp.int32),
            jnp.cumsum(per_seg[:-1], axis=0).astype(jnp.int32),
        ]
    )
    if not compact:
        return C, occ_ckpt, jnp.zeros((1, alpha), jnp.int32)
    from ..fmindex import L1_GROUP

    if group == 0:
        group = L1_GROUP
    n_grp = n_seg // group
    occ_l1 = occ_ckpt[::group][:n_grp]
    rel = occ_ckpt - jnp.repeat(occ_l1, group, axis=0)[:n_seg]
    return C, rel.astype(jnp.uint16), occ_l1


@functools.partial(
    jax.jit, static_argnames=("n", "n_seg", "seg", "compact", "alpha")
)
def _occ_stage(bwt_chars, *, n, n_seg, seg, compact=False, alpha=ALPHA_SIZE):
    from ..fmindex import l1_group_for
    per_seg = _hist_stage(bwt_chars, n_seg=n_seg, seg=seg, alpha=alpha)
    return _ckpt_stage(per_seg, compact=compact,
                       group=l1_group_for(seg) if compact else 0)


VSEG_SMAX = 32  # per-segment symbol-list capacity; K_s > SMAX -> identity

_to_u8 = jax.jit(lambda x: x.astype(jnp.uint8))
_to_u16 = jax.jit(lambda x: x.astype(jnp.uint16))


@functools.partial(jax.jit, static_argnames=("SMAX",))
def _stats_from_hist(per_seg_used, *, SMAX):
    """Per-segment sorted distinct codes from the dense histogram the
    checkpoint stage already computed: presence -> rank -> scatter of the
    column index.  Replaces the O(n) per-segment sort of
    _vseg_stats_stage with O(n_seg * K) work.
    Returns (syms int32[n_seg, SMAX] (pad = 2^20), nsym int32[n_seg],
    255 sentinel for > SMAX)."""
    PAD = 1 << 20
    n_seg = per_seg_used.shape[0]
    pres = per_seg_used > 0
    nsym = jnp.sum(pres.astype(jnp.int32), axis=1)
    rank = jnp.cumsum(pres.astype(jnp.int32), axis=1) - 1
    rowi = jax.lax.broadcasted_iota(jnp.int32, pres.shape, 0)
    codes = jax.lax.broadcasted_iota(jnp.int32, pres.shape, 1)
    tgt = jnp.where(pres & (rank < SMAX), rank, SMAX)
    syms = jnp.full((n_seg, SMAX + 1), PAD, jnp.int32).at[
        rowi, tgt].set(codes, mode="drop")[:, :SMAX]
    nsym_out = jnp.where(nsym > SMAX, 255, nsym)
    return syms, nsym_out


@functools.partial(jax.jit, static_argnames=("seg", "SMAX"))
def _vseg_stats_stage(codes2d, *, seg, SMAX):
    """Per-segment sorted distinct codes (device, chunked).

    codes2d: int32[n_seg, seg] dense global codes, tail pad > 2^20.
    Returns (syms int32[n_seg, SMAX] (pad = 2^20), nsym int32[n_seg];
    segments with > SMAX distinct report the identity sentinel 255)."""
    PAD = 1 << 20

    def chunk(codes):                                  # [CH, seg]
        CH = codes.shape[0]
        srt = jnp.sort(codes, axis=1)
        real = srt < PAD
        uniq = jnp.concatenate(
            [real[:, :1],
             (srt[:, 1:] != srt[:, :-1]) & real[:, 1:]], axis=1)
        nsym = jnp.sum(uniq.astype(jnp.int32), axis=1)
        ranks = jnp.cumsum(uniq.astype(jnp.int32), axis=1) - 1
        rowi = jax.lax.broadcasted_iota(jnp.int32, srt.shape, 0)
        tgt = jnp.where(uniq & (ranks < SMAX), ranks, SMAX)
        syms = jnp.full((CH, SMAX + 1), PAD, jnp.int32).at[
            rowi, tgt].set(srt, mode="drop")[:, :SMAX]
        nsym_out = jnp.where(nsym > SMAX, 255, nsym)
        return syms, nsym_out

    CH = 512
    n_seg = codes2d.shape[0]
    nch = -(-n_seg // CH)
    pad_rows = nch * CH - n_seg
    c3 = jnp.concatenate(
        [codes2d, jnp.full((pad_rows, seg), PAD, jnp.int32)]
    ).reshape(nch, CH, seg)
    syms, nsym = jax.lax.map(chunk, c3)
    return (syms.reshape(-1, SMAX)[:n_seg], nsym.reshape(-1)[:n_seg])


@functools.partial(jax.jit, static_argnames=("seg", "w", "SMAX", "side"))
def _vseg_pack_uniform(codes2d, syms, nsym, *, seg, w, SMAX, side):
    """Pack [n_seg, seg] codes at ONE static width w -> uint32[n_seg, W]
    (W = ceil(seg / (32 // w))).

    side=False: per-segment LOCAL codes (searchsorted in the segment's
    sorted symbol list); segments that don't fit width w (or are
    identity) pack as zeros — their data lives in the side table.
    side=True: GLOBAL dense codes (identity layout for the overflow
    rows; the caller gathers the rows it needs)."""
    PAD = 1 << 20
    per_word = 32 // w
    W = -(-seg // per_word)

    def chunk(args):
        codes, sy, ns = args
        CH = codes.shape[0]
        if side:
            lc = jnp.where(codes < PAD, codes, 0)
        else:
            lc = jnp.sum(
                (sy[:, None, :] < codes[:, :, None]).astype(jnp.int32),
                axis=2)
            fits = (ns <= (1 << w)) & (ns < 255)
            lc = jnp.where(fits[:, None] & (codes < PAD), lc, 0)
        row = W * per_word
        pad_cols = row - seg
        if pad_cols:
            lc = jnp.concatenate(
                [lc, jnp.zeros((CH, pad_cols), jnp.int32)], axis=1)
        c3 = lc.reshape(CH, W, per_word).astype(jnp.uint32)
        shifts = jnp.arange(per_word, dtype=jnp.uint32) * jnp.uint32(w)
        return jnp.sum(c3 << shifts[None, None, :], axis=2,
                       dtype=jnp.uint32)

    CH = 512
    n_seg = codes2d.shape[0]
    nch = -(-n_seg // CH)
    pad_rows = nch * CH - n_seg
    c3 = jnp.concatenate(
        [codes2d, jnp.full((pad_rows, seg), PAD, jnp.int32)]
    ).reshape(nch, CH, seg)
    s3 = jnp.concatenate(
        [syms, jnp.full((pad_rows, SMAX), PAD, jnp.int32)]
    ).reshape(nch, CH, SMAX)
    n3 = jnp.concatenate(
        [nsym, jnp.zeros((pad_rows,), jnp.int32)]).reshape(nch, CH)
    words = jax.lax.map(chunk, (c3, s3, n3))
    return words.reshape(-1, words.shape[-1])[:n_seg]


@functools.partial(jax.jit, static_argnames=("n", "n_seg", "seg"))
def _codes2d_stage(bwt_chars, used, *, n, n_seg, seg):
    """Dense global codes reshaped to [n_seg, seg]; tail pad > 2^20."""
    codes = map_codes(bwt_chars, used)
    full = jnp.full((n_seg * seg,), (1 << 20) + 7, jnp.int32)
    full = jax.lax.dynamic_update_slice(full, codes, (0,))
    return full.reshape(n_seg, seg)


def _vseg_width_for(seg: int, w: int):
    """(effective width, words per row) for candidate width w: W is what
    the row shape stores, and the query side re-derives the width as
    32 // ceil(seg / W) — so the build canonicalizes w UP to that value
    (same W, more bits per code; build and decode always agree)."""
    W = -(-seg // (32 // w))
    per_word = -(-seg // W)
    return 32 // per_word, W


def vseg_width_candidates(seg: int):
    """Deduped (w_eff, W) candidate main widths for the vseg tier."""
    out, seen = [], set()
    for w in (1, 2, 3, 4, 5):
        w_eff, W = _vseg_width_for(seg, w)
        if W not in seen:
            seen.add(W)
            out.append((w_eff, W))
    return out


def vseg_sym_store(w_main: int, wide: bool) -> int:
    """Stored symbol-list length: min(SMAX, 2^w_main) rounded up to the
    per-word packing unit (4 u8 / 2 u16 symbols per uint32)."""
    per = 2 if wide else 4
    return -(-min(VSEG_SMAX, 1 << w_main) // per) * per


def _vseg_sym_words(syms_i32, wide: bool):
    """Pack the per-segment sorted symbol lists int32[n_seg, SMAX] into
    uint32 row words (pads -> dtype max: never below a real code)."""
    n_seg, SMAX = syms_i32.shape
    per = 2 if wide else 4
    shift_unit = 32 // per
    symsv = jnp.minimum(syms_i32, 0xFFFF if wide else 0xFF).astype(
        jnp.uint32)
    shifts = (jnp.arange(per, dtype=jnp.uint32) * jnp.uint32(shift_unit))
    return jnp.sum(
        symsv.reshape(n_seg, SMAX // per, per) << shifts[None, None, :],
        axis=2, dtype=jnp.uint32)


def _vseg_rel_words(occ_rel):
    """Pack uint16-relative occ checkpoint rows [n_seg, K] into uint32
    pair words [n_seg, ceil(K/2)]."""
    n_seg, Kd = occ_rel.shape
    relw = occ_rel.astype(jnp.uint32)
    if Kd % 2:
        relw = jnp.concatenate(
            [relw, jnp.zeros((n_seg, 1), jnp.uint32)], axis=1)
    return relw[:, 0::2] | (relw[:, 1::2] << 16)


def _build_vseg(bwt_chars, per_seg_used, used, mark_bits, mark_ckpt,
                *, n, n_seg, seg):
    """Assemble the vseg v2 tier arrays.

    Layout (a gather's cost is per issued ROW, so the serving tier
    minimizes both row size and the NUMBER of gather streams per rank):

      * main: uint32[n_seg, W + Wsym + seg/32 + 1 + ceil(K/2)] — per
        row: the segment's codes at ONE width w_main (argmin over
        candidate widths of n_seg*W(w)*4 + overflow(w)*W_side*4, LOCAL
        to the segment's sorted symbol list), then the packed symbol
        list, the mark bitmap words, the mark-rank checkpoint, and the
        uint16-relative occ checkpoint row — ONE gathered row serves the
        whole rank AND the whole locate walk step (codes, symbol map,
        occ base, mark bit, mark rank); only the small L1 point and the
        deferred mark value live elsewhere;
      * side: uint32[n_ovf + 1, W_side] — overflow/identity segments at
        8-9 bits, GLOBAL dense codes, row 0 a dummy (gathered via
        lax.cond only when a lane touches an overflow segment);
      * checkpoints: the compact scheme (uint16 relative + int32 L1 group
        rows) — the same bytes as int8 interpolation at L1_GROUP=16
        but one gather stream fewer per rank;
      * seg_woff int32[n_seg]: 1-based side row, 0 = main; seg_nsym
        uint8[n_seg] (255 = overflow/identity); seg_syms is a [1, SMAX]
        dummy that carries SMAX and the u8/u16 symbol dtype statically.

    Returns (bwt_main, occ_ckpt, occ_l1, C, seg_ovf, seg_nsym, seg_woff,
    seg_syms)."""
    K = int(used.shape[0])
    used_dev = jnp.asarray(used)

    from ..fmindex import l1_group_for
    C, occ_ckpt, occ_l1 = _ckpt_stage(per_seg_used, compact=True,
                                      group=l1_group_for(seg))

    wide = K > 256
    w_side, Wside = _vseg_width_for(seg, 9 if wide else 8)
    codes2d = _codes2d_stage(bwt_chars, used_dev, n=n, n_seg=n_seg, seg=seg)
    syms_i32, nsym_i32 = _stats_from_hist(per_seg_used, SMAX=VSEG_SMAX)
    nsym_np = np.asarray(nsym_i32)                     # [n_seg] tiny pull

    best = None
    for w_eff, Wm in vseg_width_candidates(seg):
        cov = (nsym_np <= (1 << w_eff)) & (nsym_np < 255)
        bytes_w = n_seg * Wm * 4 + int((~cov).sum()) * Wside * 4
        if best is None or bytes_w < best[0]:
            best = (bytes_w, w_eff, cov)
    _, w_main, cov = best
    bwt_main = _vseg_pack_uniform(codes2d, syms_i32, nsym_i32, seg=seg,
                                  w=w_main, SMAX=VSEG_SMAX, side=False)
    # append the packed symbol list to each row (pads -> dtype max, which
    # never compares below a real code), then the mark words, the
    # mark-rank checkpoint, and the packed uint16 relative ckpts.
    # The stored list is RIGHT-SIZED to the segments that can actually
    # use it: covered segments have nsym <= 2^w_main, so only
    # min(SMAX, 2^w_main) entries are ever consulted (round 4 — halves
    # the per-row symbol cost on small-width corpora like DNA).
    s_store = vseg_sym_store(w_main, wide)
    sym_words = _vseg_sym_words(syms_i32[:, :s_store], wide)
    mck_w = mark_ckpt.astype(jnp.uint32)[:, None]
    rel_words = _vseg_rel_words(occ_ckpt)
    bwt_main = jnp.concatenate(
        [bwt_main, sym_words, mark_bits.astype(jnp.uint32), mck_w,
         rel_words], axis=1)
    occ_ckpt = occ_ckpt[:1]        # served from the rows; dummy keeps dtype

    ovf_idx = np.nonzero(~cov)[0].astype(np.int32)
    novf = int(ovf_idx.shape[0])
    seg_woff_np = np.zeros(n_seg, np.int32)
    seg_woff_np[ovf_idx] = np.arange(1, novf + 1, dtype=np.int32)
    if novf:
        codes_ovf = jnp.take(codes2d, jnp.asarray(ovf_idx), axis=0)
        dummy_s = jnp.zeros((novf, VSEG_SMAX), jnp.int32)
        dummy_n = jnp.zeros((novf,), jnp.int32)
        side_rows = _vseg_pack_uniform(codes_ovf, dummy_s, dummy_n,
                                       seg=seg, w=w_side, SMAX=VSEG_SMAX,
                                       side=True)
        seg_ovf = jnp.concatenate(
            [jnp.zeros((1, side_rows.shape[1]), jnp.uint32), side_rows])
    else:
        seg_ovf = jnp.zeros((1, 1), jnp.uint32)

    # dummy typed marker: carries the STORED list length + symbol dtype
    # in its shape/dtype (rank._VsegGeom derives row offsets from it)
    seg_syms = (_to_u16 if wide else _to_u8)(
        jnp.zeros((1, s_store), jnp.int32))
    return (bwt_main, occ_ckpt, occ_l1, C, seg_ovf, _to_u8(nsym_i32),
            jnp.asarray(seg_woff_np), seg_syms)


VRLE_SMAX = 64  # vrle symbol-list capacity (w_s <= 6 keeps len bits >= 2)


def vrle_ws_np(nsym: np.ndarray) -> np.ndarray:
    """Per-segment RLE symbol width w_s = ceil(log2(max(nsym, 2))),
    capped at 6 (so the u8 slot keeps >= 2 length bits)."""
    n = nsym.astype(np.int64)
    return (1 + (n > 2) + (n > 4) + (n > 8) + (n > 16) + (n > 32)).astype(
        np.int32)


def _vrle_ws(nsym):
    """Device edition of vrle_ws_np."""
    n = nsym.astype(jnp.int32)
    return (1 + (n > 2).astype(jnp.int32) + (n > 4) + (n > 8) + (n > 16)
            + (n > 32)).astype(jnp.int32)


# Sub-byte slot geometry: per-segment slot
# width from {6, 8, 10} bits instead of fixed u8 — w_slot and lenbits
# are FUNCTIONS of the segment's symbol width w_s, so no extra storage:
#   w_s 1-2 -> 6-bit slots, w_s 3-4 -> 8-bit, w_s 5-6 -> 10-bit;
#   lenbits = w_slot - w_s in {4, 5} (run cap 15/31 >= the measured
#   3.5-4.2 mean BWT run on real text).  The byte-aligned u8 slot paid
#   ~1.1 B/run where gamma pays ~0.6; 10-bit slots with a 15-run cap
#   cut the dominant prose case (w_s = 6: u8 had lenbits 2, cap 3 — a
#   mean run cost ~2 slots) to ~1.25 B/run in ONE slot.
VRLE_SLOT_WIDTHS = (6, 8, 10)

# Flat-continuation granule (words): continuation offsets align to this
# so serving fetches whole granule rows (row gather, not element gather)
VRLE_CONT_G = 16


def vrle_slot_geom_np(nsym: np.ndarray):
    """(w_slot, lenbits) per segment — host edition."""
    ws = vrle_ws_np(nsym)
    w_slot = 6 + 2 * ((ws > 2).astype(np.int32) + (ws > 4).astype(np.int32))
    return w_slot, w_slot - ws


def _vrle_slot_geom(nsym):
    """(w_slot, lenbits) per segment — device edition."""
    ws = _vrle_ws(nsym)
    w_slot = 6 + 2 * ((ws > 2).astype(jnp.int32) + (ws > 4).astype(jnp.int32))
    return w_slot, w_slot - ws


@functools.partial(jax.jit, static_argnames=("seg", "SMAX"))
def _vrle_slot_stats(codes2d, syms, nsym, *, seg, SMAX):
    """Per-segment RLE slot count at that segment's sub-byte slot
    geometry (device, chunked): runs of the LOCAL code sequence, long
    runs split at the slot's length capacity 2^lenbits - 1."""
    PAD = 1 << 20

    def chunk(args):
        codes, sy, ns = args
        CH = codes.shape[0]
        lc = jnp.sum((sy[:, None, :] < codes[:, :, None]).astype(jnp.int32),
                     axis=2)
        lc = jnp.where(codes < PAD, lc, 0)
        _, lenbits = _vrle_slot_geom(ns)
        maxlen = (jnp.int32(1) << lenbits) - 1               # [CH]
        iota = jax.lax.broadcasted_iota(jnp.int32, lc.shape, 1)
        brk = jnp.concatenate(
            [jnp.ones((CH, 1), bool), lc[:, 1:] != lc[:, :-1]], axis=1)
        run_start = jax.lax.cummax(jnp.where(brk, iota, 0), axis=1)
        is_slot = brk | ((iota - run_start) % maxlen[:, None] == 0)
        return jnp.sum(is_slot.astype(jnp.int32), axis=1)

    CH = 512
    n_seg = codes2d.shape[0]
    nch = -(-n_seg // CH)
    pad_rows = nch * CH - n_seg
    c3 = jnp.concatenate(
        [codes2d, jnp.full((pad_rows, seg), PAD, jnp.int32)]
    ).reshape(nch, CH, seg)
    s3 = jnp.concatenate(
        [syms, jnp.full((pad_rows, SMAX), PAD, jnp.int32)]
    ).reshape(nch, CH, SMAX)
    n3 = jnp.concatenate(
        [nsym, jnp.zeros((pad_rows,), jnp.int32)]).reshape(nch, CH)
    slots = jax.lax.map(chunk, (c3, s3, n3))
    return slots.reshape(-1)[:n_seg]


def _pack_bit_slots(vals, w: int, W: int):
    """Bit-pack slot values uint32[CH, NS] (< 2^w each) at STATIC width w
    into uint32[CH, W] words: slot k occupies bits [k*w, k*w + w), little
    endian, straddling word boundaries.  Two constant-index scatter-adds
    (slot fields never overlap, so add == or)."""
    CH, NS = vals.shape
    k = np.arange(NS)
    wi = ((k * w) >> 5).astype(np.int32)
    sh = ((k * w) & 31).astype(np.uint32)
    shd = jnp.asarray(sh)
    lo = vals << shd[None, :]                        # low 32 bits land here
    hi = jnp.where(shd[None, :] > 0,
                   vals >> ((jnp.uint32(32) - shd) & jnp.uint32(31))[None, :],
                   jnp.uint32(0))
    out = jnp.zeros((CH, W + 2), jnp.uint32)
    out = out.at[:, jnp.asarray(np.minimum(wi, W))].add(lo, mode="drop")
    out = out.at[:, jnp.asarray(np.minimum(wi + 1, W + 1))].add(
        hi, mode="drop")
    return out[:, :W]


@functools.partial(jax.jit, static_argnames=("seg", "SMAX", "A_words"))
def _vrle_pack_slots(codes2d, syms, nsym, *, seg, SMAX, A_words):
    """Pack each segment's runs into SUB-BYTE slots (local_sym << lenbits
    | len) at the segment's slot geometry (_vrle_slot_geom: 6/8/10-bit
    slots), len in [1, 2^lenbits - 1] (0 = padding contributing
    nothing).  Returns uint32[n_seg, A_words] (slots beyond the bit
    capacity drop — such segments are never served in RLE mode)."""
    PAD = 1 << 20
    NS_CAP = (A_words * 32) // min(VRLE_SLOT_WIDTHS)

    def chunk(args):
        codes, sy, ns = args
        CH = codes.shape[0]
        lc = jnp.sum((sy[:, None, :] < codes[:, :, None]).astype(jnp.int32),
                     axis=2)
        lc = jnp.where(codes < PAD, lc, 0)
        w_slot, lenbits = _vrle_slot_geom(ns)
        maxlen = (jnp.int32(1) << lenbits) - 1
        iota = jax.lax.broadcasted_iota(jnp.int32, lc.shape, 1)
        rowi = jax.lax.broadcasted_iota(jnp.int32, lc.shape, 0)
        brk = jnp.concatenate(
            [jnp.ones((CH, 1), bool), lc[:, 1:] != lc[:, :-1]], axis=1)
        run_start = jax.lax.cummax(jnp.where(brk, iota, 0), axis=1)
        is_slot = brk | ((iota - run_start) % maxlen[:, None] == 0)
        slot_idx = jnp.cumsum(is_slot.astype(jnp.int32), axis=1) - 1
        # a slot ends at the NEXT slot start (run breaks and maxlen
        # multiples are both slot starts, so lengths stay <= maxlen):
        # suffix-min of slot-start positions, shifted left — no run-length
        # scatter and no in-row gather
        idxs = jnp.where(is_slot, iota, seg)
        sm = jnp.flip(jax.lax.cummin(jnp.flip(idxs, axis=1), axis=1),
                      axis=1)
        nxt = jnp.concatenate(
            [sm[:, 1:], jnp.full((CH, 1), seg, jnp.int32)], axis=1)
        slot_len = nxt - iota
        val = ((lc.astype(jnp.uint32) << lenbits.astype(jnp.uint32)[:, None])
               | slot_len.astype(jnp.uint32))
        # per-segment slot capacity in slots at ITS width
        ns_lim = (A_words * 32) // w_slot                    # [CH]
        tgt = jnp.where(is_slot & (slot_idx < ns_lim[:, None]),
                        slot_idx, NS_CAP)
        grid = jnp.zeros((CH, NS_CAP + 1), jnp.uint32).at[
            rowi, tgt].set(val, mode="drop")[:, :NS_CAP]
        # three static bit-packers, selected per segment by its width
        packs = [_pack_bit_slots(grid, w, A_words) for w in VRLE_SLOT_WIDTHS]
        out = packs[0]
        for w, p in zip(VRLE_SLOT_WIDTHS[1:], packs[1:]):
            out = jnp.where((w_slot == w)[:, None], p, out)
        return out

    CH = 256
    n_seg = codes2d.shape[0]
    nch = -(-n_seg // CH)
    pad_rows = nch * CH - n_seg
    c3 = jnp.concatenate(
        [codes2d, jnp.full((pad_rows, seg), PAD, jnp.int32)]
    ).reshape(nch, CH, seg)
    s3 = jnp.concatenate(
        [syms, jnp.full((pad_rows, SMAX), PAD, jnp.int32)]
    ).reshape(nch, CH, SMAX)
    n3 = jnp.concatenate(
        [nsym, jnp.zeros((pad_rows,), jnp.int32)]).reshape(nch, CH)
    words = jax.lax.map(chunk, (c3, s3, n3))
    return words.reshape(-1, A_words)[:n_seg]


def vrle_plan(nsym_np: np.ndarray, slots_np: np.ndarray, *, seg: int,
              n_seg: int, wide: bool, Wside: int):
    """Host argmin over (w_main, A_words, C_words): per-segment mode =
    RLE u8 slots if the segment's (split-adjusted) run count fits the
    main code area (slots <= 4A), RLE + ONE continuation row if it fits
    4(A + C), else fixed w_main-bit codes if its alphabet fits, else the
    side table.  Continuations let A sit near the slot-count median
    instead of ~P95 (round 4: the uniform code area was the dominant
    cost on real text).  Returns (w_main, A_words, C_words, s_store,
    rle_np, cont_np, wfit_np)."""
    sym_b = 2 if wide else 1
    per = 2 if wide else 4
    rle_alpha = (nsym_np <= VRLE_SMAX) & (nsym_np < 255)
    # sub-byte slots: a segment's code-area demand is slots * w_slot BITS
    w_slot_np, _ = vrle_slot_geom_np(nsym_np)
    bits_np = slots_np.astype(np.int64) * w_slot_np
    best = None
    pcts = np.percentile(bits_np / 32.0,
                         [30, 40, 50, 60, 70, 80, 90, 95, 99]) \
        if n_seg else np.array([seg])
    for w_eff, Wm in vseg_width_candidates(seg):
        wfit = (nsym_np <= (1 << w_eff)) & (nsym_np < 255)
        a_cands = {Wm}
        for p in pcts:
            a_cands.add(max(int(np.ceil(p)), Wm))
        a_cands.add(seg // 4)
        for A in sorted(a_cands):
            if A > max(seg // 2, Wm):
                continue
            for C in (0, A // 2, A, 2 * A):
                if C > seg // 4 and C > A:
                    continue
                rle = rle_alpha & (bits_np <= A * 32)
                cont = (rle_alpha & ~rle
                        & (bits_np <= (A + C) * 32)) if C else \
                    np.zeros_like(rle)
                cov = rle | cont | wfit
                n_cov = int(cov.sum())
                smax_cov = int(nsym_np[cov].max()) if n_cov else 2
                s_store = -(-min(max(smax_cov, 2), VRLE_SMAX) // per) * per
                # continuations live in a FLAT word store (round 5): each
                # segment pays only its ACTUAL overflow words, so C is a
                # fetch-window bound, not a per-segment allocation
                cont_words = int(np.sum(
                    (-(-bits_np[cont] // 32)) - A)) if cont.any() else 0
                bytes_w = (n_seg * (A * 4 + s_store * sym_b)
                           + cont_words * 4
                           + int((~cov).sum()) * Wside * 4)
                if best is None or bytes_w < best[0]:
                    best = (bytes_w, w_eff, A, C, s_store, rle, cont, wfit)
    _, w_main, A_words, C_words, s_store, rle_np, cont_np, wfit_np = best
    return w_main, A_words, C_words, s_store, rle_np, cont_np, wfit_np


def _build_vrle(bwt_chars, per_seg_used, used, mark_bits, mark_ckpt,
                *, n, n_seg, seg):
    """Assemble the vrle tier: the vseg serving shape (ONE uniform main
    row per segment gathered per rank/walk step) with a RUN-LENGTH coded
    code area — the fixed-row answer to the reference's RLE-gamma bseq
    compression (wtree.c:359-770), which fixed-width rows cannot match
    on real text (BWT mean run length 3.5-4.2 on code/prose).

    Main row: [code area A_words | symbol list | mark words | mark ckpt |
    uint16-relative occ ckpts].  Per segment the code area holds EITHER
    sub-byte RLE slots (local_sym << lenbits | len at the segment's
    6/8/10-bit slot geometry, _vrle_slot_geom; long runs split) —
    seg_woff == -1 — or fixed w_main-bit codes (seg_woff == 0), with the
    global-code side table (seg_woff > 0) for segments neither covers.
    seg_rle is a dummy marking the tier (rank.is_vrle) and carrying the
    static W-mode width; its leading dim encodes the slot scheme
    (1 = no RLE rows, 2 = legacy u8 slots from older saved indexes,
    3 = sub-byte slots)."""
    K = int(used.shape[0])
    used_dev = jnp.asarray(used)

    from ..fmindex import l1_group_for
    C, occ_ckpt, occ_l1 = _ckpt_stage(per_seg_used, compact=True,
                                      group=l1_group_for(seg))

    wide = K > 256
    w_side, Wside = _vseg_width_for(seg, 9 if wide else 8)
    codes2d = _codes2d_stage(bwt_chars, used_dev, n=n, n_seg=n_seg, seg=seg)
    syms_i32, nsym_i32 = _stats_from_hist(per_seg_used, SMAX=VRLE_SMAX)
    slots_dev = _vrle_slot_stats(codes2d, syms_i32, nsym_i32, seg=seg,
                                 SMAX=VRLE_SMAX)
    nsym_np = np.asarray(nsym_i32)                     # [n_seg] tiny pulls
    slots_np = np.asarray(slots_dev)

    (w_main, A_words, C_words, s_store, rle_np, cont_np,
     wfit_np) = vrle_plan(
        nsym_np, slots_np, seg=seg, n_seg=n_seg, wide=wide, Wside=Wside)

    Wm = _vseg_width_for(seg, w_main)[1]
    w_rows = _vseg_pack_uniform(codes2d, syms_i32, nsym_i32, seg=seg,
                                w=w_main, SMAX=VRLE_SMAX, side=False)
    if Wm < A_words:
        w_rows = jnp.concatenate(
            [w_rows, jnp.zeros((n_seg, A_words - Wm), jnp.uint32)], axis=1)
    # pack slots to the FULL span (main + continuation), then split the
    # columns: the decode concatenates the streams back, so a split is
    # exactly a continuation row
    rle_full = _vrle_pack_slots(codes2d, syms_i32, nsym_i32, seg=seg,
                                SMAX=VRLE_SMAX, A_words=A_words + C_words)
    rle_rows = rle_full[:, :A_words]
    mode_rle = jnp.asarray(rle_np | cont_np)
    code_area = jnp.where(mode_rle[:, None], rle_rows, w_rows)

    # FLAT continuation store (round 5): each continuation segment pays
    # only its actual overflow words; serving gathers a fixed C_words
    # window at the segment's word offset (seg_woff == -(2 + off)).
    # Trailing window words belong to other segments and decode to
    # harmless slots: every true stream's slot lengths sum to exactly
    # seg, so bogus tail slots start at >= seg and can never contribute.
    cont_idx = np.nonzero(cont_np)[0].astype(np.int32)
    ncont = int(cont_idx.shape[0])
    ngr = 1
    if ncont and C_words:
        w_slot_np, _ = vrle_slot_geom_np(nsym_np)
        bits_np = slots_np.astype(np.int64) * w_slot_np
        cwords = (-(-bits_np[cont_idx] // 32) - A_words).astype(np.int64)
        # GRANULE alignment: offsets are multiples of VRLE_CONT_G words
        # so serving fetches whole granule ROWS (a [B, ngr] row gather
        # instead of an element-level window gather)
        G = VRLE_CONT_G
        cw_al = (-(-cwords // G)) * G
        offs = np.zeros(ncont + 1, np.int64)
        np.cumsum(cw_al, out=offs[1:])
        ngr = max(1, -(-C_words // G))
        total_pad = int(offs[-1]) + ngr * G        # guard rows
        cont_rows = jnp.take(rle_full[:, A_words:],
                             jnp.asarray(cont_idx), axis=0)
        flat = _flatten_ragged(
            cont_rows, jnp.asarray(cwords.astype(np.int32)),
            jnp.asarray(offs[:-1].astype(np.int32)),
            total_pad=total_pad, W=C_words, fill=0)
        seg_cont = flat.reshape(-1, G)
        cont_woffs = offs[:-1]
    else:
        seg_cont = jnp.zeros((1, 1), jnp.uint32)
        cont_woffs = np.zeros(0, np.int64)

    sym_words = _vseg_sym_words(syms_i32[:, :s_store], wide)
    mck_w = mark_ckpt.astype(jnp.uint32)[:, None]
    rel_words = _vseg_rel_words(occ_ckpt)
    bwt_main = jnp.concatenate(
        [code_area, sym_words, mark_bits.astype(jnp.uint32), mck_w,
         rel_words], axis=1)
    occ_ckpt = occ_ckpt[:1]

    cov = rle_np | cont_np | wfit_np
    ovf_idx = np.nonzero(~cov)[0].astype(np.int32)
    novf = int(ovf_idx.shape[0])
    seg_woff_np = np.zeros(n_seg, np.int32)
    seg_woff_np[rle_np] = -1
    # continuation segments: -(2 + flat word offset) — -1 stays "RLE, no
    # continuation" (the fetch window for those lanes reads offset 0 and
    # appends harmless slots; see the flat-store comment above)
    seg_woff_np[cont_idx] = -(2 + cont_woffs.astype(np.int32))
    seg_woff_np[ovf_idx] = np.arange(1, novf + 1, dtype=np.int32)
    if novf:
        codes_ovf = jnp.take(codes2d, jnp.asarray(ovf_idx), axis=0)
        dummy_s = jnp.zeros((novf, VRLE_SMAX), jnp.int32)
        dummy_n = jnp.zeros((novf,), jnp.int32)
        side_rows = _vseg_pack_uniform(codes_ovf, dummy_s, dummy_n,
                                       seg=seg, w=w_side, SMAX=VRLE_SMAX,
                                       side=True)
        seg_ovf = jnp.concatenate(
            [jnp.zeros((1, side_rows.shape[1]), jnp.uint32), side_rows])
    else:
        seg_ovf = jnp.zeros((1, 1), jnp.uint32)

    seg_syms = (_to_u16 if wide else _to_u8)(
        jnp.zeros((1, s_store), jnp.int32))
    # marker leading dim = the slot/continuation scheme: 3 + ngr =
    # sub-byte slots + FLAT continuation store fetched as ngr granule
    # rows of seg_cont.shape[1] words each; 3 = sub-byte without
    # continuations; 2 = legacy u8; 1 = no RLE rows — rank.vrle_has_rle
    # skips the slot machinery statically for pure fixed-width indexes
    has_rle = bool((rle_np | cont_np).any())
    scheme = (3 + ngr) if ncont else 3
    seg_rle = jnp.zeros((scheme if has_rle else 1, w_main), jnp.int32)
    return (bwt_main, occ_ckpt, occ_l1, C, seg_ovf, _to_u8(nsym_i32),
            jnp.asarray(seg_woff_np), seg_syms, seg_rle, seg_cont)


@functools.partial(jax.jit, static_argnames=("n", "n_seg", "seg"))
def _doc_lists_stage(sa, doc_starts, *, n, n_seg, seg):
    """Per-segment sorted unique doc ids, left-compacted, ON DEVICE — the
    chunk doc-lists of the reference's block format
    (block_format.txt:105-151, block_chunk_request index.c:2196), computed
    as one searchsorted + one [n_seg, seg] row sort instead of the former
    host O(n) numpy pass (pad/pad_shape rows drop out via sa >= n).
    Returns (vals int32[n_seg, seg] (-1 pads), counts int32[n_seg])."""
    npad = n_seg * seg
    BIG = jnp.int32(1 << 30)
    doc_of = (
        jnp.searchsorted(doc_starts, sa, side="right").astype(jnp.int32) - 1
    )
    doc_of = jnp.where(sa < n, doc_of, BIG)
    d = jnp.full((npad,), BIG, jnp.int32)
    d = jax.lax.dynamic_update_slice(d, doc_of, (0,))
    d2 = jnp.sort(d.reshape(n_seg, seg), axis=1)
    real = d2 < BIG
    uniq = jnp.concatenate(
        [real[:, :1], (d2[:, 1:] != d2[:, :-1]) & real[:, 1:]], axis=1)
    counts = jnp.sum(uniq.astype(jnp.int32), axis=1)
    ranks = jnp.cumsum(uniq.astype(jnp.int32), axis=1) - 1
    rowi = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0)
    tgt = jnp.where(uniq, ranks, seg)
    vals = jnp.full((n_seg, seg + 1), -1, jnp.int32).at[
        rowi, tgt].set(d2, mode="drop")[:, :seg]
    return vals, counts


@functools.partial(jax.jit, static_argnames=("total_pad", "W", "fill"))
def _flatten_ragged(vals2d, counts, woff, *, total_pad, W, fill=-1):
    """Compact per-row prefixes (row r contributes its first counts[r]
    entries at woff[r]) into one flat array (device scatter)."""
    j = jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = j < counts[:, None]
    idx = jnp.where(valid, woff[:, None] + j, total_pad)
    return jnp.full((total_pad + 1,), fill, vals2d.dtype).at[
        idx.reshape(-1)].set(vals2d.reshape(-1), mode="drop")[:total_pad]


def build_doc_lists_device(sa, doc_starts, *, n, n_seg, seg):
    """(offsets int64[n_seg+1], docs int32[total]) host arrays assembled
    from the device pass: only the per-segment counts (tiny) and the
    compacted list (~total entries, not O(n)) cross the host boundary."""
    vals, counts = _doc_lists_stage(sa, doc_starts, n=n, n_seg=n_seg,
                                    seg=seg)
    counts_np = np.asarray(counts).astype(np.int64)
    offsets = np.zeros(n_seg + 1, np.int64)
    np.cumsum(counts_np, out=offsets[1:])
    total = int(offsets[-1])
    total_pad = max(-(-total // 1024) * 1024, 1024)
    woff = jnp.asarray(offsets[:-1].astype(np.int32))
    flat = _flatten_ragged(vals, counts, woff, total_pad=total_pad, W=seg)
    return offsets, np.asarray(flat)[:total]


def _pack_widths(K: int):
    """(per_word, bits) for a dense alphabet of K codes: the pad value
    (all-ones in `bits`) must be >= K so it never matches a query code."""
    b0 = max(1, int(K).bit_length())
    per_word = 32 // b0
    bits = 32 // per_word      # canonical: query side derives bits this way
    return per_word, bits


CODE_TABLE = 512  # symbols (BWT codes, INVALID_ALPHA included) are < 512


def map_codes(x, used):
    """Symbols -> dense codes, code(x) = #used symbols < x (used is sorted
    unique, so a present symbol maps to its index in used), by one gather
    from a CODE_TABLE-entry table."""
    table = jnp.searchsorted(
        used, jnp.arange(CODE_TABLE, dtype=used.dtype), side="left"
    ).astype(jnp.int32)
    return jnp.take(table, x, mode="clip")


@functools.partial(
    jax.jit, static_argnames=("n", "n_seg", "seg", "per_word", "bits")
)
def _pack_stage(bwt_chars, used, *, n, n_seg, seg, per_word, bits):
    """Map BWT symbols to dense codes and bit-pack them into uint32 words,
    per segment (W = ceil(seg/per_word) words each)."""
    pad_code = (1 << bits) - 1
    codes = map_codes(bwt_chars, used)                # [n] dense codes
    W = -(-seg // per_word)
    row = W * per_word
    out = jnp.full((n_seg * row,), pad_code, jnp.int32)
    if row == seg:
        out = jax.lax.dynamic_update_slice(out, codes, (0,))
        c3 = out.reshape(n_seg, W, per_word)
    else:
        # segment rows are seg codes padded to W*per_word: scatter-free
        # reshape via a strided write of each segment's slice
        full = jnp.full((n_seg * seg,), pad_code, jnp.int32)
        full = jax.lax.dynamic_update_slice(full, codes, (0,))
        full = full.reshape(n_seg, seg)
        pad = jnp.full((n_seg, row - seg), pad_code, jnp.int32)
        c3 = jnp.concatenate([full, pad], axis=1).reshape(n_seg, W, per_word)
    shifts = jnp.arange(per_word, dtype=jnp.uint32) * jnp.uint32(bits)
    words = jnp.sum(
        c3.astype(jnp.uint32) << shifts[None, None, :],
        axis=2, dtype=jnp.uint32,
    )
    return words                                       # uint32[n_seg, W]


@functools.partial(jax.jit, static_argnames=("n", "mark_period", "ndocs"))
def _aux_gather_stage(sa, doc_starts, *, n, mark_period, ndocs):
    """Unfused fallback (doc tags too wide to co-pack with the symbol):
    a dedicated gather of the aux word through sa."""
    aux = _aux_positions(doc_starts, n=n, mark_period=mark_period,
                         ndocs=ndocs)
    return jnp.take(aux, sa, axis=0)


_RS_GROUP = 8  # bitmap words per rank-select group (256 rows)


def _mark_rank_select(mark_bits, n_marks, cap: int, n_limit: int):
    """(valid bool[cap], row int32[cap]): the row of each mark rank
    g < cap, by GROUP-granularity rank-select over the mark bitmap.

    The bitmap is viewed as groups of 8 words (256 rows).  The group of
    rank g = last group with group_ckpt <= g, computed by scattering the
    group id to position group_ckpt (n/256 rows; duplicates from empty
    groups resolve by max) + a cummax fill.  Each rank then pulls ONE
    fused [ckpt | 8 words] row and refines in-register: an 8-word
    popcount prefix picks the word, a 5-step in-word binary search picks
    the bit.  The fused row serves one gather stream where a word-level
    design needs two (word_ckpt[w] + words[w]), and the scatter shrinks
    8x.  searchsorted alternatives are ~log2(n/32) gather passes over cap
    lanes, and the n-row byte-key sort this machinery replaced was O(n)."""
    words_flat = mark_bits.reshape(-1)                  # [n_words] uint32
    nw = int(words_flat.shape[0])
    G = _RS_GROUP
    ngrp = -(-nw // G)
    if ngrp * G != nw:
        words_flat = jnp.concatenate(
            [words_flat, jnp.zeros((ngrp * G - nw,), jnp.uint32)]
        )
    wg = words_flat.reshape(ngrp, G)
    pc = jax.lax.population_count(wg).astype(jnp.int32)   # [ngrp, G]
    gtot = jnp.sum(pc, axis=1)
    gckpt = jnp.cumsum(gtot) - gtot                       # exclusive
    fused = jnp.concatenate(
        [gckpt.astype(jnp.uint32)[:, None], wg], axis=1
    )                                                     # [ngrp, 1+G]
    g = jnp.arange(cap, dtype=jnp.int32)
    s_at = (
        jnp.zeros((cap + 1,), jnp.int32)
        .at[jnp.minimum(gckpt, cap)]
        .max(jnp.arange(ngrp, dtype=jnp.int32), mode="drop")
        [:cap]
    )
    s = jax.lax.cummax(s_at)
    rows = jnp.take(fused, s, axis=0)                     # [cap, 1+G]
    rem = g - rows[:, 0].astype(jnp.int32)  # 0-based rank within group
    wrow = rows[:, 1:]
    pcr = jax.lax.population_count(wrow).astype(jnp.int32)
    cumr = jnp.cumsum(pcr, axis=1)                        # inclusive
    widx = jnp.sum((cumr <= rem[:, None]).astype(jnp.int32), axis=1)
    widx_c = jnp.minimum(widx, G - 1)
    iota = jax.lax.broadcasted_iota(jnp.int32, (cap, G), 1)
    sel = iota == widx_c[:, None]
    prev = jnp.sum(jnp.where((iota == widx_c[:, None] - 1), cumr, 0), axis=1)
    rem = rem - prev
    cur = jnp.sum(jnp.where(sel, wrow, jnp.uint32(0)), axis=1,
                  dtype=jnp.uint32)
    pos = jnp.zeros((cap,), jnp.int32)
    for half in (16, 8, 4, 2, 1):
        mask = jnp.uint32((1 << half) - 1)
        lowc = jax.lax.population_count(cur & mask).astype(jnp.int32)
        go_hi = rem >= lowc
        rem = jnp.where(go_hi, rem - lowc, rem)
        pos = pos + jnp.where(go_hi, half, 0)
        cur = jnp.where(go_hi, cur >> jnp.uint32(half), cur & mask)
    valid = g < n_marks
    row = (s * G + widx_c) * 32 + pos
    rowc = jnp.minimum(jnp.where(valid, row, 0), n_limit - 1)
    return valid, rowc


@functools.partial(
    jax.jit, static_argnames=("n", "n_pad", "seg", "cap", "ndocs",
                              "mark_period")
)
def _marks_finish(sa, a_row, *, n, n_pad, seg, cap, ndocs, mark_period=1):
    """Mark bitmap/checkpoints/values + per-doc SEOF rows from the row-order
    aux words (the random gather already happened in the suffix sort's
    payload pull or in _bwt_aux_stage).

    The mark-value compaction is RANK-SELECT, not a sort: for each mark
    rank g < cap, searchsorted over mark_ckpt finds its segment, then a
    word-level popcount scan + 5-step in-word binary search select its
    row — all cap-row (~n/mark_period) ops, no O(n) sort or scatter.
    Per-doc SEOF rows come from the selected rows' tags (every SEOF row is
    marked when sampling is on, index_types.h:134-144).  mark_period==0 keeps a sort-based path (its
    SEOF rows are unmarked; cap is tiny there)."""
    n_seg = n_pad // seg
    W = seg // 32
    marked_sa = (a_row & 1) != 0
    row_tag = a_row >> 1

    marked_row = jnp.concatenate(
        [marked_sa, jnp.zeros((n_pad - n,), dtype=bool)]
    )
    bits = marked_row.reshape(n_pad // 32, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    mark_bits = jnp.sum(bits * weights, axis=1, dtype=jnp.uint32).reshape(
        n_seg, W
    )
    per_seg_marks = (
        marked_row.reshape(n_seg, seg).sum(axis=1).astype(jnp.int32)
    )
    mark_ckpt = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(per_seg_marks[:-1])]
    ).astype(jnp.int32)
    n_marks = jnp.sum(per_seg_marks)

    if mark_period == 0:
        # no sampled marks: compact the (unmarked) SEOF tag rows with a
        # tiny byte-key sort to recover doc_seof_rows
        idx = jnp.arange(n, dtype=jnp.int32)
        key = jnp.where(row_tag > 0, 0, 1).astype(jnp.uint8)
        _, rows = jax.lax.sort((key, idx), num_keys=1)
        capn = min(cap, n)
        rr = rows[:capn]
        tags = row_tag[rr]
        lane = jnp.arange(capn, dtype=jnp.int32)
        live = lane < jnp.sum((row_tag > 0).astype(jnp.int32))
        doc_seof_rows = (
            jnp.zeros((ndocs + 1,), jnp.int32)
            .at[jnp.where(live & (tags > 0), tags - 1, ndocs)]
            .set(rr, mode="drop")[:ndocs]
        )
        mark_vals = jnp.full((cap,), -1, jnp.int32)
        return mark_bits, mark_ckpt, mark_vals, n_marks, doc_seof_rows

    valid, rowc = _mark_rank_select(mark_bits, n_marks, cap, n)
    # one fused 2-column gather serves both the SA value and the SEOF tag
    sa_tag = jnp.stack([sa.astype(jnp.int32), row_tag], axis=1)  # [n, 2]
    picked = sa_tag[rowc]                                        # [cap, 2]
    mark_vals = jnp.where(valid, picked[:, 0], -1)
    tags = jnp.where(valid, picked[:, 1], 0)
    doc_seof_rows = (
        jnp.zeros((ndocs + 1,), jnp.int32)
        .at[jnp.where(tags > 0, tags - 1, ndocs)]
        .set(rowc, mode="drop")[:ndocs]
    )
    return mark_bits, mark_ckpt, mark_vals, n_marks, doc_seof_rows


def mark_pack_geom(n: int, mark_period: int, ndocs: int, cap: int):
    """(bits, exc_base, exc_cap, n_words): static geometry of the packed
    mark-value store.

    Grid-sampled mark values (_aux_positions) are multiples of
    mark_period, so the store keeps k = value // period in `bits`-wide bit
    slots (bits ~ log2(n / period) instead of 32); the non-grid marks (doc
    starts/SEOFs, <= 2*ndocs of them) store k = exc_base + j, an index
    into an int32 exception region appended to the same uint32 array.
    The reference stores marked doc/offset pairs inside its compressed
    buckets (block_format.txt:105-151); here the savings matter because
    the mark-value stream is the one locate-support array that scales with
    n / period."""
    if mark_period == 0:
        return 1, 1, 1, 1
    exc_base = n // mark_period + 2
    exc_cap = 2 * ndocs + 2
    bits = max(int(np.ceil(np.log2(exc_base + exc_cap + 1))), 1)
    if bits > 31:
        raise ValueError("corpus too large for packed mark values")
    if cap * bits >= (1 << 31):
        raise ValueError(
            "packed mark store exceeds int32 bit addressing; raise "
            "mark_period or chunk the corpus"
        )
    n_words = (cap * bits + 31) // 32 + 1
    return bits, exc_base, exc_cap, n_words


@functools.partial(
    jax.jit, static_argnames=("cap", "bits", "exc_base", "exc_cap",
                              "period", "n_words")
)
def _pack_mark_vals(mark_vals, *, cap, bits, exc_base, exc_cap, period,
                    n_words):
    """Bit-pack the int32[cap] mark-value slots (-1 = empty) into
    uint32[n_words + exc_cap]: grid values as k = v // period at `bits`
    per slot, non-grid values as sentinel indexes into the int32
    exception region appended after the packed words.  Returns
    (packed uint32[n_words + exc_cap], mark_meta int32[5])."""
    mv = mark_vals.astype(jnp.int32)
    valid = mv >= 0
    on_grid = valid & (mv % period == 0)
    is_exc = valid & ~on_grid
    exc_rank = jnp.cumsum(is_exc.astype(jnp.int32)) - 1
    k = jnp.where(is_exc, exc_base + exc_rank, mv // period)
    k = jnp.where(valid, k, 0).astype(jnp.uint32)
    # register bit-transpose: 32 consecutive slots span exactly `bits`
    # words (32 * bits bits), so each group packs with STATIC shifts and
    # static column updates — no cap-wide scatter-add.  cap is a
    # multiple of 128, so the group reshape is exact.
    G = cap // 32
    kg = k.reshape(G, 32)
    acc = jnp.zeros((G, bits), jnp.uint32)
    for i in range(32):
        lo_w = (i * bits) >> 5
        sh = (i * bits) & 31
        acc = acc.at[:, lo_w].add(kg[:, i] << sh)
        spill = sh + bits - 32
        if spill > 0:
            acc = acc.at[:, lo_w + 1].add(kg[:, i] >> (32 - sh))
    words = jnp.concatenate(
        [acc.reshape(-1), jnp.zeros((n_words - G * bits,), jnp.uint32)])
    exc = (
        jnp.zeros((exc_cap,), jnp.int32)
        .at[jnp.where(is_exc, exc_rank, exc_cap)]
        .set(mv, mode="drop")
    )
    packed = jnp.concatenate(
        [words, jax.lax.bitcast_convert_type(exc, jnp.uint32)])
    meta = jnp.array([bits, exc_base, period, n_words, cap], jnp.int32)
    return packed, meta


def pack_mark_vals_np(mark_vals_np: np.ndarray, *, n: int, period: int,
                      ndocs: int, cap: int):
    """Host (numpy) edition of _pack_mark_vals for the host build path.
    Returns (packed uint32[n_words + exc_cap], mark_meta np.int32[5])."""
    if period == 0:
        meta = np.array([1, 1, 0, 1, cap], np.int32)
        return np.zeros(2, np.uint32), meta
    bits, exc_base, exc_cap, n_words = mark_pack_geom(n, period, ndocs, cap)
    mv = np.full(cap, -1, np.int64)
    mv[: mark_vals_np.shape[0]] = mark_vals_np
    valid = mv >= 0
    is_exc = valid & (mv % period != 0)
    exc_rank = np.cumsum(is_exc) - 1
    k = np.where(is_exc, exc_base + exc_rank, np.maximum(mv, 0) // period)
    k = np.where(valid, k, 0).astype(np.uint64)
    bp = np.arange(cap, dtype=np.int64) * bits
    wi = bp >> 5
    sh = (bp & 31).astype(np.uint64)
    words = np.zeros(n_words, np.uint64)
    np.add.at(words, wi, (k << sh) & 0xFFFFFFFF)
    # uint64 shift by 32 (sh == 0) is well-defined and yields 0 for
    # k < 2^31, so no masking dance is needed on the host side
    np.add.at(words, wi + 1, k >> (np.uint64(32) - sh))
    exc = np.zeros(exc_cap, np.int32)
    exc[exc_rank[is_exc]] = mv[is_exc]
    packed = np.concatenate(
        [words.astype(np.uint32), exc.view(np.uint32)])
    meta = np.array([bits, exc_base, period, n_words, cap], np.int32)
    return packed, meta


def build_fm_arrays_device(
    text: jax.Array,
    sa: jax.Array,
    doc_starts: jax.Array,
    *,
    n: int,
    seg: int,
    mark_period: int,
    ndocs: int,
    seg_multiple: int = 1,
    tier: str = "full",
    pull: jax.Array | None = None,
    alpha: np.ndarray | None = None,
) -> Tuple[FMArrays, jax.Array, int]:
    """Assemble FMArrays on device.

    Returns (arrays, n_marks scalar, alpha_used).  Tiers (FMArrays
    docstring): "full" (int32 absolute checkpoints), "compact" (uint16
    relative + int32 L1), "packed" (compact + dense per-index alphabet +
    bit-packed BWT words), "vseg" (compressed serving tier).

    pull: optional int32[n] fused BWT+aux words carried through the suffix
    sort (suffix_array(text, payload=build_sa_payload(...))); skips the
    O(n) random gather entirely.

    alpha: optional host array covering every symbol the BWT can contain
    (supersets fine; shape-padded builds must include the pad symbol 0) —
    the remapped tiers then skip the device histogram's host counts
    round-trip, which would stall a chunked build's pipeline."""
    from ..alphabet import ALPHA_SIZE as A
    from ..fmindex import l1_group_for

    if tier not in ("full", "compact", "packed", "vseg", "vrle"):
        raise ValueError(f"unknown tier {tier!r}")
    compact = tier in ("compact", "packed", "vseg", "vrle")
    n_seg = n // seg + 1
    n_seg = -(-n_seg // seg_multiple) * seg_multiple
    if compact:
        # the group adapts to the segment size (l1_group_for: uint16
        # relative checkpoints need seg * group <= 65535)
        n_seg = -(-n_seg // l1_group_for(seg)) * l1_group_for(seg)
    n_pad = n_seg * seg

    if pull is not None:
        if ndocs >= _FUSE_DOC_LIMIT:
            raise ValueError("fused pull requires ndocs < 2^21")
        bwt, bwt_chars, a_row = _split_pull(pull, n=n, n_pad=n_pad)
    elif ndocs < _FUSE_DOC_LIMIT:
        bwt, bwt_chars, a_row = _bwt_aux_stage(
            text, sa, doc_starts, n=n, n_pad=n_pad,
            mark_period=mark_period, ndocs=ndocs,
        )
    else:
        bwt, bwt_chars = _bwt_stage(text, sa, n=n, n_pad=n_pad)
        a_row = _aux_gather_stage(
            sa, doc_starts, n=n, mark_period=mark_period, ndocs=ndocs
        )
    cap = mark_cap(n, ndocs, mark_period, seg)
    mark_bits, mark_ckpt, mark_vals, n_marks, doc_seof_rows = _marks_finish(
        sa, a_row, n=n, n_pad=n_pad, seg=seg, cap=cap, ndocs=ndocs,
        mark_period=mark_period,
    )
    if mark_period == 0:
        mark_vals = jnp.zeros((2,), jnp.uint32)
        mark_meta = jnp.array([1, 1, 0, 1, cap], jnp.int32)
    else:
        bits, exc_base, exc_cap, n_words = mark_pack_geom(
            n, mark_period, ndocs, cap)
        mark_vals, mark_meta = _pack_mark_vals(
            mark_vals, cap=cap, bits=bits, exc_base=exc_base,
            exc_cap=exc_cap, period=mark_period, n_words=n_words)
    alpha_used = 0
    vseg_extra = {}
    if tier in ("packed", "vseg", "vrle"):
        if alpha is not None:
            # contract: alpha covers every BWT symbol — the text symbols
            # (each is someone's preceding character on the cyclic
            # string), INCLUDING the pad value 0 for shape-padded builds
            # (fmindex.build_index prepends it; only the caller knows the
            # real unpadded length)
            used = np.unique(np.asarray(alpha, np.int32))
            per_seg_used = None
        else:
            per_seg = _hist_stage(bwt_chars, n_seg=n_seg, seg=seg, alpha=A)
            counts = np.asarray(per_seg.sum(axis=0))   # [A] tiny transfer
            used = np.nonzero(counts > 0)[0].astype(np.int32)
            per_seg_used = per_seg[:, jnp.asarray(used)]
        K = int(used.shape[0])
        alpha_used = K
        alpha_map_np = np.full(A, -1, np.int32)
        alpha_map_np[used] = np.arange(K, dtype=np.int32)
        alpha_map = jnp.asarray(alpha_map_np)
        alpha_rev = jnp.asarray(used)
        if per_seg_used is None:
            # alphabet-wide histogram, used columns selected on device;
            # the host-alpha path's win is skipping the counts round-trip
            per_seg = _hist_stage(bwt_chars, n_seg=n_seg, seg=seg, alpha=A)
            per_seg_used = jnp.take(per_seg, jnp.asarray(used), axis=1)
        if tier in ("vseg", "vrle"):
            builder = _build_vseg if tier == "vseg" else _build_vrle
            (bwt_store, occ_ckpt, occ_l1, C, seg_ovf, seg_nsym, seg_woff,
             seg_syms, *rest) = builder(
                bwt_chars, per_seg_used, used, mark_bits, mark_ckpt,
                n=n, n_seg=n_seg, seg=seg,
            )
            vseg_extra = dict(seg_ovf=seg_ovf, seg_nsym=seg_nsym,
                              seg_woff=seg_woff, seg_syms=seg_syms)
            if rest:
                vseg_extra["seg_rle"] = rest[0]
                vseg_extra["seg_cont"] = rest[1]
            # marks and relative checkpoints live INSIDE the serving rows;
            # keep 1-row dummies that preserve seg_size()/dtype dispatch
            mark_bits = mark_bits[:1]
            mark_ckpt = mark_ckpt[:1]
        else:
            C, occ_ckpt, occ_l1 = _ckpt_stage(
                per_seg_used, compact=True, group=l1_group_for(seg))
            per_word, bits = _pack_widths(K)
            bwt_store = _pack_stage(
                bwt_chars, alpha_rev, n=n, n_seg=n_seg, seg=seg,
                per_word=per_word, bits=bits,
            )
    else:
        C, occ_ckpt, occ_l1 = _occ_stage(
            bwt_chars, n=n, n_seg=n_seg, seg=seg, compact=compact
        )
        alpha_map = jnp.arange(A, dtype=jnp.int32)
        alpha_rev = jnp.arange(A, dtype=jnp.int32)
        bwt_store = bwt.reshape(n_seg, seg)

    arrays = FMArrays(
        bwt=bwt_store,
        occ_ckpt=occ_ckpt,
        occ_l1=occ_l1,
        C=C,
        mark_bits=mark_bits,
        mark_ckpt=mark_ckpt,
        mark_vals=mark_vals,
        doc_starts=doc_starts,
        doc_seof_rows=doc_seof_rows,
        alpha_map=alpha_map,
        alpha_rev=alpha_rev,
        mark_meta=mark_meta,
        **vseg_extra,
    )
    return arrays, n_marks, alpha_used
