"""Sharded query execution: index rows distributed over the mesh.

The reference shards its index into blocks and routes leaf queries to block
owners (SURVEY.md §5.7, index.h:195-197 HDR_BSEARCH_BLOCK_ROWS); the mesh
analog shards the segment dimension of every row-indexed array and answers
each batched rank query cooperatively: the shard owning a row computes its
contribution, everyone else contributes zero, and one psum per step
broadcasts the result — queries ride collectives instead of a scheduler.

All functions here run INSIDE shard_map; `sharded_backward_search` wraps the
jit + shard_map plumbing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..alphabet import ALPHA_SIZE
from ..fmindex import FMArrays, FMMeta
from ..ops import rank as R
from . import bins
from .mesh import DEFAULT_AXIS

# Tier support: every helper below goes through ops/rank's
# ckpt_base/gather_segments dispatch with SHARD-LOCAL segment ids, so a
# shard's arrays behave exactly like a small single-device index whose
# checkpoints carry the global base (_package_shard lays them out that
# way).  full / compact / packed / vseg sharded tiers all serve queries;
# the vseg (compressed) tier gets fused one-row-gather branches below
# (its codes, symbol list, occ checkpoint, and mark info all ride one
# serving row — _package_shard_vseg).


def _map_char(arrays: FMArrays, c: jax.Array) -> jax.Array:
    """Alphabet char -> dense code (-1 = absent/invalid, counts nothing);
    the contract lives in rank.map_char."""
    return R.map_char(arrays, c)


def _vseg_local_occ(arrays: FMArrays, sl: jax.Array, cc: jax.Array,
                    off: jax.Array) -> jax.Array:
    """occ base + in-segment count for dense code cc at shard-LOCAL
    segment sl, row offset off — ONE main-row gather (the sharded twin of
    rank._occ_dense_vseg's hot path; occ_l1 rows carry the global base)."""
    geom, row, side_row, is_side, mode_rle, sv = R._row_ctx(arrays, sl)
    base = R._vseg_base_from_row(arrays, row, sl, cc)
    lq = R._vseg_query_code(arrays, row, is_side, cc)
    within = R._ctx_within(geom, row, side_row, is_side, mode_rle, sv,
                           lq, off)
    return base + within


def _occ_local_dense(arrays: FMArrays, nseg_local: int, axis: str,
                     cd: jax.Array, r: jax.Array) -> jax.Array:
    """Local contribution to occ(dense cd, r); psum'd by the caller."""
    seg = R.seg_size(arrays)
    D = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    n_rows_total = D * nseg_local * seg
    valid = cd >= 0
    cc = jnp.where(valid, cd, 0)
    # r == n_rows_total (the initial `last` of a padded sharded build) has
    # no owning segment: occ(c, n_rows) = total occurrences of c in the
    # BWT = C[c+1] - C[c]; shard 0 contributes it so the psum stays exact.
    at_end = valid & (r >= n_rows_total)
    s = r // seg
    sl = s - me * nseg_local
    mine = valid & (~at_end) & (sl >= 0) & (sl < nseg_local)
    sl = jnp.where(mine, sl, 0)
    off = r - s * seg
    total = arrays.C[cc + 1] - arrays.C[cc]
    if R.is_row_tier(arrays):
        v = _vseg_local_occ(arrays, sl, cc, off)
        return (jnp.where(mine, v, 0)
                + jnp.where(at_end & (me == 0), total, 0))
    base = R.ckpt_base(arrays, sl, cc)
    segdata = R.gather_segments(arrays, sl)
    iota = jax.lax.broadcasted_iota(jnp.int32, segdata.shape, 1)
    within = jnp.sum(
        (segdata == cc[:, None]) & (iota < off[:, None]), axis=1
    ).astype(jnp.int32)
    return (jnp.where(mine, base + within, 0)
            + jnp.where(at_end & (me == 0), total, 0))


def occ_sharded(arrays: FMArrays, nseg_local: int, axis: str,
                c: jax.Array, r: jax.Array) -> jax.Array:
    """occ over ALPHABET chars c (remapped per tier)."""
    cd = _map_char(arrays, c.astype(jnp.int32))
    return jax.lax.psum(
        _occ_local_dense(arrays, nseg_local, axis, cd, r), axis)


def backward_step_pair_sharded(arrays: FMArrays, nseg_local: int, axis: str,
                               c: jax.Array, first: jax.Array,
                               last: jax.Array):
    """One FM backward step over the mesh — the sharded twin of
    rank.backward_step_pair (absent chars yield empty (0, 0) ranges)."""
    cd = _map_char(arrays, c.astype(jnp.int32))
    valid = cd >= 0
    base = arrays.C[jnp.where(valid, cd, 0)]
    o1 = jax.lax.psum(
        _occ_local_dense(arrays, nseg_local, axis, cd, first), axis)
    o2 = jax.lax.psum(
        _occ_local_dense(arrays, nseg_local, axis, cd, last), axis)
    z = jnp.zeros_like(first)
    return (jnp.where(valid, base + o1, z), jnp.where(valid, base + o2, z))


def bwt_at_sharded(arrays: FMArrays, nseg_local: int, axis: str,
                   r: jax.Array) -> jax.Array:
    """Dense BWT code at row r (psum over the owner's contribution)."""
    seg = R.seg_size(arrays)
    me = jax.lax.axis_index(axis)
    s = r // seg
    sl = s - me * nseg_local
    mine = (sl >= 0) & (sl < nseg_local)
    rl = jnp.where(mine, sl, 0) * seg + jnp.clip(r - s * seg, 0, seg - 1)
    v = R.bwt_code_at(arrays, rl)
    return jax.lax.psum(jnp.where(mine, v, 0), axis)


def lf_step_sharded(arrays: FMArrays, nseg_local: int, axis: str,
                    r: jax.Array) -> jax.Array:
    cd = bwt_at_sharded(arrays, nseg_local, axis, r)
    return arrays.C[cd] + jax.lax.psum(
        _occ_local_dense(arrays, nseg_local, axis, cd, r), axis)


def _backward_search_body(arrays: FMArrays, pats: jax.Array, *, n: int,
                          row0: int, nseg_local: int, axis: str):
    B, P = pats.shape
    first = jnp.full(B, row0, dtype=jnp.int32)
    last = jnp.full(B, n, dtype=jnp.int32)
    cols = jnp.flip(pats, axis=1).T

    def step(carry, col):
        first, last = carry
        active = col >= 0
        nf, nl = backward_step_pair_sharded(
            arrays, nseg_local, axis, jnp.where(active, col, 0), first, last)
        first = jnp.where(active, nf, first)
        last = jnp.where(active, nl, last)
        return (first, last), None

    (first, last), _ = jax.lax.scan(step, (first, last), cols)
    return first, last


def _locate_body(arrays: FMArrays, rows: jax.Array, *, mark_period: int,
                 nseg_local: int, axis: str):
    """Sharded locate: LF-walk to marked rows with mark metadata sharded."""
    seg = R.seg_size(arrays)
    me = jax.lax.axis_index(axis)

    def mark_info(r):
        s = r // seg
        sl = s - me * nseg_local
        mine = (sl >= 0) & (sl < nseg_local)
        sl = jnp.where(mine, sl, 0)
        if R.is_row_tier(arrays):
            # mark words + GLOBAL-base mark ckpt ride the serving row;
            # the shard's mark_vals slot is grank - mark base
            # (mark_ckpt[0] carries the base, _package_shard_vseg)
            row = jnp.take(arrays.bwt, sl, axis=0)
            bit, grank = R._vseg_marks_from_row(arrays, row, r)
            is_m = jax.lax.psum(
                jnp.where(mine, bit.astype(jnp.int32), 0), axis) > 0
            lrank = grank - arrays.mark_ckpt[0]
            v = R.mark_offset(arrays, lrank)
            mv = jax.lax.psum(jnp.where(mine, v, 0), axis)
            return is_m, mv
        words = jnp.take(arrays.mark_bits, sl, axis=0)
        w_local = (r % seg) // 32
        widx = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
        full = jnp.where(widx < w_local[:, None], words, jnp.uint32(0))
        cnt = jnp.sum(jax.lax.population_count(full), axis=1).astype(jnp.int32)
        word = words[jnp.arange(words.shape[0]), w_local]
        bit = ((word >> (r % 32).astype(jnp.uint32)) & jnp.uint32(1)) != 0
        pmask = (jnp.uint32(1) << (r % 32).astype(jnp.uint32)) - jnp.uint32(1)
        part = jax.lax.population_count(word & pmask).astype(jnp.int32)
        grank = arrays.mark_ckpt[sl] + cnt + part
        is_m = jax.lax.psum(jnp.where(mine, bit.astype(jnp.int32), 0), axis) > 0
        # mark_vals is a PER-SHARD compaction (build_index_sharded's
        # _package_shard): the row's owner also owns its value at
        # grank - (global marks before this shard) = grank - mark_ckpt[0].
        lrank = grank - arrays.mark_ckpt[0]
        v = R.mark_offset(arrays, lrank)
        mv = jax.lax.psum(jnp.where(mine, v, 0), axis)
        return is_m, mv

    B = rows.shape[0]

    def body(i, st):
        rows, offs, done = st
        is_m, mv = mark_info(rows)
        hit = is_m & (~done)
        offs = jnp.where(hit, mv + i, offs)
        done = done | hit
        nxt = lf_step_sharded(arrays, nseg_local, axis, rows)
        rows = jnp.where(done, rows, nxt)
        return rows, offs, done

    offs0 = jnp.full(B, -1, dtype=jnp.int32)
    done0 = jnp.zeros(B, dtype=bool)
    _, offs, _ = jax.lax.fori_loop(0, mark_period + 1, body,
                                   (rows, offs0, done0))
    return offs


def _occ_owner_compute(arrays: FMArrays, nseg_local: int, axis: str,
                       rows: jax.Array, cd: jax.Array) -> jax.Array:
    """occ(dense cd, row) for requests routed to their owning shard (the
    shard's checkpoints carry the global base, so no psum is needed);
    requesters map chars to dense codes before routing."""
    seg = R.seg_size(arrays)
    D = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    n_rows_total = D * nseg_local * seg
    valid = cd >= 0
    c = jnp.where(valid, cd, 0)
    at_end = rows >= n_rows_total
    s = rows // seg
    sl = jnp.clip(s - me * nseg_local, 0, nseg_local - 1)
    off = rows - s * seg
    total = arrays.C[c + 1] - arrays.C[c]
    if R.is_row_tier(arrays):
        v = _vseg_local_occ(arrays, sl, c, off)
        return jnp.where(valid, jnp.where(at_end, total, v), 0)
    base = R.ckpt_base(arrays, sl, c)
    segdata = R.gather_segments(arrays, sl)
    iota = jax.lax.broadcasted_iota(jnp.int32, segdata.shape, 1)
    within = jnp.sum(
        (segdata == c[:, None]) & (iota < off[:, None]), axis=1
    ).astype(jnp.int32)
    return jnp.where(valid, jnp.where(at_end, total, base + within), 0)


def _backward_search_routed_body(arrays: FMArrays, pats_local: jax.Array,
                                 key: jax.Array, *, n: int, row0: int,
                                 nseg_local: int, cap: int, axis: str):
    """Owner-routed sharded count: each shard owns B/D query lanes and, per
    character step, routes its (row, char) rank requests to the shard
    owning the row (the shard lookup of index.h:195-197), which answers
    from local arrays — per-shard gather load drops ~D/3x vs the masked
    all-shard + psum scheme (every shard no longer computes every lane).
    Returns (first, last, overflow); hot-row skew can overflow the exchange
    capacity, reported for host-side retry with a larger cap."""
    D = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    B_local, P = pats_local.shape
    RR = 2 * B_local
    seg = R.seg_size(arrays)
    rows_per_shard = nseg_local * seg
    first0 = jnp.full(B_local, row0, dtype=jnp.int32)
    last0 = jnp.full(B_local, n, dtype=jnp.int32)
    cols = jnp.flip(pats_local, axis=1).T
    rid_local = me * RR + jnp.arange(RR, dtype=jnp.int32)

    def step(carry, xs):
        first, last, of = carry
        col, kkey = xs
        active = col >= 0
        # map to dense codes BEFORE routing (alpha tables are replicated)
        cd1 = _map_char(arrays, col.astype(jnp.int32))
        rows = jnp.concatenate([first, last])
        cc = jnp.concatenate([cd1, cd1])
        dest = jnp.minimum(rows // rows_per_shard, D - 1)
        recs, v, of1 = bins.valiant_exchange(
            dest, [rows, cc, rid_local], cap, axis, kkey
        )
        vals = _occ_owner_compute(
            arrays, nseg_local, axis,
            jnp.where(v, recs[0], 0), jnp.where(v, recs[1], -1),
        )
        back, v2, of2 = bins.valiant_exchange(
            recs[2] // RR, [recs[2], vals], cap, axis,
            jax.random.fold_in(kkey, 1), valid=v,
        )
        slot = jnp.where(v2, back[0] - me * RR, RR)
        o = jnp.zeros((RR,), jnp.int32).at[slot].set(back[1], mode="drop")
        o1, o2 = o[:B_local], o[B_local:]
        valid_c = cd1 >= 0
        base = arrays.C[jnp.where(valid_c, cd1, 0)]
        z = jnp.zeros_like(first)
        first = jnp.where(
            active, jnp.where(valid_c, base + o1, z), first)
        last = jnp.where(
            active, jnp.where(valid_c, base + o2, z), last)
        of = jnp.maximum(of, jnp.maximum(of1, of2))
        return (first, last, of), None

    keys = jax.random.split(key, P)
    init = jax.lax.pcast((first0, last0, jnp.int32(0)), (axis,),
                         to='varying')
    (first, last, of), _ = jax.lax.scan(step, init, (cols, keys))
    return first, last, jax.lax.pmax(of, axis)


def _locate_routed_body(arrays: FMArrays, rows_local: jax.Array,
                        key: jax.Array, *, mark_period: int,
                        nseg_local: int, cap: int, axis: str):
    """Owner-routed sharded locate: each shard owns B/D lanes; every LF
    step routes each lane's row to its owning shard, which answers with
    (lf_row, is_marked, mark_value) from purely local arrays (the shard
    that owns a row also owns its mark_vals entry).  Returns
    (offsets, overflow)."""
    D = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    B_local = rows_local.shape[0]
    seg = R.seg_size(arrays)
    rows_per_shard = nseg_local * seg
    rid_local = me * B_local + jnp.arange(B_local, dtype=jnp.int32)

    def owner_answer(r):
        """(lf, marked, mark_val) for rows this shard owns."""
        s = jnp.clip(r // seg, me * nseg_local,
                     me * nseg_local + nseg_local - 1)
        sl = s - me * nseg_local
        off = r - s * seg
        if R.is_row_tier(arrays):
            # fused one-row walk step (rank.lf_grank_step's vseg path with
            # shard-local ids): codes, symbol map, occ base, mark bit and
            # GLOBAL mark rank all from the same gathered serving row
            geom, rowm, side_row, is_side, mode_rle, sv = R._row_ctx(
                arrays, sl)
            offc = jnp.clip(off, 0, seg - 1)
            lc = R._ctx_code_at(geom, rowm, side_row, is_side, mode_rle,
                                sv, offc)
            syms = R._vseg_syms_from_row(arrays, rowm)
            SMAX = syms.shape[1]
            cg = jnp.take_along_axis(
                syms, jnp.clip(lc, 0, SMAX - 1)[:, None], axis=1)[:, 0]
            c = jnp.where(is_side, lc, cg)
            base = R._vseg_base_from_row(arrays, rowm, sl, c)
            within = R._ctx_within(geom, rowm, side_row, is_side,
                                   mode_rle, sv, lc, off)
            lf = arrays.C[c] + base + within
            bit, grank = R._vseg_marks_from_row(arrays, rowm, r)
            mv = R.mark_offset(arrays, grank - arrays.mark_ckpt[0])
            return lf, bit, mv
        segdata = R.gather_segments(arrays, sl)
        c = segdata[jnp.arange(r.shape[0]), jnp.clip(off, 0, seg - 1)]
        base = R.ckpt_base(arrays, sl, c)
        iota = jax.lax.broadcasted_iota(jnp.int32, segdata.shape, 1)
        within = jnp.sum(
            (segdata == c[:, None]) & (iota < off[:, None]), axis=1
        ).astype(jnp.int32)
        lf = arrays.C[c] + base + within
        words = jnp.take(arrays.mark_bits, sl, axis=0)
        w_local = jnp.clip(off, 0, seg - 1) // 32
        word = words[jnp.arange(r.shape[0]), w_local]
        bit = ((word >> (r % 32).astype(jnp.uint32)) & jnp.uint32(1)) != 0
        widx = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
        full = jnp.where(widx < w_local[:, None], words, jnp.uint32(0))
        cnt = jnp.sum(jax.lax.population_count(full), axis=1).astype(
            jnp.int32)
        pmask = ((jnp.uint32(1) << (r % 32).astype(jnp.uint32))
                 - jnp.uint32(1))
        part = jax.lax.population_count(word & pmask).astype(jnp.int32)
        grank = arrays.mark_ckpt[sl] + cnt + part
        mv = R.mark_offset(arrays, grank - arrays.mark_ckpt[0])
        return lf, bit, mv

    def body(i, st):
        rows, offs, done, of = st
        kkey = jax.random.fold_in(key, i)
        dest = jnp.minimum(rows // rows_per_shard, D - 1)
        recs, v, of1 = bins.valiant_exchange(
            dest, [rows, rid_local], cap, axis, kkey
        )
        lf, bit, mv = owner_answer(jnp.where(v, recs[0], me * rows_per_shard))
        ans = jnp.where(bit, mv, -1 - lf)   # >=0: offset; <0: next row
        back, v2, of2 = bins.valiant_exchange(
            recs[1] // B_local, [recs[1], ans], cap, axis,
            jax.random.fold_in(kkey, 1), valid=v,
        )
        slot = jnp.where(v2, back[0] - me * B_local, B_local)
        a = jnp.zeros((B_local,), jnp.int32).at[slot].set(
            back[1], mode="drop")
        hit = (a >= 0) & (~done)
        offs = jnp.where(hit, a + i, offs)
        done = done | hit
        rows = jnp.where(done, rows, -1 - a)
        of = jnp.maximum(of, jnp.maximum(of1, of2))
        return rows, offs, done, of

    offs0, done0, of0 = jax.lax.pcast(
        (jnp.full(B_local, -1, dtype=jnp.int32),
         jnp.zeros(B_local, dtype=bool), jnp.int32(0)), (axis,),
        to='varying')
    _, offs, _, of = jax.lax.fori_loop(
        0, mark_period + 1, body, (rows_local, offs0, done0, of0))
    return offs, jax.lax.pmax(of, axis)


def _specs_for_arrays(axis: str, arrays: FMArrays = None):
    """PartitionSpecs matching build_index_sharded's placement (occ_l1 is
    sharded for the compact/packed/vseg tiers, a replicated dummy for
    full).  The vseg tier shards its serving rows + overflow side table +
    per-segment side arrays; its occ_ckpt/mark_bits/seg_syms are 1-row
    dtype/shape markers (replicated) and mark_ckpt is the [D] per-shard
    global mark base (_package_shard_vseg)."""
    mm_spec = (None if (arrays is not None and arrays.mark_meta is None)
               else P())
    if arrays is not None and R.is_row_tier(arrays):
        vrle = R.is_vrle(arrays)
        return FMArrays(
            bwt=P(axis, None),
            occ_ckpt=P(),
            occ_l1=P(axis, None),
            C=P(),
            mark_bits=P(),
            mark_ckpt=P(axis),
            mark_vals=P(axis),
            doc_starts=P(),
            doc_seof_rows=P(),
            alpha_map=P(),
            alpha_rev=P(),
            seg_ovf=P(axis, None),
            seg_nsym=P(axis),
            seg_woff=P(axis),
            seg_syms=P(),
            mark_meta=mm_spec,
            seg_rle=P() if vrle else None,
            seg_cont=P(axis, None) if vrle else None,
        )
    l1_spec = P()
    if arrays is not None and arrays.occ_l1.shape[0] > 1:
        l1_spec = P(axis, None)
    return FMArrays(
        bwt=P(axis, None),
        occ_ckpt=P(axis, None),
        occ_l1=l1_spec,
        C=P(),
        mark_bits=P(axis, None),
        mark_ckpt=P(axis),
        mark_vals=P(axis),
        doc_starts=P(),
        doc_seof_rows=P(),
        alpha_map=P(),
        alpha_rev=P(),
        mark_meta=mm_spec,
    )


def sharded_backward_search(index, mesh: Mesh, pats: np.ndarray,
                            axis: str = DEFAULT_AXIS,
                            routed: bool = True,
                            cap_factor: float = 6.0,
                            max_retries: int = 3,
                            seed: int = 0):
    """Count ranges with the index sharded across `mesh`.

    pats: int32[B, P] right-aligned (-1 padded).  Returns (first, last).

    routed=True (default) partitions the query lanes over the mesh and
    routes each rank request to the shard owning its row (two Valiant
    exchanges per step) — per-shard gather load scales with B/D instead of
    B.  Hot-row skew (every lane probing the same row) can overflow the
    exchange capacity; the wrapper retries with doubled capacity and falls
    back to the masked-psum scheme as a last resort.
    """
    meta: FMMeta = index.meta
    D = mesh.devices.size
    nseg_local = meta.n_seg // D
    pats = np.asarray(pats)
    if routed:
        B = pats.shape[0]
        Bp = -(-B // D) * D
        pp = np.full((Bp, pats.shape[1]), -1, np.int32)
        pp[:B] = pats
        B_local = Bp // D
        cap = max(16, int(np.ceil(cap_factor * 2 * B_local / D)))
        cap_max = 2 * Bp
        for attempt in range(max_retries):
            fn = functools.partial(
                _backward_search_routed_body, n=meta.n_rows,
                row0=meta.row0, nseg_local=nseg_local,
                cap=min(cap, cap_max), axis=axis,
            )
            mapped = jax.shard_map(
                fn, mesh=mesh,
                in_specs=(_specs_for_arrays(axis, index.arrays), P(axis, None), P()),
                out_specs=(P(axis), P(axis), P()),
            )
            first, last, of = jax.jit(mapped)(
                index.arrays, jnp.asarray(pp),
                jax.random.PRNGKey(seed + attempt),
            )
            if int(jax.device_get(of)) <= 0:
                return first[:B], last[:B]
            cap *= 4
        # fall through to the masked-psum scheme (no capacity limits)
    fn = functools.partial(
        _backward_search_body, n=meta.n_rows, row0=meta.row0,
        nseg_local=nseg_local, axis=axis,
    )
    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(_specs_for_arrays(axis, index.arrays), P()),
        out_specs=(P(), P()),
    )
    return jax.jit(mapped)(index.arrays, jnp.asarray(pats))


def sharded_locate(index, mesh: Mesh, rows: np.ndarray,
                   axis: str = DEFAULT_AXIS,
                   routed: bool = True,
                   cap_factor: float = 6.0,
                   max_retries: int = 3,
                   seed: int = 0):
    """Locate rows against a mesh-sharded index.  routed=True (default)
    partitions the lanes and routes every LF step's request to the row's
    owning shard (per-shard gather load ~B/D); retries with larger exchange
    capacity on hot-row skew and falls back to the masked-psum walk."""
    meta: FMMeta = index.meta
    D = mesh.devices.size
    nseg_local = meta.n_seg // D
    rows = np.asarray(rows)
    if routed:
        B = rows.shape[0]
        Bp = -(-B // D) * D
        rr = np.zeros(Bp, np.int32)
        rr[:B] = rows
        B_local = Bp // D
        cap = max(16, int(np.ceil(cap_factor * B_local / D)))
        for attempt in range(max_retries):
            fn = functools.partial(
                _locate_routed_body, mark_period=meta.mark_period,
                nseg_local=nseg_local, cap=min(cap, Bp), axis=axis,
            )
            mapped = jax.shard_map(
                fn, mesh=mesh,
                in_specs=(_specs_for_arrays(axis, index.arrays), P(axis), P()),
                out_specs=(P(axis), P()),
            )
            offs, of = jax.jit(mapped)(
                index.arrays, jnp.asarray(rr),
                jax.random.PRNGKey(seed + attempt),
            )
            if int(jax.device_get(of)) <= 0:
                return offs[:B]
            cap *= 4
    fn = functools.partial(
        _locate_body, mark_period=meta.mark_period,
        nseg_local=nseg_local, axis=axis,
    )
    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(_specs_for_arrays(axis, index.arrays), P()),
        out_specs=P(),
    )
    return jax.jit(mapped)(index.arrays, jnp.asarray(rows))

# ---------------------------------------------------------------------------
# Sharded regex / query language: the device lockstep frontier
# (query/regexp_device._frontier_loop) runs REPLICATED inside shard_map —
# frontier state is identical on every device, and each backward step's
# rank lookups are answered cooperatively by one psum over the sharded
# arrays.  This serves every query type from distributed block storage,
# the analog of the reference's leaf-query routing (server.c regexp
# queries against remote blocks).
# ---------------------------------------------------------------------------


def _regexp_body(arrays, src, dst, mask, accept, costs0, *, cfg,
                 nseg_local, axis):
    from ..query.regexp_device import _frontier_loop

    def step(c, f, l):
        return backward_step_pair_sharded(arrays, nseg_local, axis, c, f, l)

    return _frontier_loop(step, src, dst, mask, accept, costs0, cfg)


def sharded_regexp_matches(index, mesh: Mesh, nfa, settings=None,
                           axis: str = DEFAULT_AXIS,
                           frontier_cap: int = 256,
                           results_cap: int = 4096,
                           max_len: int = 64):
    """Run the NFA frontier against a mesh-sharded index.  Returns
    deduped [RegexpMatch] (match strings empty — row ranges + costs)."""
    from ..query.ast import ApproxSettings
    from ..query.regexp import NO_COST, RegexpMatch, _start_costs, \
        dedupe_matches
    from ..query import regexp_device as RD

    if settings is None:
        settings = ApproxSettings.exact()
    meta: FMMeta = index.meta
    D = mesh.devices.size
    nseg_local = meta.n_seg // D
    src, dst, mask, accept, S_pad, T_pad = RD._nfa_device_arrays(nfa)
    c0 = np.full(S_pad, NO_COST, np.int32)
    c0[: nfa.num_states] = _start_costs(nfa, settings).astype(np.int32)
    costs0 = jnp.asarray(c0)
    del_rounds = (
        0 if settings.cost_bound <= 1
        else max(1, -(-settings.cost_bound // max(settings.delete_cost, 1)))
    )
    while True:
        cfg = RD._Static(
            n=meta.n_rows, row0=meta.row0, S=S_pad, T=T_pad,
            F=frontier_cap, R=results_cap, max_len=max_len,
            cost_bound=settings.cost_bound, subst=settings.subst_cost,
            delete=settings.delete_cost, insert=settings.insert_cost,
            del_rounds=del_rounds,
        )
        fn = functools.partial(_regexp_body, cfg=cfg,
                               nseg_local=nseg_local, axis=axis)
        mapped = jax.shard_map(
            fn, mesh=mesh,
            in_specs=(_specs_for_arrays(axis, index.arrays),
                      P(), P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P(), P(), P()),
        )
        rf, rl, rc, rlen, cnt, of = jax.jit(
            mapped, static_argnames=())(
            index.arrays, src, dst, mask, accept, costs0)
        if int(of) <= 0:
            break
        if (frontier_cap >= 16384 and results_cap >= 262144
                and max_len >= 1024):
            raise RuntimeError("sharded regex frontier overflow at caps")
        frontier_cap = min(frontier_cap * 4, 16384)
        results_cap = min(results_cap * 4, 262144)
        max_len = min(max_len * 4, 1024)
    cnt = int(cnt)
    rf = np.asarray(rf)[:cnt]
    rl = np.asarray(rl)[:cnt]
    rc = np.asarray(rc)[:cnt]
    return dedupe_matches(
        [RegexpMatch(int(f), int(l), int(c), b"")
         for f, l, c in zip(rf, rl, rc)]
    )


def sharded_term_ranges(index, mesh: Mesh, term, axis: str = DEFAULT_AXIS):
    """Row ranges (first, last, cost) of one query term against a sharded
    index: literal terms run the batched sharded backward search, regex /
    approx terms run the sharded frontier."""
    from ..alphabet import pattern_to_alpha
    from ..query.ast import as_literal
    from ..query.nfa import compile_nfa
    from ..query.planning import matches_empty, streamline
    from ..search import pack_patterns

    regexp = streamline(term.regexp)
    if matches_empty(regexp):
        return [(index.meta.row0, index.meta.n_rows, 0)]
    lit = as_literal(regexp)
    if lit is not None and term.approx.cost_bound <= 1:
        packed, _ = pack_patterns([pattern_to_alpha(lit)])
        first, last = sharded_backward_search(index, mesh, packed, axis)
        f, l = int(np.asarray(first)[0]), int(np.asarray(last)[0])
        return [(f, l, 0)] if l > f else []
    nfa = compile_nfa(regexp)
    matches = sharded_regexp_matches(index, mesh, nfa, term.approx, axis)
    return [(m.first, m.last, m.cost) for m in matches]


def sharded_count_query(index, mesh: Mesh, query: str,
                        icase: bool = False,
                        axis: str = DEFAULT_AXIS) -> int:
    """count_query against a mesh-sharded index: total matching positions
    for a term query (regex/approx included), matching-document count for
    Boolean queries (engine.count_query semantics, served entirely from
    the sharded arrays: ranges via psum frontier, offsets via
    sharded_locate)."""
    from ..query.engine import apply_icase
    from ..query.parser import parse_query
    from ..query.ast import QTerm
    from ..query.regexp import RegexpMatch, match_rows

    node = parse_query(query)
    if icase:
        node = apply_icase(node)
    if isinstance(node, QTerm):
        iv = match_rows(
            [RegexpMatch(f, l, c, b"")
             for f, l, c in sharded_term_ranges(index, mesh, node, axis)]
        )
        return sum(l - f for f, l in iv)
    res = _sharded_execute(index, mesh, node, axis)
    from ..query.engine import _warn_truncated

    _warn_truncated(res, query)
    return len(res.doc_set())


# Per-term work bound used ONLY when the caller opts out of full
# evaluation (full_eval=False): each Boolean operand then materializes at
# most this many rows and truncation is surfaced.  Full evaluation (the
# default) streams every row in SHARDED_LOCATE_WINDOW-row windows —
# reference semantics (full result sets, results.h:115-121).
SHARDED_TERM_CAP = 1_000_000

# Rows located per sharded-locate dispatch during full-evaluation
# streaming (bounds per-step device memory; engine.LOCATE_WINDOW analog).
SHARDED_LOCATE_WINDOW = 1 << 20


def _sharded_locate_docs(index, mesh, iv, axis, cap=None):
    """(docs, offsets, truncated) for a union of row intervals, via sharded
    locate.  cap=None streams ALL rows in SHARDED_LOCATE_WINDOW windows
    (never truncated); a positive cap bounds materialization and FLAGS
    truncation (the single-chip engine's full_eval=False behavior)."""
    from ..search import offsets_to_docs

    D = mesh.devices.size
    total = sum(l - f for f, l in iv)
    truncated = cap is not None and total > cap
    spans = []
    budget = cap
    for f, l in iv:
        take = l - f if budget is None else min(l - f, budget)
        if take <= 0:
            break
        for wf in range(f, f + take, SHARDED_LOCATE_WINDOW):
            spans.append((wf, min(wf + SHARDED_LOCATE_WINDOW, f + take)))
        if budget is not None:
            budget -= take
    if not spans:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), truncated
    docs_all, offs_all = [], []
    for wf, wl in spans:
        rows = np.arange(wf, wl, dtype=np.int32)
        pad = (-len(rows)) % D
        rowsp = np.concatenate([rows, np.full(pad, rows[0], np.int32)])
        offs = np.asarray(
            sharded_locate(index, mesh, rowsp, axis))[:len(rows)]
        d, o = offsets_to_docs(index, offs.astype(np.int64))
        docs_all.append(d)
        offs_all.append(o)
    return np.concatenate(docs_all), np.concatenate(offs_all), truncated


def _sharded_execute(index, mesh, node, axis, term_cap=None):
    """engine.execute against a sharded index: term results come from
    sharded ranges + sharded locate; Boolean combinators are the same
    host-side Results algebra (query/results.py).  term_cap=None (the
    default) evaluates operands in full."""
    from ..query.ast import QAnd, QNot, QOr, QTerm, QThen, QWithin
    from ..query.regexp import RegexpMatch, match_rows
    from ..query.results import Results, intersect, subtract, then_within, \
        union

    if isinstance(node, QTerm):
        ranges = sharded_term_ranges(index, mesh, node, axis)
        iv = match_rows([RegexpMatch(f, l, c, b"") for f, l, c in ranges])
        docs, offs, truncated = _sharded_locate_docs(index, mesh, iv, axis,
                                                     cap=term_cap)
        res = Results.from_doc_offsets(docs, offs)
        res.count = sum(l - f for f, l in iv)
        res.truncated = truncated
        return res
    a = _sharded_execute(index, mesh, node.left, axis, term_cap)
    b = _sharded_execute(index, mesh, node.right, axis, term_cap)
    if isinstance(node, QAnd):
        return intersect(a, b)
    if isinstance(node, QOr):
        return union(a, b)
    if isinstance(node, QNot):
        return subtract(a, b)
    if isinstance(node, QThen):
        return then_within(a, b, node.distance, ordered=True)
    if isinstance(node, QWithin):
        return then_within(a, b, node.distance, ordered=False)
    raise TypeError(node)


def sharded_docs_query(index, mesh: Mesh, query: str,
                       with_offsets: bool = True,
                       icase: bool = False,
                       max_matches: int = None,
                       axis: str = DEFAULT_AXIS,
                       full_eval: bool = True):
    """find_docs against a mesh-sharded index: list of (doc_id, info,
    offsets) — term ranges from the sharded engines, offsets from
    sharded locate, Boolean algebra on the host (engine.docs_query
    semantics).  full_eval=True (default) evaluates every term exactly
    (streamed, uncapped); full_eval=False bounds each term at
    SHARDED_TERM_CAP rows and flags truncation.  max_matches limits the
    returned docs."""
    from ..query.engine import apply_icase
    from ..query.parser import parse_query
    from ..query.results import ResultType

    node = parse_query(query)
    if icase:
        node = apply_icase(node)
    res = _sharded_execute(index, mesh, node, axis,
                           term_cap=None if full_eval else SHARDED_TERM_CAP)
    from ..query.engine import _warn_truncated

    _warn_truncated(res, query)
    out = []
    for d in res.doc_set():
        if with_offsets and res.type == ResultType.DOC_OFFSETS:
            offs = res.offsets[res.docs == d].tolist()
        else:
            offs = []
        out.append((int(d), index.infos[int(d)], offs))
        if max_matches is not None and len(out) >= max_matches:
            break
    return out
