"""Backward search, locate, and extraction as lockstep batched scans.

The reference runs each query as a continuation-passing state machine over
worker threads with row-sorted leaf-query batching (server.c:713-946,
3093-3340).  Here the batch dimension *is* the request batching: B queries
advance one character per step of a `lax.scan`, every step performing fused
batched rank lookups.  This collapses FEMTO's scheduler + RB-tree + block
cache into dense array ops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fmindex import FMArrays
from . import rank as R


def backward_search(arrays: FMArrays, n: int, pats: jax.Array,
                    row0: int = 0):
    """Batched FM count ranges.

    pats: int32[B, P], right-aligned (pattern ends at column P-1), padded on
    the left with -1.  Returns (first, last): int32[B] half-open row ranges;
    count = last - first.  Classic loop (server.c:769-777) with the
    [first,last) convention: first = C[c] + occ(c, first),
    last = C[c] + occ(c, last).  n is the total row count; row0 the first
    real row (non-zero only for padded sharded builds).
    """
    B, P = pats.shape
    first0 = jnp.full(B, row0, dtype=jnp.int32)
    last0 = jnp.full(B, n, dtype=jnp.int32)

    cols = jnp.flip(pats, axis=1).T  # [P, B]: last char first

    def step(carry, col):
        first, last = carry
        active = col >= 0
        nf, nl = R.backward_step_pair(arrays, col, first, last)
        first = jnp.where(active, nf, first)
        last = jnp.where(active, nl, last)
        return (first, last), None

    (first, last), _ = jax.lax.scan(step, (first0, last0), cols)
    return first, last


def backward_search_shared(arrays: FMArrays, n: int, pats: jax.Array,
                           row0: int = 0, compact_cap: int = None):
    """backward_search with the shared-segment pair rank (rank.occ2_shared):
    once a query's range fits one segment — most steps of long patterns —
    the `last` bound is served from `first`'s gathered row, and the
    remaining differing-segment lanes compact into a [compact_cap]
    sub-batch before their second gather (device-side, no host sync).
    A variant for the count-kernel row budget."""
    B, P = pats.shape
    if compact_cap is None:
        compact_cap = max(B // 2, 1)
    first0 = jnp.full(B, row0, dtype=jnp.int32)
    last0 = jnp.full(B, n, dtype=jnp.int32)
    cols = jnp.flip(pats, axis=1).T

    def step(carry, col):
        first, last = carry
        active = col >= 0
        c = col.astype(jnp.int32)
        cd = R.map_char(arrays, c)
        o1, o2 = R.occ2_shared(arrays, cd, first, last,
                               compact_cap=compact_cap)
        valid = cd >= 0
        base = arrays.C[jnp.where(valid, cd, 0)]
        z = jnp.zeros_like(first)
        nf = jnp.where(valid, base + o1, z)
        nl = jnp.where(valid, base + o2, z)
        first = jnp.where(active, nf, first)
        last = jnp.where(active, nl, last)
        return (first, last), None

    (first, last), _ = jax.lax.scan(step, (first0, last0), cols)
    return first, last


def backward_search_steps(arrays: FMArrays, n: int, pats: jax.Array,
                          row0: int = 0):
    """Like backward_search but also returns, per query, the last non-empty
    range and how many pattern chars matched before the range emptied — the
    reference's prev_first/prev_last "too few matches" reporting
    (server.c:830-941)."""
    B, P = pats.shape
    first0 = jnp.full(B, row0, dtype=jnp.int32)
    last0 = jnp.full(B, n, dtype=jnp.int32)
    cols = jnp.flip(pats, axis=1).T

    def step(carry, col):
        first, last, pf, pl, matched = carry
        active = (col >= 0) & (last > first)
        nf, nl = R.backward_step_pair(arrays, col, first, last)
        keep_prev = active & (nl > nf)
        pf = jnp.where(keep_prev, nf, pf)
        pl = jnp.where(keep_prev, nl, pl)
        matched = matched + keep_prev.astype(jnp.int32)
        first = jnp.where(active, nf, first)
        last = jnp.where(active, nl, last)
        return (first, last, pf, pl, matched), None

    init = (first0, last0, first0, last0, jnp.zeros(B, jnp.int32))
    (first, last, pf, pl, matched), _ = jax.lax.scan(step, init, cols)
    return first, last, pf, pl, matched


def locate_rows(arrays: FMArrays, mark_period: int, rows: jax.Array):
    """Text offset of the suffix at each row, via LF-walk to a marked row.

    The reference's locate (server.c:2228 back_query + LOCATE logic,
    §3.3 of SURVEY.md): walk LF until the current row is marked; offset =
    sampled value + steps walked.  All B rows walk in lockstep; the mark
    VALUE lookup happens once after the walk (grank recorded at hit time).
    Max steps = mark_period (doc starts are always marked).  For large
    batches prefer locate_rows_phased (drops finished lanes between
    fixed-length walk phases).
    """
    B = rows.shape[0]

    def cond(st):
        i, rows, granks, steps, done = st
        return (i <= mark_period) & jnp.any(~done)

    def body(st):
        i, rows, granks, steps, done = st
        nxt, bit, grank = R.lf_grank_step(arrays, rows)
        is_m = bit & (~done)
        granks = jnp.where(is_m, grank, granks)
        steps = jnp.where(is_m, i, steps)
        done = done | is_m
        rows = jnp.where(done, rows, nxt)
        return i + 1, rows, granks, steps, done

    granks0 = jnp.zeros(B, dtype=jnp.int32)
    steps0 = jnp.full(B, -1, dtype=jnp.int32)
    done0 = jnp.zeros(B, dtype=bool)
    _, _, granks, steps, done = jax.lax.while_loop(
        cond, body, (jnp.int32(0), rows, granks0, steps0, done0)
    )
    offs = R.mark_offset(arrays, granks) + steps
    return jnp.where(done, offs, -1)


@functools.partial(jax.jit, static_argnames=("steps",))
def _locate_phase(arrays, rows, granks, stepv, stepcnt, done, *, steps):
    """Walk `steps` lockstep LF iterations over ALL lanes (a scan — no
    per-iteration convergence check), recording mark hits.  stepcnt[b]
    counts LF steps walked so far across phases, so phases compose."""

    def body(carry, _):
        rows, granks, stepv, stepcnt, done = carry
        nxt, bit, grank = R.lf_grank_step(arrays, rows)
        is_m = bit & (~done)
        granks = jnp.where(is_m, grank, granks)
        stepv = jnp.where(is_m, stepcnt, stepv)
        done = done | is_m
        rows = jnp.where(done, rows, nxt)
        stepcnt = jnp.where(done, stepcnt, stepcnt + 1)
        return (rows, granks, stepv, stepcnt, done), None

    (rows, granks, stepv, stepcnt, done), _ = jax.lax.scan(
        body, (rows, granks, stepv, stepcnt, done), None, length=steps
    )
    return rows, granks, stepv, stepcnt, done


@functools.partial(jax.jit, static_argnames=("M",))
def _active_lanes(done, *, M):
    """Indices of the first M not-done lanes (stable byte-key sort), plus
    the not-done count."""
    B = done.shape[0]
    idx = jnp.arange(B, dtype=jnp.int32)
    _, perm = jax.lax.sort((done.astype(jnp.uint8), idx), num_keys=1)
    return perm[:M], jnp.sum((~done).astype(jnp.int32))


@jax.jit
def _scatter_lanes(granks, stepv, done, sel, g2, s2, d2):
    """Merge a compacted sub-batch's results back into the full batch."""
    upd = d2
    granks = granks.at[sel].set(jnp.where(upd, g2, granks[sel]))
    stepv = stepv.at[sel].set(jnp.where(upd, s2, stepv[sel]))
    done = done.at[sel].set(done[sel] | d2)
    return granks, stepv, done


_locate_rows_jit = jax.jit(locate_rows, static_argnums=(1,))


@jax.jit
def _locate_epilogue(arrays, granks, stepv, done):
    offs = R.mark_offset(arrays, granks) + stepv
    return jnp.where(done, offs, -1)


def locate_rows_phased(arrays: FMArrays, mark_period: int, rows: jax.Array,
                       min_compact: int = 16384):
    """locate_rows with lane compaction between fixed-length walk phases.

    The lockstep while_loop walks every lane for ~mark_period+1
    iterations even though the mean hit depth is ~mark_period/2 — finished
    lanes idle.  Per-iteration compaction costs a host sync + 3 O(B)
    scatters per chunk; this version walks scan phases of ~(mark_period+1)/3 steps and
    compacts ONLY between phases: 2 host syncs + 2 cheap byte-key sorts
    total, executed-lane count drops ~1.5x.  Small batches keep the plain
    while_loop (sync overhead dominates).  Returns offsets like
    locate_rows."""
    B = rows.shape[0]
    total = mark_period + 1
    if B < min_compact or total < 6:
        return _locate_rows_jit(arrays, mark_period, rows)

    p1 = max(total // 3, 1)
    granks = jnp.zeros(B, dtype=jnp.int32)
    stepv = jnp.full(B, -1, dtype=jnp.int32)
    stepcnt = jnp.zeros(B, dtype=jnp.int32)
    done = jnp.zeros(B, dtype=bool)
    rows_w, granks, stepv, stepcnt, done = _locate_phase(
        arrays, rows, granks, stepv, stepcnt, done, steps=p1
    )
    walked = p1
    while walked < total:
        remaining = total - walked
        sel, m_dev = _active_lanes(done, M=B)
        m = int(m_dev)
        if m == 0:
            break
        M = max(1 << (m - 1).bit_length(), 1024)
        if M >= B:
            # compaction will not shrink the batch; finish in one phase
            rows_w, granks, stepv, stepcnt, done = _locate_phase(
                arrays, rows_w, granks, stepv, stepcnt, done,
                steps=remaining,
            )
            break
        sel = sel[:M]
        steps_now = remaining if M * 2 >= B else max(remaining // 2, 1)
        r2, g2, s2, c2, d2 = _locate_phase(
            arrays, rows_w[sel], granks[sel], stepv[sel], stepcnt[sel],
            done[sel], steps=steps_now,
        )
        granks, stepv, done = _scatter_lanes(
            granks, stepv, done, sel, g2, s2, d2
        )
        if steps_now < remaining:
            # survivors of the sub-batch keep walking next iteration: put
            # their advanced rows/counters back too
            rows_w = rows_w.at[sel].set(r2)
            stepcnt = stepcnt.at[sel].set(c2)
        walked += steps_now
    return _locate_epilogue(arrays, granks, stepv, done)


@functools.partial(jax.jit, static_argnames=("mark_period",))
def locate_rows_pyramid(arrays: FMArrays, mark_period: int,
                        rows: jax.Array):
    """locate_rows with DEVICE-side capacity-halving between walk phases.

    The lockstep walk executes every lane for mark_period+1 steps though
    the mean hit depth is ~half that.  This variant compacts ENTIRELY on device
    (one byte-key sort per phase boundary, no scalar pulls): phase 1 walks
    all B lanes past the half-life, survivors compact into a B/2 then B/4
    sub-batch, and a lax.cond cleanup phase (full width, executed only
    when lanes overflowed a capacity or remain unfinished) guarantees
    completion.  Executed lane-steps drop ~1.4x; everything fits ONE jit.
    """
    B = rows.shape[0]
    total = mark_period + 1

    def phase(rows_w, granks, stepv, stepcnt, done, steps):
        def body(carry, _):
            rows_w, granks, stepv, stepcnt, done = carry
            nxt, bit, grank = R.lf_grank_step(arrays, rows_w)
            is_m = bit & (~done)
            granks = jnp.where(is_m, grank, granks)
            stepv = jnp.where(is_m, stepcnt, stepv)
            done = done | is_m
            rows_w = jnp.where(done, rows_w, nxt)
            stepcnt = jnp.where(done, stepcnt, stepcnt + 1)
            return (rows_w, granks, stepv, stepcnt, done), None

        (rows_w, granks, stepv, stepcnt, done), _ = jax.lax.scan(
            body, (rows_w, granks, stepv, stepcnt, done), None,
            length=steps)
        return rows_w, granks, stepv, stepcnt, done

    granks = jnp.zeros(B, dtype=jnp.int32)
    stepv = jnp.full(B, -1, dtype=jnp.int32)
    stepcnt = jnp.zeros(B, dtype=jnp.int32)
    done = jnp.zeros(B, dtype=bool)

    p1 = max((total * 11) // 20, 1)          # past the half-life
    rows_w, granks, stepv, stepcnt, done = phase(
        rows, granks, stepv, stepcnt, done, p1)
    walked = p1
    rem = total - walked
    for denom in (2, 4):
        cap = B // denom
        if cap < 1024 or rem <= 0:
            break
        steps_now = max(rem // 2, 1) if denom == 2 else rem
        idx = jnp.arange(B, dtype=jnp.int32)
        _, perm = jax.lax.sort((done.astype(jnp.uint8), idx), num_keys=1)
        sel = perm[:cap]
        r2, g2, s2, c2, d2 = phase(
            rows_w[sel], granks[sel], stepv[sel], stepcnt[sel], done[sel],
            steps_now)
        rows_w = rows_w.at[sel].set(r2)
        granks = granks.at[sel].set(g2)
        stepv = stepv.at[sel].set(s2)
        stepcnt = stepcnt.at[sel].set(c2)
        done = done.at[sel].set(d2)
        walked += steps_now
        rem = total - walked

    if rem > 0:
        # small batches (compaction skipped): finish at full width
        rows_w, granks, stepv, stepcnt, done = phase(
            rows_w, granks, stepv, stepcnt, done, rem)

    def cleanup(st):
        rows_w, granks, stepv, stepcnt, done = st
        return phase(rows_w, granks, stepv, stepcnt, done, total)

    st = (rows_w, granks, stepv, stepcnt, done)
    st = jax.lax.cond(jnp.any(~done), cleanup, lambda s: s, st)
    _, granks, stepv, _, done = st
    offs = R.mark_offset(arrays, granks) + stepv
    return jnp.where(done, offs, -1)


def extract_backward(arrays: FMArrays, rows: jax.Array, num_steps: int):
    """Walk LF `num_steps` times from each row, collecting BWT symbols.

    Returns (chars int32[B, num_steps], final_rows).  chars[:, t] is the
    symbol `t+1` positions before each row's suffix start — i.e. the text
    preceding the row, reversed.  This is the extract/context machinery
    (server.c:2627 context_query) in batched form.
    """

    def step(rows, _):
        cd = R.bwt_code_at(arrays, rows)
        nxt = arrays.C[cd] + R._occ_dense(arrays, cd, rows)
        return nxt, cd

    final_rows, codes = jax.lax.scan(step, rows, None, length=num_steps)
    chars = R.unmap_char(arrays, codes)
    return chars.T, final_rows


def _select_char(arrays: FMArrays, n: int, c: jax.Array, k: jax.Array):
    """Batched select: smallest row x with rank(c, x+1) == k+1, i.e. the
    (k+1)-th occurrence row of DENSE code c in the BWT.

    Two-phase: binary search over segment checkpoints (occ_ckpt[:, c]
    ascending in s), then an in-segment cumulative scan — the analog of the
    reference's block_request_row select used by forward stepping
    (index.c:1915)."""
    n_seg = R.n_segments(arrays)
    seg = R.seg_size(arrays)
    # Phase 1: find largest s with occ_ckpt[s, c] <= k  (rows before seg s).
    lo = jnp.zeros_like(c)
    hi = jnp.full_like(c, n_seg - 1)

    def bs(_, st):
        lo, hi = st
        mid = (lo + hi + 1) // 2
        v = R.ckpt_base(arrays, mid, c)
        go_right = v <= k
        lo = jnp.where(go_right, mid, lo)
        hi = jnp.where(go_right, hi, mid - 1)
        return lo, hi

    steps = int(np.ceil(np.log2(max(n_seg, 2)))) + 1
    lo, _ = jax.lax.fori_loop(0, steps, bs, (lo, hi))
    s = lo
    base = R.ckpt_base(arrays, s, c)
    segdata = R.gather_segments(arrays, s)                       # [B, SEG]
    is_c = (segdata == c[:, None]).astype(jnp.int32)
    cum = jnp.cumsum(is_c, axis=1)  # occurrences up to and including column j
    target = (k - base + 1)[:, None]
    # first column where cum == target and is_c
    hit = (cum == target) & (is_c == 1)
    iota = jax.lax.broadcasted_iota(jnp.int32, segdata.shape, 1)
    col = jnp.min(jnp.where(hit, iota, seg), axis=1)
    return s * seg + col


def psi_step(arrays: FMArrays, n: int, rows: jax.Array):
    """Forward stepping (inverse LF): row of the suffix one position later.

    psi(r) = select(c, r - C[c]) where c = first symbol of row r's suffix
    (found by searchsorted over C).  Reference: forward_query server.c:2424.
    """
    cd = (
        jnp.searchsorted(arrays.C, rows, side="right").astype(jnp.int32) - 1
    )
    k = rows - arrays.C[cd]
    return _select_char(arrays, n, cd, k), R.unmap_char(arrays, cd)
