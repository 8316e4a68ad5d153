"""Suffix-array construction as XLA sort/scan passes.

The reference builds suffix arrays with external-memory difference-cover
(DCX) sorting over MPI bins (/root/reference/src/dcx_cc/dcx.hh:4038) or
in-memory two-stage sorters (dcx_inmem.cc, two_stage.cc).  Those designs are
disk/NIC-bound and branch-heavy; on an accelerator the right primitive is
the global sort XLA emits for `lax.sort`.  The design follows from it:

* the initial sort uses 2-3 int32 keys, packed as densely as the corpus
  alphabet allows (dense-remapped codes: 4-10 symbols per 30-bit key
  instead of 3), and extra payload operands ride the sort;
* n-row random gathers/scatters are avoided: the BWT pull rides the sort
  as a payload operand, compactions are rank-selects over bitmaps, and
  the common path never materializes the inverse permutation (ISA);
* the residual unresolved groups (a small share of n on real text after
  a 12-18 symbol initial sort) are resolved by DIRECT KEY EXTENSION:
  gather the next T packed words of each tied suffix and re-sort the tiny
  active set — no rank array, no O(n) pass.  Pathological inputs (long
  repeats) fall back to prefix doubling (Manber-Myers) with segment
  filtering, which is O(log n) rounds and needs the ISA (built lazily,
  one scatter).

Ranks, where used (fallback paths), follow the "group base slot"
convention (the first SA slot of the group), so refined subgroup ranks are
a cummax over slot positions.  Rounds are host-driven: the unresolved
count m is pulled back per round (a scalar), and working arrays are
bucketed to n/4^j anchors so only a handful of shapes ever compile.

The distributed variant (sample-sort over a device mesh) lives in
femto_tpu/parallel/dist_build.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_MIN_BUCKET = 1 << 16
_I32_MAX = np.int32(0x7FFFFFFF)
_EXT_T = 4            # packed words gathered per direct-extension round
_EXT_MAX_ROUNDS = 6   # then fall back to doubling
_KEY_BITS = 30        # payload bits per int32 sort key (sign bit unused)
_NKEYS = 3            # seed-sort keys when fewer than 10 symbols fit two


def _bucket_anchored(m: int, n: int) -> int:
    """Smallest n/4^j >= m (floored at _MIN_BUCKET): at most ~log4(n) work
    shapes ever compile per corpus size, vs ~log2(n) for pow2 buckets —
    compiles are a large share of a cold build, so fewer shapes wins."""
    M = 1 << max((n - 1).bit_length(), _MIN_BUCKET.bit_length() - 1)
    while M // 4 >= m and M // 4 >= _MIN_BUCKET:
        M //= 4
    return min(M, n)


_HIST_ROW = 4096  # symbols per partial histogram row in _alpha_hist


@functools.partial(jax.jit, static_argnames=("n",))
def _alpha_hist(text, *, n):
    """int32[512] symbol counts of `text` (codes < 512) — decides the
    dense pack rate.  Per-row histograms summed: the scatter-add spreads
    over n/_HIST_ROW rows instead of contending on 512 counters."""
    from .ops.build_ops import seg_hist

    rows = -(-n // _HIST_ROW)
    t = jnp.full((rows * _HIST_ROW,), -1, jnp.int32)
    t = jax.lax.dynamic_update_slice(t, text.astype(jnp.int32), (0,))
    return seg_hist(t.reshape(rows, _HIST_ROW), 512).sum(axis=0)


# ---------------------------------------------------------------------------
# Key build: dense monotone remap + packed 30-bit keys.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n", "per_key", "bits",
                                             "nkeys", "n_real"))
def _keys_stage(codes, *, n, per_key, bits, nkeys, n_real=None):
    """Pack per_key dense codes (each < 2**bits, >= 1) per 30-bit key.

    Returns (key0, k1[, k2]) where key0[p] packs codes[p:p+per_key]
    (zero-padded past n — "past end" sorts first, matching the shorter-
    suffix-first convention) and k1/k2 are key0 at +per_key/+2*per_key.
    key0 is kept for the direct-extension epilogue.

    n_real: for SHAPE-PADDED builds (trailing 0 symbols past n_real), pad
    suffixes get distinct NEGATIVE keys -1-p — ordered shorter-first and
    below every real key — so the initial sort resolves the entire pad
    run instantly instead of feeding a giant tie into the doubling
    fallback (the 0^k suffixes only differ by length, which doubling
    needs ~log2(pad) full rounds to see).
    The same encoding answers extension fetches that cross into the pad,
    exactly like the mesh sort (parallel/dist_build._seed_keys)."""
    idx = jnp.arange(n, dtype=jnp.int32)
    key0 = jnp.zeros((n,), jnp.int32)
    for t in range(per_key):
        sym = jnp.where(idx < n - t, jnp.roll(codes, -t), 0)
        key0 = key0 | (sym << ((per_key - 1 - t) * bits))
    if n_real is not None and n_real < n:
        key0 = jnp.where(idx >= n_real, -1 - idx, key0)
    out = [key0]
    for q in range(1, nkeys):
        out.append(jnp.where(idx < n - q * per_key,
                             jnp.roll(key0, -q * per_key), 0))
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("n", "K"))
def _remap_stage(text, used, *, n, K):
    """Monotone dense remap: code = #used symbols <= text[p], in [1, K].
    Order-preserving, so the SA of the remapped string equals the SA of
    the original (the per-index dense-alphabet idea of the packed tier,
    applied to the sort keys)."""
    t = text.astype(jnp.int32)
    return jnp.sum(
        (t[:, None] >= used[None, :]).astype(jnp.int32), axis=1
    )


# ---------------------------------------------------------------------------
# Initial sort + unresolved-slot compaction.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n",))
def _sort3(*args, n):
    """The one big sort (args = nkeys key arrays + payload).  Returns
    (perm, pull, st, m): perm is the candidate SA, pull = payload[perm],
    st marks group starts (any key differs from the previous slot),
    m = #slots in groups of size > 1."""
    keys, payload = args[:-1], args[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    out = jax.lax.sort((*keys, idx, payload), num_keys=len(keys))
    perm, pull = out[-2], out[-1]
    neq = out[0][1:] != out[0][:-1]
    for s in out[1:-2]:
        neq = neq | (s[1:] != s[:-1])
    st = jnp.ones((n,), bool).at[1:].set(neq)
    nxt = jnp.concatenate([st[1:], jnp.ones((1,), bool)])
    unresolved = ~(st & nxt)
    return perm, pull, st, jnp.sum(unresolved.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("n", "M"))
def _compact_select(st, *, n, M):
    """Ascending unresolved slots (n-padded, capacity M) via bitmap
    rank-select — O(n/32 + M) instead of an n-row byte-key sort."""
    from .ops.build_ops import _mark_rank_select

    nxt = jnp.concatenate([st[1:], jnp.ones((1,), bool)])
    unresolved = ~(st & nxt)
    n_words = -(-n // 32)
    padded = jnp.concatenate(
        [unresolved, jnp.zeros((n_words * 32 - n,), bool)]
    )
    bits = padded.reshape(n_words, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    words = jnp.sum(bits * weights, axis=1, dtype=jnp.uint32)
    m = jnp.sum(unresolved.astype(jnp.int32))
    valid, row = _mark_rank_select(words, m, M, n)
    return jnp.where(valid, row, n)


@functools.partial(jax.jit, static_argnames=("n", "M"))
def _init_base(st, slots, *, n, M):
    """Group base slot for each active slot (groups are contiguous runs
    whose first slot has st=1)."""
    valid = slots < n
    stv = st[jnp.where(valid, slots, 0)]
    base = jax.lax.cummax(jnp.where(stv & valid, slots, 0))
    return jnp.where(valid, base, _I32_MAX)


# ---------------------------------------------------------------------------
# Direct-extension epilogue: re-sort the active slots by the next T packed
# words.  No ISA, no rank array; the active set is ~1% of n on real text.
# ---------------------------------------------------------------------------


def _extend_round_impl(sa, pull, st_g, payload, key0, slots, base, W,
                       *, n, M, T, per_key):
    valid = slots < n
    safe = jnp.where(valid, slots, 0)
    pos = sa[safe]
    ops = [jnp.where(valid, base, _I32_MAX)]
    for t in range(T):
        q = pos + W + t * per_key
        kw = jnp.where(q < n, key0[jnp.minimum(q, n - 1)], 0)
        ops.append(jnp.where(valid, kw, _I32_MAX))
    ops.append(pos)
    srt = jax.lax.sort(tuple(ops), num_keys=T + 1)
    sp = srt[-1]
    st = jnp.ones((M,), bool)
    neq = srt[0][1:] != srt[0][:-1]
    for k in srt[1:-1]:
        neq = neq | (k[1:] != k[:-1])
    st = st.at[1:].set(neq)

    tgt_w = jnp.where(valid, slots, n)
    sa = sa.at[tgt_w].set(sp, mode="drop")
    pull = pull.at[tgt_w].set(payload[sp], mode="drop")
    st_g = st_g.at[tgt_w].set(st, mode="drop")

    new_base = jax.lax.cummax(jnp.where(st & valid, slots, 0))
    nxt = jnp.concatenate([st[1:], jnp.ones((1,), bool)])
    keep = valid & ~(st & nxt)
    ppos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, jnp.minimum(ppos, M - 1), M)
    slots_next = (
        jnp.full((M + 1,), n, jnp.int32).at[tgt].set(slots, mode="drop")[:M]
    )
    base_next = (
        jnp.zeros((M + 1,), jnp.int32).at[tgt].set(new_base, mode="drop")[:M]
    )
    return sa, pull, st_g, slots_next, base_next, \
        jnp.sum(keep.astype(jnp.int32))


# Donating variant for rounds 2+ (the inputs are round-1 outputs and dead).
_extend_round = functools.partial(
    jax.jit, static_argnames=("n", "M", "T", "per_key"),
    donate_argnums=(0, 1, 2),
)(_extend_round_impl)

# Non-donating variant for the SPECULATIVE first round: it is enqueued
# before the unresolved count m is known, so the initial-sort arrays must
# survive in case m exceeds the speculative capacity and the round's
# output has to be discarded (the copies are one bandwidth pass; the
# saving is one host round-trip).
_extend_round_spec = functools.partial(
    jax.jit, static_argnames=("n", "M", "T", "per_key"),
)(_extend_round_impl)


@functools.partial(jax.jit, static_argnames=())
def _stack2(a, b):
    return jnp.stack([a, b])


# ---------------------------------------------------------------------------
# Fallback: prefix doubling (full rounds while mostly-unresolved, filtered
# rounds on the compacted active set).  Needs the ISA ("rank"), built with
# one n-row scatter only when this path is taken.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n",))
def _rank_from_state(sa, st_g, *, n):
    """rank[pos] = group base slot, from the current SA + group starts."""
    iota = jnp.arange(n, dtype=jnp.int32)
    base_g = jax.lax.cummax(jnp.where(st_g, iota, 0))
    return jnp.zeros((n,), jnp.int32).at[sa].set(base_g)


@functools.partial(jax.jit, static_argnames=("n",))
def _full_round(rank, payload, k, *, n):
    """One unfiltered doubling round over all n slots (cheaper than the
    filtered round while most groups are unresolved: rank_k comes from a
    roll instead of per-slot gathers).  Carries the payload pull."""
    idx = jnp.arange(n, dtype=jnp.int32)
    rank_k = jnp.where(idx < n - k, jnp.roll(rank, -k), -1)
    s1, s2, perm, pull = jax.lax.sort(
        (rank, rank_k, idx, payload), num_keys=2
    )
    st = jnp.ones((n,), bool).at[1:].set(
        (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    )
    base = jax.lax.cummax(jnp.where(st, idx, 0))
    new_rank = jnp.zeros((n,), jnp.int32).at[perm].set(base)
    nxt_st = jnp.concatenate([st[1:], jnp.ones((1,), bool)])
    unresolved = ~(st & nxt_st)
    return perm, pull, new_rank, st, \
        jnp.sum(unresolved.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("M",),
                   donate_argnums=(0, 1, 2))
def _filtered_round(sa, pull, rank, slots, k, payload, *, M):
    """One filtered doubling round over the active slots.

    slots: int32[M] ascending unresolved SA slots (n-padded).  Sorts the
    active suffixes by (rank, rank at +k), writes them back into their
    (fixed) group slot span, refines ranks, and returns the still-
    unresolved slots compacted to the front.
    """
    n = sa.shape[0]
    valid = slots < n
    pos = sa[jnp.where(valid, slots, 0)]
    r1 = jnp.where(valid, rank[pos], _I32_MAX)
    pk = pos + k
    r2 = jnp.where(pk < n, rank[jnp.minimum(pk, n - 1)], -1)
    r2 = jnp.where(valid, r2, _I32_MAX)

    s1, s2, sp = jax.lax.sort((r1, r2, pos), num_keys=2)
    # element t now belongs at slot slots[t] (groups are slot-contiguous
    # and slots are ascending, so sorted order == slot order)
    st = jnp.ones((M,), bool).at[1:].set(
        (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    )
    new_rank = jax.lax.cummax(jnp.where(st, slots, 0))

    tgt_w = jnp.where(valid, slots, n)
    sa = sa.at[tgt_w].set(sp, mode="drop")
    pull = pull.at[tgt_w].set(payload[sp], mode="drop")
    rank = rank.at[jnp.where(valid, sp, n)].set(new_rank, mode="drop")

    nxt_st = jnp.concatenate([st[1:], jnp.ones((1,), bool)])
    keep = valid & ~(st & nxt_st)  # still in a subgroup of size > 1
    ppos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, jnp.minimum(ppos, M - 1), M)
    slots_next = (
        jnp.full((M + 1,), n, jnp.int32).at[tgt].set(slots, mode="drop")[:M]
    )
    return sa, pull, rank, slots_next, jnp.sum(keep.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("n", "M"))
def _compact_slots(unresolved, *, n, M):
    """Slot indices of unresolved slots, ascending, padded with n."""
    idx = jnp.arange(n, dtype=jnp.int32)
    pos = jnp.cumsum(unresolved.astype(jnp.int32)) - 1
    tgt = jnp.where(unresolved, jnp.minimum(pos, M - 1), M)
    return (
        jnp.full((M + 1,), n, jnp.int32).at[tgt].set(idx, mode="drop")[:M]
    )


@functools.partial(jax.jit, static_argnames=("n",))
def _unresolved_of(st, *, n):
    nxt = jnp.concatenate([st[1:], jnp.ones((1,), bool)])
    return ~(st & nxt)


# ---------------------------------------------------------------------------
# Driver.
# ---------------------------------------------------------------------------


def _pack_rate(K: int):
    """(per_key, bits) for dense codes in [1, K]: how many symbols fit a
    30-bit sort key.  K >= 128 keeps the identity 9-bit layout (the
    remap's n*K compare-sum would outgrow its win)."""
    if K >= 128:
        return 3, 9
    bits = max(1, int(K).bit_length())
    return _KEY_BITS // bits, bits


def suffix_array(text: jax.Array, payload: jax.Array | None = None,
                 alpha: np.ndarray | None = None,
                 n_real: int | None = None):
    """Suffix array of `text` (int array of alphabet codes), as int32[n].

    Equivalent in contract to the reference's suffix_sort entry points
    (dcx.hh:6040, ssort_chpl/SuffixSort.chpl:66): SA[r] is the start offset
    of the rank-r suffix.  Requires every symbol in [1, 512) and n < 2**31.

    payload: optional int32[n]; if given, returns (sa, pull) with
    pull[r] = payload[sa[r]], carried through the sort as a free payload
    operand — the fused-BWT trick that saves the O(n) random gather in
    index packaging (callers pass payload = roll(packed_text, 1) so that
    pull[r] = packed_text[sa[r]-1 mod n] = the BWT + aux word).

    alpha: optional host array of the symbols that occur in `text`
    (sorted ascending; a superset is fine for correctness but weakens the
    key pack rate).  When given, the on-device alphabet histogram AND its
    host round-trip are skipped.

    Host round-trips are the off-device cost of the driver: with `alpha`
    given, the common path costs exactly ONE scalar pull — the first
    extension round is enqueued speculatively at a static capacity M0 and
    both unresolved counts are read together.

    n_real: real (unpadded) length of a shape-padded text whose tail is
    trailing 0 symbols — pad suffixes then seed fully resolved (distinct
    negative keys; see _keys_stage) instead of driving the sort into the
    doubling fallback.
    """
    import os
    import sys
    import time as _time

    text = jnp.asarray(text)
    n = int(text.shape[0])
    want_pull = payload is not None
    if n == 1:
        sa = jnp.zeros((1,), jnp.int32)
        return (sa, payload[sa]) if want_pull else sa
    if payload is None:
        payload = jnp.zeros((n,), jnp.int32)

    dbg = os.environ.get("FEMTO_TPU_SA_DEBUG", "") != ""
    t0 = _time.perf_counter()

    if alpha is not None:
        used_np = np.asarray(alpha, dtype=np.int32)
    else:
        hist = _alpha_hist(text, n=n)
        used_np = np.nonzero(np.asarray(hist) > 0)[0].astype(np.int32)
    K = int(used_np.shape[0])
    per_key, bits = _pack_rate(K)
    if per_key > 3:
        codes = _remap_stage(text, jnp.asarray(used_np), n=n, K=K)
    else:
        codes = text.astype(jnp.int32)
    # 2 keys when the pack rate covers >= 10 symbols (one key operand
    # fewer in the big sort; the slightly larger residual goes to the
    # extension epilogue), else 3
    nkeys = 2 if 2 * per_key >= 10 else _NKEYS
    keys = _keys_stage(codes, n=n, per_key=per_key, bits=bits, nkeys=nkeys,
                       n_real=n_real)
    key0 = keys[0]
    span = nkeys * per_key
    perm, pull, st, m_dev = _sort3(*keys, payload, n=n)
    sa = perm

    # Speculative first extension round at static capacity M0: enqueued
    # BEFORE m is known, so the (common-path) build pays one scalar pull
    # instead of two.  Non-donating — the sort outputs survive a miss.
    M0 = _bucket_anchored(max(n // 1024, 1), n)
    slots0 = _compact_select(st, n=n, M=M0)
    base0 = _init_base(st, slots0, n=n, M=M0)
    W = span
    spec = _extend_round_spec(
        sa, pull, st, payload, key0, slots0, base0, jnp.int32(W),
        n=n, M=M0, T=_EXT_T, per_key=per_key)
    mm = np.asarray(_stack2(m_dev, spec[5]))
    m, m_spec = int(mm[0]), int(mm[1])
    if dbg:
        print(f"  sa: initial sort+spec round {_time.perf_counter()-t0:.2f}s "
              f"K={K} span={span} unresolved={m}/{n} "
              f"(spec M0={M0} -> {m_spec if m <= M0 else 'miss'})",
              file=sys.stderr, flush=True)

    if m == 0:
        return (sa, pull) if want_pull else sa

    if m > n // 4:
        # mostly-unresolved (repetitive/small-alphabet input): prefix
        # doubling with full rounds, then filtered rounds
        rank = _rank_from_state(sa, st, n=n)
        k = span
        slots = None
        M = 0
        while m > 0 and k < 2 * n:
            t1 = _time.perf_counter()
            if slots is None and m > n // 4:
                sa, pull, rank, st, m_dev = _full_round(
                    rank, payload, jnp.int32(k), n=n)
                m = int(m_dev)
                kind = f"full n={n}"
            else:
                if slots is None:
                    M = _bucket_anchored(m, n)
                    slots = _compact_slots(
                        _unresolved_of(st, n=n), n=n, M=M)
                sa, pull, rank, slots_next, m_dev = _filtered_round(
                    sa, pull, rank, slots, jnp.int32(k), payload, M=M)
                m = int(m_dev)
                kind = f"filtered M={M}"
                if m > 0:
                    M_next = _bucket_anchored(m, n)
                    slots = slots_next[:M_next] if M_next < M else slots_next
                    M = M_next
            if dbg:
                print(f"  sa: round k={k} ({kind}) -> m={m} "
                      f"({_time.perf_counter()-t1:.2f}s)",
                      file=sys.stderr, flush=True)
            k *= 2
        return (sa, pull) if want_pull else sa

    # common path: direct key extension of the tiny active set
    st_g = st
    W = span
    rounds = 0
    if m <= M0:
        # adopt the speculative round (already executed on device)
        sa, pull, st_g, slots, base = spec[:5]
        m = m_spec
        W += _EXT_T * per_key
        rounds = 1
        M = M0
        if m > 0:
            M_next = _bucket_anchored(m, n)
            slots = slots[:M_next]
            base = base[:M_next]
            M = M_next
    else:
        M = _bucket_anchored(m, n)
        slots = _compact_select(st, n=n, M=M)
        base = _init_base(st, slots, n=n, M=M)
    while m > 0 and rounds < _EXT_MAX_ROUNDS:
        t1 = _time.perf_counter()
        sa, pull, st_g, slots_next, base_next, m_dev = _extend_round(
            sa, pull, st_g, payload, key0, slots, base, jnp.int32(W),
            n=n, M=M, T=_EXT_T, per_key=per_key)
        m = int(m_dev)
        W += _EXT_T * per_key
        rounds += 1
        if dbg:
            print(f"  sa: extend W->{W} (M={M}) -> m={m} "
                  f"({_time.perf_counter()-t1:.2f}s)",
                  file=sys.stderr, flush=True)
        if m > 0:
            M_next = _bucket_anchored(m, n)
            slots = slots_next[:M_next]
            base = base_next[:M_next]
            M = M_next

    if m > 0:
        # long-repeat tail: switch to filtered prefix doubling (O(log n)
        # rounds); ranks are valid for k = W by construction (equal rank
        # iff the suffixes share a W-symbol prefix)
        rank = _rank_from_state(sa, st_g, n=n)
        k = W
        while m > 0 and k < 2 * n:
            t1 = _time.perf_counter()
            sa, pull, rank, slots_next, m_dev = _filtered_round(
                sa, pull, rank, slots, jnp.int32(k), payload, M=M)
            m = int(m_dev)
            if dbg:
                print(f"  sa: round k={k} (filtered M={M}) -> m={m} "
                      f"({_time.perf_counter()-t1:.2f}s)",
                      file=sys.stderr, flush=True)
            if m > 0:
                M_next = _bucket_anchored(m, n)
                slots = slots_next[:M_next] if M_next < M else slots_next
                M = M_next
            k *= 2

    return (sa, pull) if want_pull else sa


def suffix_array_np(text: np.ndarray) -> np.ndarray:
    """Naive host oracle: O(n log^2 n) prefix doubling in numpy (tests)."""
    n = len(text)
    rank = np.asarray(text, dtype=np.int64).copy()
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        rank_k = np.full(n, -1, dtype=np.int64)
        if k < n:
            rank_k[: n - k] = rank[k:]
        order = np.lexsort((idx, rank_k, rank))
        s1, s2 = rank[order], rank_k[order]
        new_rank_sorted = np.zeros(n, dtype=np.int64)
        if n > 1:
            diff = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
            new_rank_sorted[1:] = np.cumsum(diff)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n - 1:
            return order.astype(np.int64)
        k *= 2


def bwt_from_sa(text: jax.Array, sa: jax.Array) -> jax.Array:
    """BWT: L[r] = T[(SA[r]-1) mod n] — one gather (cf. do_bwt dcx.hh:6094)."""
    n = text.shape[0]
    prev = jnp.where(sa == 0, n - 1, sa - 1)
    return jnp.take(text, prev, axis=0)
