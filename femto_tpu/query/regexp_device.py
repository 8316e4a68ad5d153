"""Device-side lockstep regex frontier: the whole NFA search in one jit.

The host engine (regexp.py) dispatches one device call per character layer
and keeps NFA state vectors on the host.  This module keeps the ENTIRE
frontier on device: a static-capacity array of (first, last, per-state cost)
entries advances one character layer per `lax.while_loop` iteration —
forking every entry by every alphabet symbol, batching all the rank lookups
of the layer, min-merging duplicate ranges, and compacting back to capacity.
This realizes SURVEY.md §7 Phase 4 (the queue_map of server.c:1656 as a
device array stepped in lockstep) with zero host round-trips per layer.

Strings are not materialized (device arrays are fixed-shape); use the host
engine for find_strings-style reporting.  Supports exact and approximate
(cost-vector) matching with the same semantics as regexp.py.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import ALPHA_SIZE, CHARACTER_OFFSET
from ..fmindex import FMIndex
from .ast import ApproxSettings
from .nfa import NFA
from .regexp import NO_COST, RegexpMatch, _nfa_mats, _start_costs, dedupe_matches

INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class _Static:
    """Hashable jit-static config."""

    n: int            # total rows (meta.n_rows: includes pad rows)
    row0: int         # first REAL row (non-zero on padded/sharded builds)
    S: int            # NFA states
    T: int            # transitions
    F: int            # frontier capacity
    R: int            # results capacity
    max_len: int
    cost_bound: int
    subst: int
    delete: int
    insert: int
    del_rounds: int


def _bucket(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _nfa_device_arrays(nfa: NFA):
    """Device transition arrays, padded to shape buckets so differently
    sized regexes share one compiled kernel (pad transitions have all-false
    masks and contribute nothing; pad states are unreachable)."""
    mats = _nfa_mats(nfa)
    T = _bucket(len(mats.src), 32)
    S = _bucket(nfa.num_states, 16)
    src = np.zeros(T, np.int32)
    dst = np.zeros(T, np.int32)
    mask = np.zeros((T, ALPHA_SIZE), bool)
    if len(mats.src):
        src[: len(mats.src)] = mats.src
        dst[: len(mats.dst)] = mats.dst
        mask[: len(mats.src)] = mats.mask
    accept = np.zeros(S, bool)
    accept[: nfa.num_states] = nfa.accept
    return jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), \
        jnp.asarray(accept), S, T


def _segment_min_over_T(contrib, dst, S: int):
    """min over transitions t (axis -1) grouped by dst[t] -> [..., S]."""
    flat = contrib.reshape(-1, contrib.shape[-1])  # [E, T]
    out = jax.ops.segment_min(
        flat.T, dst, num_segments=S, indices_are_sorted=False
    )  # [S, E]
    return out.T.reshape(contrib.shape[:-1] + (S,))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _run_device(arrays, src, dst, mask, accept, costs0, cfg: _Static):
    """Returns (res_first, res_last, res_cost [R], res_count, overflow)."""
    from ..ops.rank import backward_step_pair

    return _frontier_loop(
        functools.partial(backward_step_pair, arrays),
        src, dst, mask, accept, costs0, cfg,
    )


def _frontier_loop(step_pair, src, dst, mask, accept, costs0, cfg: _Static):
    """The frontier search, generic over the backward-step implementation:
    step_pair(chars, first, last) -> (new_first, new_last).  Called by
    _run_device (single-device rank ops) and by the mesh engine
    (parallel/dist_query._regexp_body: the same loop runs REPLICATED
    inside shard_map, with psum-based steps against sharded arrays)."""
    F, S, T, R = cfg.F, cfg.S, cfg.T, cfg.R
    A = ALPHA_SIZE

    # frontier state: entry 0 spans the REAL row space [row0, n_rows)
    first = jnp.zeros((F,), jnp.int32).at[0].set(cfg.row0)
    last = jnp.zeros((F,), jnp.int32).at[0].set(cfg.n)
    costs = jnp.full((F, S), NO_COST, jnp.int32).at[0].set(costs0)
    live = jnp.zeros((F,), bool).at[0].set(True)

    res_first = jnp.zeros((R,), jnp.int32)
    res_last = jnp.zeros((R,), jnp.int32)
    res_cost = jnp.full((R,), NO_COST, jnp.int32)
    res_len = jnp.zeros((R,), jnp.int32)
    res_count = jnp.int32(0)
    overflow = jnp.int32(0)

    # record the start entry if it is already accepting
    acc0 = jnp.min(jnp.where(accept, costs0, NO_COST))
    hit0 = acc0 < cfg.cost_bound
    res_first = res_first.at[0].set(cfg.row0)
    res_last = jnp.where(hit0, res_last.at[0].set(cfg.n), res_last)
    res_cost = jnp.where(hit0, res_cost.at[0].set(acc0), res_cost)
    res_count = res_count + hit0.astype(jnp.int32)

    chars = jnp.arange(A, dtype=jnp.int32)
    approx_any = cfg.cost_bound > 1

    def relax_deletions(c):  # c: [..., S]
        def body(_, cc):
            cand = jnp.take(cc, src, axis=-1) + cfg.delete  # [..., T]
            relaxed = jnp.minimum(cc, _segment_min_over_T(cand, dst, S))
            return jnp.where(relaxed >= cfg.cost_bound, NO_COST, relaxed)
        return jax.lax.fori_loop(0, cfg.del_rounds, body, c)

    def layer(state):
        (first, last, costs, live, res_first, res_last, res_cost, res_len,
         res_count, overflow, depth) = state

        # 1. reachable chars per entry: live_src[F,T] @ mask[T,A].  The
        # operands are 0/1, exact in TF32 and bf16, and the float32 sums
        # count transitions (far below 2^24), so the product is exact on
        # any matmul path; only > 0 is read.
        live_src = (jnp.take(costs, src, axis=1) < cfg.cost_bound) & live[:, None]
        reach = jnp.einsum(
            "ft,ta->fa", live_src.astype(jnp.float32),
            mask.astype(jnp.float32), preferred_element_type=jnp.float32,
        ) > 0.5
        if approx_any:
            any_live = live & (jnp.min(costs, axis=1)
                               + min(cfg.subst, cfg.insert) < cfg.cost_bound)
            sub_ok = jnp.zeros((A,), bool).at[CHARACTER_OFFSET:].set(True)
            reach = reach | (any_live[:, None] & sub_ok[None, :])
        # No substitutions on the first backward step (the pattern's last
        # character) — QUERY_FORMAT.txt:143 / host engine allow_subst.
        allow_subst = depth > 0

        # 2. batched backward step for all F*A forks
        cflat = jnp.broadcast_to(chars[None, :], (F, A)).reshape(-1)
        fflat = jnp.broadcast_to(first[:, None], (F, A)).reshape(-1)
        lflat = jnp.broadcast_to(last[:, None], (F, A)).reshape(-1)
        nf_flat, nl_flat = step_pair(cflat, fflat, lflat)
        nf = nf_flat.reshape(F, A)
        nl = nl_flat.reshape(F, A)
        valid = reach & (nl > nf)

        # 3. new cost vectors: [F, A, S]
        base_c = jnp.take(costs, src, axis=1)             # [F, T]
        exact = jnp.where(
            jnp.transpose(mask, (1, 0))[None, :, :],       # [1, A, T]
            base_c[:, None, :], NO_COST,
        )                                                  # [F, A, T]
        if approx_any:
            sub = jnp.where(
                allow_subst & ~jnp.transpose(mask, (1, 0))[None, :, :],
                base_c[:, None, :] + cfg.subst, NO_COST,
            )
            contrib = jnp.minimum(exact, sub)
        else:
            contrib = exact
        nc = _segment_min_over_T(contrib, dst, S)          # [F, A, S]
        if approx_any:
            nc = jnp.minimum(nc, costs[:, None, :] + cfg.insert)
        nc = jnp.where(nc >= cfg.cost_bound, NO_COST, nc)
        nc = relax_deletions(nc)
        alive = (nc < cfg.cost_bound).any(axis=2) & valid  # [F, A]

        # 4. flatten forks, sort by (first, last) for merge + compaction
        E = F * A
        ff = jnp.where(alive, nf, INT32_MAX).reshape(E)
        ll = jnp.where(alive, nl, INT32_MAX).reshape(E)
        av = alive.reshape(E)
        idx = jnp.arange(E, dtype=jnp.int32)
        sf, sl, sidx = jax.lax.sort((ff, ll, idx), num_keys=2)
        scost = nc.reshape(E, S)[sidx]
        s_av = av[sidx]

        # min-merge runs of equal (first, last): one segment_min over run ids
        new_seg = jnp.ones((E,), bool)
        new_seg = new_seg.at[1:].set((sf[1:] != sf[:-1]) | (sl[1:] != sl[:-1]))
        run_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
        merged = jax.ops.segment_min(
            scost, run_id, num_segments=E, indices_are_sorted=True
        )
        scost = merged[run_id]

        # keep one representative per run (its first entry)
        keep = s_av & new_seg

        # 5. record accepting merged entries
        acc_cost = jnp.min(
            jnp.where(accept[None, :], scost, NO_COST), axis=1
        )
        hit = keep & (acc_cost < cfg.cost_bound)
        hit_slot = res_count + jnp.cumsum(hit.astype(jnp.int32)) - 1
        wslot = jnp.where(hit & (hit_slot < R), hit_slot, R)
        res_first = res_first.at[wslot].set(sf, mode="drop")
        res_last = res_last.at[wslot].set(sl, mode="drop")
        res_cost = res_cost.at[wslot].set(acc_cost, mode="drop")
        res_len = res_len.at[wslot].set(depth + 1, mode="drop")
        n_hits = jnp.sum(hit.astype(jnp.int32))
        overflow = jnp.maximum(overflow, res_count + n_hits - R)
        res_count = jnp.minimum(res_count + n_hits, R)

        # 6. compact keepers into the next frontier (capacity F)
        slot_order = jnp.cumsum(keep.astype(jnp.int32)) - 1
        wf = jnp.where(keep & (slot_order < F), slot_order, F)
        nfirst = jnp.zeros((F + 1,), jnp.int32).at[wf].set(sf, mode="drop")[:F]
        nlast = jnp.zeros((F + 1,), jnp.int32).at[wf].set(sl, mode="drop")[:F]
        ncosts = (
            jnp.full((F + 1, S), NO_COST, jnp.int32)
            .at[wf].set(scost, mode="drop")[:F]
        )
        n_keep = jnp.sum(keep.astype(jnp.int32))
        overflow = jnp.maximum(overflow, n_keep - F)
        nlive = (jnp.arange(F) < jnp.minimum(n_keep, F))

        return (nfirst, nlast, ncosts, nlive, res_first, res_last,
                res_cost, res_len, res_count, overflow, depth + 1)

    def cond(state):
        live = state[3]
        depth = state[10]
        return jnp.any(live) & (depth < cfg.max_len)

    state = (first, last, costs, live, res_first, res_last, res_cost,
             res_len, res_count, overflow, jnp.int32(0))
    state = jax.lax.while_loop(cond, layer, state)
    (_, _, _, live, res_first, res_last, res_cost, res_len, res_count,
     overflow, depth) = state
    # Stopping at max_len with a live frontier would silently drop longer
    # matches — report it as overflow so callers retry/fall back.
    overflow = jnp.maximum(
        overflow, (jnp.any(live) & (depth >= cfg.max_len)).astype(jnp.int32)
    )
    return res_first, res_last, res_cost, res_len, res_count, overflow


def run_regexp_device(
    index: FMIndex,
    nfa: NFA,
    settings: ApproxSettings = ApproxSettings.exact(),
    frontier_cap: int = 256,
    results_cap: int = 4096,
    max_len: int = 64,
    with_strings: bool = False,
    max_frontier_cap: int = 16384,
    max_results_cap: int = 262144,
    max_max_len: int = 1024,
) -> List[RegexpMatch]:
    """Device-frontier regex search.

    with_strings=True reconstructs each matched string by a batched
    psi-walk from the match's first row (its length equals the layer depth
    it was found at); otherwise matches carry match=b"".  On capacity
    overflow (frontier, results, or match length) the capacities double and
    the search re-runs on device (the growth analog of the reference's
    unbounded queue_map, server.c:1656); RuntimeError is raised only past
    the max_* caps (callers then fall back to the host engine)."""
    while True:
        try:
            return _run_regexp_device_once(
                index, nfa, settings, frontier_cap, results_cap, max_len,
                with_strings,
            )
        except _DeviceCapacityOverflow:
            if (frontier_cap >= max_frontier_cap
                    and results_cap >= max_results_cap
                    and max_len >= max_max_len):
                raise RuntimeError(
                    "device regex frontier overflow at maximum capacities"
                )
            frontier_cap = min(frontier_cap * 4, max_frontier_cap)
            results_cap = min(results_cap * 4, max_results_cap)
            max_len = min(max_len * 4, max_max_len)


class _DeviceCapacityOverflow(RuntimeError):
    pass


def _run_regexp_device_once(
    index: FMIndex,
    nfa: NFA,
    settings: ApproxSettings,
    frontier_cap: int,
    results_cap: int,
    max_len: int,
    with_strings: bool,
) -> List[RegexpMatch]:
    src, dst, mask, accept, S_pad, T_pad = _nfa_device_arrays(nfa)
    c0 = np.full(S_pad, NO_COST, np.int32)
    c0[: nfa.num_states] = _start_costs(nfa, settings).astype(np.int32)
    costs0 = jnp.asarray(c0)
    del_rounds = (
        0 if settings.cost_bound <= 1
        else max(1, -(-settings.cost_bound // max(settings.delete_cost, 1)))
    )
    cfg = _Static(
        n=index.meta.n_rows,
        row0=index.meta.row0,
        S=S_pad,
        T=T_pad,
        F=frontier_cap,
        R=results_cap,
        max_len=max_len,
        cost_bound=settings.cost_bound,
        subst=settings.subst_cost,
        delete=settings.delete_cost,
        insert=settings.insert_cost,
        del_rounds=del_rounds,
    )
    rf, rl, rc, rlen, cnt, of = _run_device(
        index.arrays, src, dst, mask, accept, costs0, cfg
    )
    if int(of) > 0:
        raise _DeviceCapacityOverflow(
            "device regex frontier overflow; raise frontier_cap/results_cap"
        )
    cnt = int(cnt)
    rf = np.asarray(rf)[:cnt]
    rl = np.asarray(rl)[:cnt]
    rc = np.asarray(rc)[:cnt]
    rlen = np.asarray(rlen)[:cnt]
    strings = [b""] * cnt
    if with_strings and cnt:
        strings = _reconstruct_strings(index, rf, rlen)
    return dedupe_matches(
        [RegexpMatch(int(f), int(l), int(c), s)
         for f, l, c, s in zip(rf, rl, rc, strings)]
    )


def _reconstruct_strings(index: FMIndex, rows: np.ndarray,
                         lens: np.ndarray) -> List[bytes]:
    """Batched forward psi-walk: the suffix at any row of a match range
    starts with the matched string (forward_query semantics)."""
    from ..ops.search_ops import psi_step

    B = len(rows)
    maxlen = int(lens.max()) if B else 0
    rr = jnp.asarray(rows.astype(np.int32))
    cols = []
    for _ in range(maxlen):
        rr, c = psi_step(index.arrays, index.meta.n, rr)
        cols.append(np.asarray(c))
    out = []
    for i in range(B):
        seq = [int(cols[t][i]) for t in range(int(lens[i]))]
        out.append(bytes(b - CHARACTER_OFFSET for b in seq
                         if b >= CHARACTER_OFFSET))
    return out
