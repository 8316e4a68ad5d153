"""Benchmark: batched FM backward-search throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "platform": ..., ...}

Headline metric: LF/backward-search steps per second per device — the
reference's batched count-query throughput axis (doc/femto.pdf §4.1
Fig. 4).  One "step" = one pattern-character advance of one query = 2
rank(c, r) lookups.  The corpus is synthesized on device; every timed
loop ends in block_until_ready.  Without a GPU the benchmark fails.
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found platform {dev.platform!r}")
    from chip_smoke import card
    from femto_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    import femto_tpu as ft
    from femto_tpu.alphabet import CHARACTER_OFFSET, SEOF
    from femto_tpu.fmindex import FMIndex, FMMeta
    from femto_tpu.ops.build_ops import build_fm_arrays_device, build_sa_payload
    from femto_tpu.ops.rank import n_segments as R_n_segments
    from femto_tpu.ops.search_ops import (
        backward_search, backward_search_shared, locate_rows,
        locate_rows_pyramid,
    )

    mb = float(os.environ.get("BENCH_MB", "16"))
    B = int(os.environ.get("BENCH_BATCH", "32768"))
    P = int(os.environ.get("BENCH_PATLEN", "16"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    seg = int(os.environ.get("BENCH_SEG", "256"))
    mark_period = int(os.environ.get("BENCH_MARK", "20"))
    tier = os.environ.get("BENCH_TIER", "packed")
    if os.environ.get("BENCH_COMPACT", "0") == "1":
        tier = "compact"

    log(f"device: {dev}, corpus {mb} MiB, batch {B}, patlen {P}")

    n = int(mb * (1 << 20))
    doc_size = 1 << 16
    ndocs = -(-n // doc_size)
    doc_starts_np = np.minimum(
        np.arange(ndocs + 1, dtype=np.int64) * doc_size, n
    )

    # English-like zipf text synthesized on device (no host upload).
    @jax.jit
    def gen_text(key):
        letters = jnp.asarray(
            np.frombuffer(b"etaoin shrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
            .astype(np.int32) + CHARACTER_OFFSET
        )
        probs = 1.0 / np.arange(1, 31, dtype=np.float32)
        logits = jnp.log(jnp.asarray(probs / probs.sum()))
        ix = jax.random.categorical(key, logits, shape=(n,))
        text = letters[ix]
        pos = jnp.arange(n, dtype=jnp.int32)
        is_end = (pos % doc_size == doc_size - 1) | (pos == n - 1)
        return jnp.where(is_end, SEOF, text)

    # the generator's alphabet is static: zipf letters + SEOF
    alpha_np = np.sort(np.concatenate([
        np.frombuffer(b"etaoin shrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
        .astype(np.int32) + CHARACTER_OFFSET,
        np.asarray([SEOF], dtype=np.int32)]))
    text_dev = gen_text(jax.random.PRNGKey(1234)).block_until_ready()
    log("corpus synthesized on device")

    # --- suffix array (fused BWT payload): cold then steady ---
    doc_starts_dev = jnp.asarray(doc_starts_np.astype(np.int32))

    def sa_barrier():
        payload = build_sa_payload(
            text_dev, doc_starts_dev, n=n, mark_period=mark_period,
            ndocs=ndocs,
        )
        sa, pull = ft.suffix_array(text_dev, payload=payload, alpha=alpha_np)
        return jax.block_until_ready((sa, pull))

    t0 = time.perf_counter()
    sa, pull = sa_barrier()
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    sa, pull = sa_barrier()
    t_sa = time.perf_counter() - t0
    log(f"suffix array: {t_sa:.2f}s steady ({mb / t_sa:.2f} MiB/s on-device; "
        f"cold incl. compile {t_cold:.2f}s)")

    # --- index packaging on device (per tier) ---
    def build_barrier(t):
        arrays, n_marks, _ = build_fm_arrays_device(
            text_dev, sa, doc_starts_dev,
            n=n, seg=seg, mark_period=mark_period, ndocs=ndocs,
            tier=t, pull=pull, alpha=alpha_np,
        )
        jax.block_until_ready(arrays)
        return arrays, int(n_marks)

    # every serving tier is timed and recorded in the JSON line; the
    # headline stays BENCH_TIER
    tier_names = [
        t for t in os.environ.get(
            "BENCH_TIERS", "full,packed,vseg,vrle").split(",")
        if t]
    if tier not in tier_names:
        tier_names.append(tier)

    def arrays_bpc(arrays_t):
        """Stored bytes per corpus char, every device array counted."""
        return sum(
            leaf.nbytes for leaf in jax.tree.leaves(arrays_t)
        ) / n

    tier_arrays = {}
    tier_build_s = {}
    tier_bpc = {}
    for t in tier_names:
        t0 = time.perf_counter()
        arrays_t, n_marks = build_barrier(t)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        arrays_t, n_marks = build_barrier(t)
        tier_build_s[t] = time.perf_counter() - t0
        tier_arrays[t] = arrays_t
        tier_bpc[t] = arrays_bpc(arrays_t)
        log(f"index packaging [{t}]: {tier_build_s[t]:.2f}s steady "
            f"(cold {t_c:.2f}s); {tier_bpc[t]:.3f} B/char")
    arrays = tier_arrays[tier]
    t_build = tier_build_s[tier]
    log(f"steady total build [{tier}]: {mb/(t_sa+t_build):.2f} MiB/s")

    meta = FMMeta(n=n, seg=seg, mark_period=mark_period, num_docs=ndocs,
                  n_marks=n_marks, n_seg=int(R_n_segments(arrays)))
    index = FMIndex(arrays=arrays, meta=meta, doc_starts_np=doc_starts_np,
                    infos=[b"bench%d" % i for i in range(ndocs)])

    # --- patterns: substrings of the corpus, sliced on device ---
    rng = np.random.default_rng(99)
    starts = (
        rng.integers(0, ndocs, size=B) * doc_size
        + rng.integers(0, doc_size - P - 2, size=B)
    ).astype(np.int32)
    starts = np.minimum(starts, n - P - 2)

    @jax.jit
    def slice_patterns(text, starts):
        idx = starts[:, None] + jnp.arange(P, dtype=jnp.int32)[None, :]
        return jnp.take(text, idx, axis=0).astype(jnp.int32)

    packed_dev = slice_patterns(text_dev, jnp.asarray(starts))
    packed_dev.block_until_ready()

    # BENCH_SHARED=1: shared-segment pair rank with device lane compaction
    # (ops/search_ops.backward_search_shared)
    if os.environ.get("BENCH_SHARED", "0") == "1":
        _bs = lambda arrays, n, pats: backward_search_shared(  # noqa: E731
            arrays, n, pats, compact_cap=B // 2)
    else:
        _bs = backward_search

    @jax.jit
    def count_step(arrays, pats):
        first, last = _bs(arrays, n, pats)
        return jnp.sum(last - first), first, last

    def time_count(arrays_t, label):
        total = int(count_step(arrays_t, packed_dev)[0])
        t0 = time.perf_counter()
        for _i in range(iters):
            out = count_step(arrays_t, packed_dev)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        s = B * P * iters / dt
        log(f"backward search [{label}]: {s/1e6:.2f}M steps/s "
            f"({dt/iters*1e3:.1f} ms per {B}x{P} batch; "
            f"{total} total matches)")
        return s, total

    tier_sps = {}
    sanity_totals = set()
    for t in tier_names:
        tier_sps[t], tot = time_count(tier_arrays[t], t)
        sanity_totals.add(tot)
    assert len(sanity_totals) == 1, f"tier count mismatch: {sanity_totals}"
    sps = tier_sps[tier]

    # --- locate (lockstep walk, deferred mark-value resolution) ---
    LB = int(os.environ.get("BENCH_LOCATE_BATCH", "65536"))
    rows = jnp.asarray(rng.integers(0, n, size=LB).astype(np.int32))

    _loc = (locate_rows_pyramid
            if os.environ.get("BENCH_PYRAMID", "1") == "1" else locate_rows)

    @jax.jit
    def loc_step(arrays, rows):
        return _loc(arrays, mark_period, rows)

    loc_step(arrays, rows).block_until_ready()
    t0 = time.perf_counter()
    for _i in range(5):
        offs = loc_step(arrays, rows)
    offs.block_until_ready()
    walk_rps = 5 * LB / (time.perf_counter() - t0)
    log(f"locate: {walk_rps/1e6:.2f}M rows/s (B={LB})")

    # --- locate, direct tier (build_index(locate="direct"): the SA stays
    # device-resident and locate is ONE gather per row) ---
    @jax.jit
    def loc_direct_step(sa_arr, rows):
        return sa_arr[rows]

    loc_direct_step(sa, rows).block_until_ready()
    t0 = time.perf_counter()
    for _i in range(20):
        offs = loc_direct_step(sa, rows)
    offs.block_until_ready()
    direct_rps = 20 * LB / (time.perf_counter() - t0)
    log(f"locate (direct tier): {direct_rps/1e6:.2f}M rows/s (B={LB})")

    # --- regex / approx over the index: the device frontier engine
    # (femto.pdf §4.2 approximate-search axis) ---
    from femto_tpu.query.nfa import compile_nfa
    from femto_tpu.query.parser import parse_query
    from femto_tpu.query.planning import streamline
    from femto_tpu.query.regexp_device import run_regexp_device

    regex_stats = {}
    iters_rx = int(os.environ.get("BENCH_REGEX_ITERS", "10"))
    for name, (q, fcap, layers) in {
        # 4 literals of 4 chars: 4 character layers
        "alternation": ('("the "|"and "|"ing "|"ion ")', 256, 4),
        # edit distance 1 around a 4-char literal: up to 5 layers
        "approx1": ("APPROX 1 ther", 1024, 5),
    }.items():
        node = parse_query(q)
        nfa = compile_nfa(streamline(node.regexp))
        matches = run_regexp_device(index, nfa, node.approx,
                                    frontier_cap=fcap)  # warm/compile
        t0 = time.perf_counter()
        for _i in range(iters_rx):
            matches = run_regexp_device(index, nfa, node.approx,
                                        frontier_cap=fcap)
        dt = (time.perf_counter() - t0) / iters_rx
        regex_stats[name] = {
            "queries_per_sec": 1.0 / dt,
            "latency_ms": dt * 1e3,
            "layers": layers,
            "match_ranges": len(matches),
        }
        log(f"regex [{name}]: {dt*1e3:.1f} ms/query ({len(matches)} "
            f"match ranges, {layers} layers)")

    # --- second corpus leg: REAL English prose (word structure, K~100
    # dense symbols, mean BWT run 3.5-4.2 — the statistics the zipf
    # stream lacks).  The prose comes from installed packages'
    # docstrings (examples/corpus_real.py), so it differs between
    # machines. ---
    realtext_out = None
    if os.environ.get("BENCH_REALTEXT", "1") == "1":
        seg_rt = int(os.environ.get("BENCH_SEG_REAL", "2048"))
        # UNIQUE English prose (docstrings + pydoc topics) — a repeated
        # corpus inflates BWT run lengths and overstates compression
        # (examples/corpus_real.py)
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "examples"))
        from corpus_real import english_prose
        buf = english_prose(mb)
        if len(buf) < n:
            tiled_pct = 100.0 * (n - len(buf)) / n
            log(f"realtext: only {len(buf)/2**20:.1f} MiB unique prose; "
                f"tiling the tail ({tiled_pct:.0f}% repeated)")
            buf = (buf * (-(-n // len(buf))))
        raw = buf[:n]
        raw_np = np.frombuffer(raw, np.uint8).astype(np.int32) \
            + CHARACTER_OFFSET
        pos = np.arange(n, dtype=np.int64)
        is_end = (pos % doc_size == doc_size - 1) | (pos == n - 1)
        raw_np = np.where(is_end, SEOF, raw_np).astype(np.int32)
        alpha_rt = np.unique(raw_np)
        text_rt = jax.device_put(jnp.asarray(raw_np)).block_until_ready()
        log(f"realtext leg: english prose {mb} MiB on device, "
            f"K={len(alpha_rt)}, seg={seg_rt}")

        def sa_barrier_rt():
            payload = build_sa_payload(
                text_rt, doc_starts_dev, n=n, mark_period=mark_period,
                ndocs=ndocs,
            )
            sa, pull = ft.suffix_array(text_rt, payload=payload,
                                       alpha=alpha_rt)
            return jax.block_until_ready((sa, pull))

        sa_rt, pull_rt = sa_barrier_rt()
        t0 = time.perf_counter()
        sa_rt, pull_rt = sa_barrier_rt()
        t_sa_rt = time.perf_counter() - t0
        log(f"realtext suffix array: {t_sa_rt:.2f}s steady "
            f"({mb / t_sa_rt:.2f} MiB/s)")

        def build_barrier_rt(t):
            arrays_t, n_marks_t, _ = build_fm_arrays_device(
                text_rt, sa_rt, doc_starts_dev,
                n=n, seg=seg_rt, mark_period=mark_period, ndocs=ndocs,
                tier=t, pull=pull_rt, alpha=alpha_rt,
            )
            jax.block_until_ready(arrays_t)
            return arrays_t, int(n_marks_t)

        pats_rt = slice_patterns(text_rt, jnp.asarray(starts))
        pats_rt.block_until_ready()
        rt_sps, rt_bpc = {}, {}
        rt_totals = set()
        rt_arrays = {}
        for t in tier_names:
            arrays_t, _nm = build_barrier_rt(t)
            rt_arrays[t] = arrays_t
            rt_bpc[t] = arrays_bpc(arrays_t)

            rt_totals.add(int(count_step(arrays_t, pats_rt)[0]))
            t0 = time.perf_counter()
            for _i in range(iters):
                out = count_step(arrays_t, pats_rt)
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            rt_sps[t] = B * P * iters / dt
            log(f"realtext [{t}]: {rt_bpc[t]:.3f} B/char, "
                f"{rt_sps[t]/1e6:.2f}M steps/s")
        assert len(rt_totals) == 1, f"realtext tier mismatch: {rt_totals}"

        # walk on the headline-compression tier at this geometry
        walk_t = os.environ.get("BENCH_REALTEXT_WALK_TIER", "vrle")
        loc_step(rt_arrays[walk_t], rows).block_until_ready()
        t0 = time.perf_counter()
        for _i in range(5):
            offs = loc_step(rt_arrays[walk_t], rows)
        offs.block_until_ready()
        rt_walk = 5 * LB / (time.perf_counter() - t0)
        log(f"realtext locate walk [{walk_t}]: {rt_walk/1e6:.2f}M rows/s")
        realtext_out = {
            "seg": seg_rt,
            "corpus": "english-prose",
            "tiers": rt_sps,
            "tiers_bytes_per_char": rt_bpc,
            "locate_walk_rows_per_sec": {walk_t: rt_walk},
        }

    print(json.dumps({
        "metric": "backward_search_steps_per_sec_per_device",
        "value": sps,
        "unit": "steps/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card(),
        # every serving tier's count throughput, both locate tiers, and
        # the steady build rate
        "tiers": {t: tier_sps[t] for t in tier_names},
        "tiers_bytes_per_char": tier_bpc,
        "locate_rows_per_sec": {"walk": walk_rps, "direct": direct_rps},
        "build_mib_per_sec": mb / (t_sa + t_build),
        "headline_tier": tier,
        "regex": regex_stats,
        "realtext": realtext_out,
    }))


if __name__ == "__main__":
    main()
