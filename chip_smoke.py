"""Smoke run of femto_tpu's main path on an NVIDIA GPU.

    python chip_smoke.py [--mb 512] [--seed 0]
    python chip_smoke.py --four-cards [--mb 256]

One card (the default): generate a seeded word-structured corpus, build
it with `build_index` at tier "packed" (seg 256) and tier "vrle" (seg
2048), then serve count, locate, extract, regex, APPROX and Boolean
queries through the library, the HTTP server and the paged
(larger-than-memory) path.  Every phase is checked against a host oracle
and any mismatch ends the run with a non-zero exit.  A last phase times
the build's histogram and code-map primitives against their one-hot /
compare-reduce formulations and checks both against numpy.

--four-cards runs only the mesh path: `build_index_sharded` over
`make_mesh(4)` at both tiers, then sharded count, locate, regex and
Boolean queries against the same host oracle.  Its default is 256 MiB
(64 MiB a card): on this corpus about half the suffixes share their seed
sort's 10-symbol prefix, so the mesh build takes its full prefix-doubling
fallback, whose padded exchanges asked for 74 GiB a card at 512 MiB (and
the seed sort for 120 GiB a card at 1536 MiB) on 80 GB cards.

The last line of standard output is one JSON object naming the device:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

N_PATTERNS = 32768       # one count batch (the serving batch size)
N_ABSENT = 256           # patterns of the batch that occur nowhere
N_ORACLE = 64            # batch entries checked against the host scan
DOC_MEAN_BYTES = 450_000  # femto.pdf Table 1 "Gutenberg": mean doc size
VOCAB = 50_000           # Zipf vocabulary size
# uppercase letters and digits never occur in the generated prose, so
# each needle occurs exactly where it was planted
NEEDLES = (b"NEEDLE-A7Q", b"NEEDLE-B3X", b"NEEDLE-C9Z")
TIERS = (("packed", 256), ("vrle", 2048))
MARK_PERIOD = 20

# English letter frequencies (per cent), for the vocabulary's spelling
_LETTERS = b"etaoinshrdlcumwfgypbvkjxqz"
_LETTER_PCT = (12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8,
               2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15,
               0.10, 0.07)
# what follows each word, and how often
_SEPS = (b" ", b", ", b". ", b".\n")
_SEP_P = (0.86, 0.07, 0.06, 0.01)


class SmokeFailure(RuntimeError):
    """An oracle check failed."""


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Corpus and host oracle
# ---------------------------------------------------------------------------


class Corpus:
    """Seeded word-structured prose: Zipf-distributed words over a
    generated vocabulary, documents of ~DOC_MEAN_BYTES, NEEDLES planted in
    known documents.  No text is repeated by tiling."""

    def __init__(self, mb: float, seed: int):
        rng = np.random.default_rng(seed)
        total = int(mb * (1 << 20))
        tok_bytes, tok_start, tok_len, cdf, self.vocab = self._tokens(rng)
        # small runs still get several documents
        mean = min(DOC_MEAN_BYTES, max(total // 16, 256))
        mu = np.log(mean) - 0.18          # lognormal, sigma 0.6, mean `mean`
        wants = []
        while sum(wants) < total:
            want = int(np.clip(rng.lognormal(mu, 0.6), mean // 16, 8 * mean))
            wants.append(min(want, total - sum(wants)))
        # one generator per document, so threads give the same corpus
        seeds = np.random.SeedSequence([seed, len(wants)]).spawn(len(wants))
        with concurrent.futures.ThreadPoolExecutor(
                min(16, os.cpu_count() or 1)) as ex:
            docs = list(ex.map(
                lambda sw: self._doc(np.random.default_rng(sw[0]), sw[1],
                                     tok_bytes, tok_start, tok_len, cdf),
                zip(seeds, wants)))
        # overlapping needle document sets: A & B = {1}, B & C = {3}
        picks = rng.choice(len(docs), size=6, replace=False)
        self.needle_docs = {}
        for needle, which in zip(NEEDLES, ((0, 1, 4), (1, 2, 3), (3, 4, 5))):
            self.needle_docs[needle] = sorted(int(picks[i]) for i in which)
            for d in self.needle_docs[needle]:
                doc = docs[d]
                at = doc.find(b" ", int(rng.integers(0, max(len(doc), 1))))
                at = len(doc) if at < 0 else at + 1
                docs[d] = doc[:at] + needle + b" " + doc[at:]
        self.docs = docs
        self.lens = np.array([len(d) for d in docs], np.int64)
        # joined with a byte that never occurs in the prose or a pattern,
        # so a scan of `joined` never matches across documents
        self.starts = np.concatenate([[0], np.cumsum(self.lens + 1)[:-1]])
        self.joined = np.frombuffer(b"\x00".join(docs), np.uint8)
        self.byte_freq = np.bincount(self.joined, minlength=256)

    @staticmethod
    def _tokens(rng):
        """(flat token bytes, token starts, token lengths, Zipf cdf over
        words, words by rank).  Token id = word * len(_SEPS) + separator."""
        p = np.asarray(_LETTER_PCT) / np.sum(_LETTER_PCT)
        words, seen = [], set()
        while len(words) < VOCAB:
            lens = np.clip(np.rint(rng.lognormal(np.log(6.0), 0.45, 4096)),
                           1, 18).astype(int)
            letters = rng.choice(np.frombuffer(_LETTERS, np.uint8),
                                 size=int(lens.sum()), p=p)
            off = 0
            for L in lens:
                w = letters[off:off + L].tobytes()
                off += L
                if w not in seen:
                    seen.add(w)
                    words.append(w)
        # frequent words tend to be short, as in English
        key = np.array([len(w) for w in words[:VOCAB]]) \
            + rng.normal(0.0, 2.5, VOCAB)
        words = [words[i] for i in np.argsort(key, kind="stable")]
        toks = [w + s for w in words for s in _SEPS]
        tok_len = np.array([len(t) for t in toks], np.int64)
        tok_start = np.concatenate([[0], np.cumsum(tok_len)[:-1]])
        zipf = 1.0 / np.arange(1, VOCAB + 1)
        cdf = np.cumsum(zipf / zipf.sum())
        return (np.frombuffer(b"".join(toks), np.uint8), tok_start, tok_len,
                cdf, words)

    @staticmethod
    def _doc(rng, want, tok_bytes, tok_start, tok_len, cdf):
        k = int(want / 5.0) + 64
        while True:
            w = np.minimum(np.searchsorted(cdf, rng.random(k)), VOCAB - 1)
            s = np.searchsorted(np.cumsum(_SEP_P), rng.random(k) * 0.999999)
            tok = w * len(_SEPS) + s
            lens = tok_len[tok]
            if lens.sum() >= want:
                break
            k *= 2
        excl = np.cumsum(lens) - lens
        idx = np.repeat(tok_start[tok] - excl, lens) + np.arange(lens.sum())
        return tok_bytes[idx[:want]].tobytes()

    @property
    def nbytes(self) -> int:
        return int(self.lens.sum())

    def word(self, rank: int) -> bytes:
        """The rank-th most frequent word (rank 0 = most frequent)."""
        return self.vocab[rank]

    def positions(self, pat: bytes) -> np.ndarray:
        """Ascending start offsets of `pat` in `joined` (overlapping)."""
        a = self.joined
        m = len(pat)
        if m == 0 or m > a.size:
            return np.zeros(0, np.int64)
        p = np.frombuffer(pat, np.uint8)
        j = int(np.argmin(self.byte_freq[p]))     # anchor: rarest byte
        cand = np.flatnonzero(a == p[j]).astype(np.int64) - j
        cand = cand[(cand >= 0) & (cand <= a.size - m)]
        for k in range(m):
            if k != j and cand.size:
                cand = cand[a[cand + k] == p[k]]
        return cand

    def count(self, pat: bytes) -> int:
        """tests/oracle.naive_count semantics: overlapping occurrences
        within documents."""
        return int(self.positions(pat).size)

    def locate(self, pat: bytes):
        """Sorted (doc, offset) of every occurrence."""
        pos = self.positions(pat)
        doc = np.searchsorted(self.starts, pos, side="right") - 1
        return sorted(zip(doc.tolist(), (pos - self.starts[doc]).tolist()))

    def docs_with(self, pat: bytes) -> set:
        return {d for d, _ in self.locate(pat)}

    def patterns(self, rng, n: int, n_absent: int):
        """n patterns of length 4-16: n - n_absent sampled uniformly from
        the corpus text, n_absent that occur nowhere."""
        n_present = n - n_absent
        L = rng.integers(4, 17, size=n_present)
        pos = rng.integers(0, self.nbytes, size=n_present)
        cum = np.cumsum(self.lens)
        doc = np.searchsorted(cum, pos, side="right")
        off = pos - (cum[doc] - self.lens[doc])
        off = np.maximum(np.minimum(off, self.lens[doc] - L), 0)
        g = self.starts[doc] + off
        raw = self.joined
        pats = [raw[s:s + k].tobytes() for s, k in zip(g.tolist(), L.tolist())]
        letters = np.frombuffer(_LETTERS, np.uint8)
        for _ in range(n_absent):
            k = int(rng.integers(3, 16))
            pats.append(b"Q" + rng.choice(letters, size=k).tobytes())
        order = rng.permutation(n)
        return [pats[i] for i in order]


# ---------------------------------------------------------------------------
# Timing: wall time per phase, compile time reported apart as set-up
# ---------------------------------------------------------------------------


class CompileClock:
    """Sums JAX's compile-event durations (tracing, lowering, backend
    compile) so a phase's wall time can be split into set-up and run."""

    def __init__(self):
        import jax

        self.secs = 0.0
        self._lock = threading.Lock()
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, *args, **kwargs):
        if event.startswith("/jax/core/compile/"):
            with self._lock:
                self.secs += secs


class Phase:
    def __init__(self, clock: CompileClock, name: str, times: dict):
        self.clock, self.name, self.times = clock, name, times

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = self.clock.secs
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        comp = min(self.clock.secs - self.c0, wall)
        self.times[self.name] = {"wall_s": wall, "compile_s": comp}
        state = "failed" if exc[0] else "done"
        log(f"phase {self.name}: {state}, wall {wall:.3f} s "
            f"(set-up/compile {comp:.3f} s, run {wall - comp:.3f} s)")
        return False


def peak_bytes(dev):
    stats = dev.memory_stats()
    return None if not stats else int(stats.get("peak_bytes_in_use", 0))


def index_bytes(index) -> int:
    import jax

    return sum(leaf.nbytes for leaf in jax.tree.leaves(index.arrays))


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------


def query_terms(corpus: Corpus):
    """(alternation regex, its literal alternatives, APPROX term)."""
    alts = [corpus.word(r) + b" " for r in (0, 3, 7, 12)]
    regex = "(" + "|".join('"%s"' % a.decode() for a in alts) + ")"
    approx_word = next(w for w in (corpus.word(r) for r in range(40, 400))
                       if len(w) >= 5)
    return regex, alts, "APPROX 1 " + approx_word.decode()


def check_counts(corpus, pats, counts, label):
    """Check the counts of an evenly spaced sample of N_ORACLE patterns,
    and of up to 8 absent ones, against the host scan."""
    idx = np.unique(np.linspace(0, len(pats) - 1, N_ORACLE).astype(int))
    absent = [i for i, p in enumerate(pats) if p[:1] == b"Q"][:8]
    for i in sorted(set(idx.tolist()) | set(absent)):
        want = corpus.count(pats[i])
        check(int(counts[i]) == want,
              f"{label}: count({pats[i]!r}) = {int(counts[i])}, "
              f"host scan {want}")


def phase_build(corpus, clock, times):
    import femto_tpu as ft

    prepared = ft.prepare_documents(
        corpus.docs, infos=[b"doc%d" % i for i in range(len(corpus.docs))])
    indexes = {}
    for tier, seg in TIERS:
        with Phase(clock, f"build[{tier},seg={seg}]", times):
            ix = ft.build_index(prepared, seg=seg, mark_period=MARK_PERIOD,
                                tier=tier, doc_chunks=True)
            ix.arrays.bwt.block_until_ready()
        check(ix.meta.n == prepared.n, f"{tier}: n mismatch")
        log(f"index[{tier}]: {index_bytes(ix)} bytes, "
            f"{index_bytes(ix) / prepared.n:.4f} bytes/symbol")
        indexes[tier] = ix
    return indexes


def phase_count(corpus, indexes, pats, clock, times):
    import femto_tpu as ft

    counts = {}
    for tier in indexes:
        with Phase(clock, f"count[{tier}] cold", times):
            counts[tier] = ft.count(indexes[tier], pats)
        with Phase(clock, f"count[{tier}] warm", times):
            again = ft.count(indexes[tier], pats)
        check(np.array_equal(again, counts[tier]), f"{tier}: unstable count")
    tiers = list(counts)
    check(np.array_equal(counts[tiers[0]], counts[tiers[1]]),
          "tiers disagree on the count batch")
    check_counts(corpus, pats, counts[tiers[0]], "count")
    nz = int(np.count_nonzero(counts[tiers[0]]))
    log(f"count: {len(pats)} patterns, {nz} present, tiers agree, "
        f"host scan agrees on the sample")
    return counts[tiers[0]]


def locate_patterns(corpus, pats, counts):
    """A few located patterns: the needles and sampled patterns with
    1-2000 occurrences."""
    picks = list(NEEDLES)
    for p, c in zip(pats, counts):
        if 1 <= c <= 2000 and len(p) >= 6:
            picks.append(p)
        if len(picks) >= len(NEEDLES) + 3:
            break
    return picks


def phase_queries(corpus, indexes, pats, counts, clock, times):
    import femto_tpu as ft
    from femto_tpu.query.engine import count_query, docs_query
    from femto_tpu.query.nfa import compile_nfa
    from femto_tpu.query.parser import parse_query
    from femto_tpu.query.planning import streamline
    from femto_tpu.query.regexp import match_rows, run_regexp

    picks = locate_patterns(corpus, pats, counts)
    regex, alts, approx = query_terms(corpus)
    short_docs = [int(d) for d in np.argsort(corpus.lens)[:2]]
    for tier, ix in indexes.items():
        with Phase(clock, f"locate+extract[{tier}]", times):
            for p in picks:
                check(ft.locate(ix, p) == corpus.locate(p),
                      f"{tier}: locate({p!r}) differs from host find")
            for d in short_docs:
                check(ft.extract_document(ix, d) == corpus.docs[d],
                      f"{tier}: extract_document({d}) differs")
        with Phase(clock, f"regex+approx[{tier}]", times):
            for q in (regex, approx):
                got = count_query(ix, q)
                node = parse_query(q)
                host = run_regexp(ix, compile_nfa(streamline(node.regexp)),
                                  node.approx, max_results=1 << 20)
                want = sum(l - f for f, l in match_rows(host))
                check(got == want,
                      f"{tier}: count_query({q!r}) = {got}, host engine "
                      f"{want}")
                if q == regex:
                    scan = sum(corpus.count(a) for a in alts)
                    check(got == scan, f"{tier}: regex {got} vs scan {scan}")
                log(f"query[{tier}] {q!r}: {got} matches")
        with Phase(clock, f"boolean[{tier}]", times):
            a, b = NEEDLES[1], NEEDLES[2]
            q = f"'{a.decode()}' AND '{b.decode()}'"
            got = docs_query(ix, q)
            want = corpus.docs_with(a) & corpus.docs_with(b)
            check({d for d, _, _ in got} == want,
                  f"{tier}: docs_query({q!r}) differs from host sets")
            for d, _, offs in got:   # AND keeps the left term's offsets
                want_offs = [o for dd, o in corpus.locate(a) if dd == d]
                check(sorted(offs) == want_offs, f"{tier}: offsets of {d}")
            log(f"boolean[{tier}] {q!r}: docs {sorted(want)}")


def phase_server(corpus, index, pats, counts, clock, times):
    from http.server import ThreadingHTTPServer

    import femto_tpu as ft
    from femto_tpu.server.server import FemtoServer, IndexPool, make_handler

    picks = locate_patterns(corpus, pats, counts)
    with Phase(clock, "server", times):
        srv = FemtoServer(index)
        pool = IndexPool()
        httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0),
            make_handler(srv, pool, tempfile.gettempdir()))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = "http://127.0.0.1:%d/" % httpd.server_address[1]

        def post(line: str):
            req = urllib.request.Request(url, data=line.encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        reqs = ([("find_strings '%s'" % p.decode(), p) for p in picks]
                + [("find_docs 0 1 '%s'" % p.decode(), p) for p in picks])
        try:
            with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
                futs = [(ex.submit(post, line), line, p)
                        for line, p in reqs]
                for fut, line, p in futs:
                    got = fut.result()
                    if line.startswith("find_strings"):
                        f, l = ft.count_ranges(index, [p])
                        want = [[int(f[0]), int(l[0])]] if l[0] > f[0] else []
                        check([m["range"] for m in got["matches"]] == want,
                              f"server {line!r}: {got} vs {want}")
                    else:
                        per_doc = {}
                        for d, o in ft.locate(index, p):
                            per_doc.setdefault(d, []).append(o)
                        want = [{"doc_info": "doc%d" % d, "offsets": o}
                                for d, o in sorted(per_doc.items())]
                        check(got["results"] == want,
                              f"server {line!r} differs from locate")
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.stop()
            pool.stop()
    log(f"server: {len(reqs)} concurrent HTTP requests match the API; "
        f"collector {srv.counter.stats}")


def phase_paged(corpus, index, pats, counts, clock, times):
    import femto_tpu as ft
    from femto_tpu.paged import HOST_RESIDENT, load_paged

    tmp = tempfile.mkdtemp(prefix="femto_smoke_")
    try:
        path = os.path.join(tmp, "index.ftpu")
        with Phase(clock, "paged save+load", times):
            index.save_flat(path)
            meta, infos, arrs = ft.FMIndex.parse_flat(path)
            row_bytes = arrs["bwt"].nbytes
            n_seg = arrs["bwt"].shape[0]
            resident = sum(v.nbytes for k, v in arrs.items()
                           if k not in HOST_RESIDENT)
            # a device budget of the resident arrays, the slot map and a
            # quarter of the row store
            budget = resident + n_seg * 4 + row_bytes // 4
            pg = load_paged(path, budget_bytes=budget)
        log(f"paged: rows {row_bytes} bytes, cache {pg.cache_rows} of "
            f"{n_seg} segments")
        # (PagedIndex keeps at least 256 rows, which tiny corpora exceed)
        check(pg.cache_rows <= max(256, n_seg // 4 + 1),
              "paged cache holds more than a quarter of the rows")
        with Phase(clock, "paged count", times):
            got = pg.count(pats)
        check(np.array_equal(got, counts), "paged counts differ")
        with Phase(clock, "paged locate", times):
            for p in locate_patterns(corpus, pats, counts):
                check(pg.locate(p) == ft.locate(index, p),
                      f"paged locate({p!r}) differs")
        log(f"paged: counts and locates equal the resident index; "
            f"stats {pg.stats}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- build primitives: the plain forms the library uses, timed against
# the one-hot / compare-reduce formulations they replaced ---------------


def onehot_seg_hist(codes2d, alpha: int):
    """Per-segment histogram as two one-hot planes contracted per segment
    (a batched matmul).  0/1 operands are exact in bf16 and TF32, and the
    float32 sums stay below 2^24, so the result is exact integers."""
    import jax
    import jax.numpy as jnp

    nhi = -(-alpha // 32)
    n_seg, seg = codes2d.shape
    ch = 2048
    pad = -n_seg % ch
    b3 = jnp.concatenate(
        [codes2d, jnp.full((pad, seg), -1, codes2d.dtype)]
    ).reshape(-1, ch, seg)

    def chunk(bc):
        a = (bc[:, :, None] >> 5 == jnp.arange(nhi)).astype(jnp.bfloat16)
        b = (bc[:, :, None] & 31 == jnp.arange(32)).astype(jnp.bfloat16)
        ps = jnp.einsum("sri,srj->sij", a, b,
                        preferred_element_type=jnp.float32)
        return ps.reshape(ch, nhi * 32)[:, :alpha].astype(jnp.int32)

    return jax.lax.map(chunk, b3).reshape(-1, alpha)[:n_seg]


def onehot_alpha_hist(text):
    """512-bin histogram by the same one-hot contraction."""
    import jax.numpy as jnp

    n = text.shape[0]
    seg = 512
    pad = -n % seg
    t2 = jnp.concatenate([text, jnp.full((pad,), -1, text.dtype)])
    return onehot_seg_hist(t2.reshape(-1, seg), 512).sum(axis=0)


def compare_map_codes(x, used):
    """code(x) = #used < x by a chunked compare-reduce."""
    import jax
    import jax.numpy as jnp

    n = x.shape[0]
    ch = 1 << 20
    xp = jnp.zeros((-(-n // ch) * ch,), x.dtype).at[:n].set(x)

    def chunk(xc):
        return jnp.sum((used[None, :] < xc[:, None]).astype(jnp.int32),
                       axis=1)

    return jax.lax.map(chunk, xp.reshape(-1, ch)).reshape(-1)[:n]


def _time(fn, *args, reps: int = 3):
    """(result, best seconds of `reps` warm calls); the first call
    compiles and is not timed."""
    out = fn(*args)
    out.block_until_ready()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        out.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return out, best


def phase_primitives(corpus, clock, times):
    """Time each build primitive against its replaced formulation on the
    corpus text at the build's shapes; both must equal numpy."""
    import functools

    import jax
    import jax.numpy as jnp

    import femto_tpu as ft
    from femto_tpu.ops.build_ops import map_codes, seg_hist
    from femto_tpu.suffix import _alpha_hist

    prepared = ft.prepare_documents(corpus.docs)
    text_np = prepared.text.astype(np.int32)
    n = text_np.size
    text = jnp.asarray(text_np)
    host_hist = np.bincount(text_np, minlength=512)
    rows = {}
    with Phase(clock, "primitives", times):
        plain, t_plain = _time(jax.jit(functools.partial(_alpha_hist, n=n)),
                               text)
        onehot, t_onehot = _time(jax.jit(onehot_alpha_hist), text)
        for name, got in (("plain", plain), ("one-hot", onehot)):
            check(np.array_equal(np.asarray(got), host_hist),
                  f"alphabet histogram ({name}) != np.bincount")
        rows["alphabet histogram [512]"] = (t_plain, t_onehot)

        # the serving-tier histograms: ALPHA_SIZE columns per segment,
        # exact against np.bincount on the first segments
        from femto_tpu.alphabet import ALPHA_SIZE

        for seg in sorted({s for _, s in TIERS}):
            n_seg = n // seg
            c2 = text[: n_seg * seg].reshape(n_seg, seg)
            f_plain = jax.jit(functools.partial(seg_hist, alpha=ALPHA_SIZE))
            f_onehot = jax.jit(functools.partial(onehot_seg_hist,
                                                 alpha=ALPHA_SIZE))
            hp, t_p = _time(f_plain, c2)
            ho, t_o = _time(f_onehot, c2)
            check(bool(jnp.array_equal(hp, ho)),
                  f"seg histogram forms differ at seg={seg}")
            k = min(n_seg, (1 << 24) // seg)
            sid = np.repeat(np.arange(k, dtype=np.int64), seg)
            ref = np.bincount(sid * ALPHA_SIZE + text_np[: k * seg],
                              minlength=k * ALPHA_SIZE).reshape(k, ALPHA_SIZE)
            check(np.array_equal(np.asarray(hp[:k]), ref),
                  f"seg histogram != np.bincount at seg={seg}")
            rows[f"segment histogram [{n_seg}x{seg}] -> [{ALPHA_SIZE}]"] = (
                t_p, t_o)
            del hp, ho

        used = jnp.asarray(np.flatnonzero(host_hist).astype(np.int32))
        mp, t_p = _time(jax.jit(map_codes), text, used)
        mc, t_c = _time(jax.jit(compare_map_codes), text, used)
        want = np.searchsorted(np.asarray(used), text_np[: 1 << 24])
        check(np.array_equal(np.asarray(mp[: 1 << 24]), want),
              "map_codes != numpy searchsorted")
        check(bool(jnp.array_equal(mp, mc)), "code-map forms differ")
        rows[f"code map [{n}] K={int(used.shape[0])}"] = (t_p, t_c)
    for name, (tp, tr) in rows.items():
        log(f"primitive {name}: plain {tp * 1e3:.3f} ms, replaced form "
            f"{tr * 1e3:.3f} ms")
    return rows


def run_one_card(mb: float, seed: int, n_patterns: int = N_PATTERNS):
    import jax

    dev = jax.devices()[0]
    clock = CompileClock()
    times = {}
    with Phase(clock, "corpus", times):
        corpus = Corpus(mb, seed)
    log(f"corpus: {corpus.nbytes} bytes ({mb} MiB), {len(corpus.docs)} "
        f"documents, seed {seed}")
    indexes = phase_build(corpus, clock, times)
    log(f"peak device memory after build: {peak_bytes(dev)} bytes")
    pats = corpus.patterns(np.random.default_rng(seed + 1), n_patterns,
                           min(N_ABSENT, n_patterns // 8))
    counts = phase_count(corpus, indexes, pats, clock, times)
    phase_queries(corpus, indexes, pats, counts, clock, times)
    phase_server(corpus, indexes["packed"], pats, counts, clock, times)
    phase_paged(corpus, indexes["vrle"], pats, counts, clock, times)
    del indexes
    phase_primitives(corpus, clock, times)
    log(f"peak device memory: {peak_bytes(dev)} bytes")
    return times


# ---------------------------------------------------------------------------
# Four cards: the mesh build and the sharded queries only
# ---------------------------------------------------------------------------


def run_four_cards(mb: float, seed: int, n_patterns: int = N_PATTERNS):
    import jax

    import femto_tpu as ft
    from femto_tpu.alphabet import pattern_to_alpha
    from femto_tpu.parallel.dist_build import build_index_sharded
    from femto_tpu.parallel.dist_query import (
        sharded_backward_search, sharded_count_query, sharded_locate,
    )
    from femto_tpu.parallel.mesh import make_mesh
    from femto_tpu.search import pack_patterns

    D = 4
    mesh = make_mesh(D)
    check(mesh.devices.size == D, f"need {D} devices")
    clock = CompileClock()
    times = {}
    with Phase(clock, "corpus", times):
        corpus = Corpus(mb, seed)
    log(f"corpus: {corpus.nbytes} bytes ({mb} MiB), {len(corpus.docs)} "
        f"documents, seed {seed}")
    prepared = ft.prepare_documents(
        corpus.docs, infos=[b"doc%d" % i for i in range(len(corpus.docs))])
    pats = corpus.patterns(np.random.default_rng(seed + 1), n_patterns,
                           min(N_ABSENT, n_patterns // 8))
    packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
    regex, alts, _ = query_terms(corpus)
    mesh_devs = set(mesh.devices.flat)
    counts = {}
    for tier, seg in TIERS:
        with Phase(clock, f"mesh build[{tier},seg={seg}]", times):
            ix = build_index_sharded(prepared, mesh, seg=seg,
                                     mark_period=MARK_PERIOD, tier=tier)
            jax.block_until_ready(ix.arrays)
        # every card holds its own shard of the row store
        per_dev = {}
        for shard in ix.arrays.bwt.addressable_shards:
            per_dev[shard.device] = per_dev.get(shard.device, 0) \
                + shard.data.nbytes
        check(set(per_dev) == mesh_devs and min(per_dev.values()) > 0,
              f"{tier}: row store not spread over the mesh: {per_dev}")
        log(f"mesh index[{tier}]: {index_bytes(ix)} bytes, "
            f"{index_bytes(ix) / prepared.n:.4f} bytes/symbol, row-store "
            f"bytes per card {sorted(per_dev.values())}")
        with Phase(clock, f"mesh count[{tier}]", times):
            f, l = sharded_backward_search(ix, mesh, packed)
            c = (np.asarray(l) - np.asarray(f))[:B]
        counts[tier] = c
        check_counts(corpus, pats, c, f"mesh {tier}")
        with Phase(clock, f"mesh locate[{tier}]", times):
            for p in locate_patterns(corpus, pats, c):
                pk, _ = pack_patterns([pattern_to_alpha(p)])
                f1, l1 = sharded_backward_search(ix, mesh, pk)
                f1, l1 = int(np.asarray(f1)[0]), int(np.asarray(l1)[0])
                rows = np.arange(f1, l1, dtype=np.int32)
                width = max(64, 1 << int(rows.size - 1).bit_length())
                rows = np.concatenate(   # few distinct shapes to compile
                    [rows, np.full(width - rows.size, f1, np.int32)])
                offs = np.asarray(sharded_locate(ix, mesh, rows))[:l1 - f1]
                doc, off = ft.offsets_to_docs(ix, offs.astype(np.int64))
                check(sorted(zip(doc.tolist(), off.tolist()))
                      == corpus.locate(p), f"mesh {tier}: locate({p!r})")
        with Phase(clock, f"mesh regex+boolean[{tier}]", times):
            got = sharded_count_query(ix, mesh, regex)
            want = sum(corpus.count(a) for a in alts)
            check(got == want, f"mesh {tier}: regex {got} vs scan {want}")
            a, b = NEEDLES[0], NEEDLES[2]
            q = f"'{a.decode()}' OR '{b.decode()}'"
            got_b = sharded_count_query(ix, mesh, q)
            want_b = len(corpus.docs_with(a) | corpus.docs_with(b))
            check(got_b == want_b,
                  f"mesh {tier}: {q!r} {got_b} docs vs host {want_b}")
            log(f"mesh query[{tier}] {regex!r}: {got}; {q!r}: {got_b} docs")
        del ix
        peaks = [peak_bytes(d) for d in mesh.devices.flat]
        log(f"peak device memory per card after {tier}: {peaks} bytes")
    check(np.array_equal(counts["packed"], counts["vrle"]),
          "mesh tiers disagree on the count batch")
    return times


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------


def card() -> str:
    """The card's name and power limit, read by nvidia-smi (off JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        out = r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return " | ".join(out.splitlines())


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=None,
                    help="corpus MiB (default 512; 256 with --four-cards)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--patterns", type=int, default=N_PATTERNS,
                    help="patterns in the count batch")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh build and sharded queries on "
                    "four cards")
    args = ap.parse_args(argv)
    mb = args.mb if args.mb is not None else (
        256.0 if args.four_cards else 512.0)
    log("card: " + card())

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, but JAX found platform "
              f"{devices[0].platform!r} ({devices[0].device_kind})",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from femto_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"device: {devices[0].device_kind} x{len(devices)}, jax "
        f"{jax.__version__}")
    run = run_four_cards if args.four_cards else run_one_card
    t0 = time.perf_counter()
    times = run(mb, args.seed, args.patterns)
    total = time.perf_counter() - t0
    comp = sum(t["compile_s"] for t in times.values())
    log(f"total: {total:.3f} s, of which compile {comp:.3f} s")
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
