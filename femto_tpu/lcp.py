"""LCP arrays and the suffix-analysis application family.

Counterparts of the reference's Chapel application layer
(/root/reference/src/ssort_chpl/): computeSuffixArrayAndLCP + parallel
(sparse) PLCP (SuffixSort.chpl:125-160, SuffixSortImpl.chpl:3130+),
FindUnique (minimal unique substrings per position, FindUnique.chpl),
ExtractUniqueKmers, and SuffixSimilarity (block-LCP common-substring
scoring, SuffixSimilarity.chpl).

The device LCP is NOT Kasai's sequential pass: all pairs (suffix, SA
predecessor) are compared in parallel with geometrically growing windows
and lane compaction — a lane leaves after its first mismatching window, so
total work is O(sum of LCP values / window) with O(log maxLCP) rounds.
Average-case text (LCP ~ tens) finishes in 1-2 rounds of two contiguous
gathers each.  Small inputs fall back to the native C++ Kasai (ft_kasai) /
numpy host pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .alphabet import PreparedText

# Below this size the host Kasai pass beats device dispatch overhead.
_DEVICE_LCP_MIN_N = 1 << 17


def _lcp_round_jit():
    """Lazily-built jitted round (keeps jax import out of module import)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("W",))
    def round_fn(text, i_pos, j_pos, h, valid, W):
        n = text.shape[0]
        ii = (i_pos + h)[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        jj = (j_pos + h)[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        wi = jnp.where(ii < n, text[jnp.minimum(ii, n - 1)], -1)
        wj = jnp.where(jj < n, text[jnp.minimum(jj, n - 1)], -2)
        eq = (wi == wj) & valid[:, None]
        ml = jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=1), axis=1)
        return h + ml, valid & (ml == W)

    return round_fn


@functools.lru_cache(maxsize=1)
def _round_cached():
    return _lcp_round_jit()


def _compact_lanes_jit():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("B_out", "M_out"))
    def compact(out, i_pos, j_pos, h, act, orig, *, B_out, M_out):
        out = out.at[jnp.where(~act & (orig < B_out), orig, B_out)].set(
            h, mode="drop"
        )
        pos = jnp.cumsum(act.astype(jnp.int32)) - 1
        tgt = jnp.where(act, jnp.minimum(pos, M_out - 1), M_out)

        def comp(x, fill):
            return (
                jnp.full((M_out + 1,), fill, jnp.int32)
                .at[tgt].set(x, mode="drop")[:M_out]
            )

        return (out, comp(i_pos, 0), comp(j_pos, 0), comp(h, 0),
                comp(orig, B_out))

    return compact


@functools.lru_cache(maxsize=1)
def _compact_cached():
    return _compact_lanes_jit()


def _bucket(x: int, minimum: int = 256) -> int:
    b = minimum
    while b < x:
        b *= 2
    return b


def batch_lcp_device(text_dev, i_np: np.ndarray, j_np: np.ndarray,
                     valid_np: np.ndarray) -> np.ndarray:
    """LCP of suffix pairs (i, j), batched on device.  Invalid lanes get 0.

    Windowed compare: W symbols per round (two contiguous gathers), lanes
    with a mismatch resolve and compact away, W doubles up to 4096 — the
    parallel replacement for Kasai's sequential h-reuse."""
    import jax.numpy as jnp

    B = len(i_np)
    if B == 0:
        return np.zeros(0, np.int32)
    round_fn = _round_cached()
    compact_fn = _compact_cached()
    Bp = _bucket(B)
    i_c = jnp.asarray(np.concatenate(
        [i_np.astype(np.int32), np.zeros(Bp - B, np.int32)]))
    j_c = jnp.asarray(np.concatenate(
        [j_np.astype(np.int32), np.zeros(Bp - B, np.int32)]))
    act = jnp.asarray(np.concatenate(
        [valid_np.astype(bool), np.zeros(Bp - B, bool)]))
    h = jnp.zeros((Bp,), jnp.int32)
    orig = jnp.arange(Bp, dtype=jnp.int32)
    out = jnp.zeros((Bp,), jnp.int32)
    W = 32
    while True:
        h, act = round_fn(text_dev, i_c, j_c, h, act, W)
        m = int(jnp.sum(act.astype(jnp.int32)))
        M_out = _bucket(max(m, 1))
        out, i_c, j_c, h, orig = compact_fn(
            out, i_c, j_c, h, act, orig, B_out=Bp, M_out=M_out
        )
        if m == 0:
            break
        act = jnp.arange(M_out) < m
        W = min(W * 2, 4096)
    return np.asarray(out)[:B]


def lcp_array(text: np.ndarray, sa: np.ndarray,
              device: Optional[bool] = None) -> np.ndarray:
    """lcp[r] = LCP of suffixes SA[r-1], SA[r]; lcp[0] = 0.

    device=None picks the parallel device path for large inputs and the
    native/host Kasai pass for small ones."""
    n = len(text)
    if device is None:
        device = n >= _DEVICE_LCP_MIN_N
    if device and n:
        import jax.numpy as jnp

        sa_np = np.asarray(sa, dtype=np.int32)
        text_dev = jnp.asarray(np.ascontiguousarray(text, np.int32))
        i_np = sa_np.copy()
        j_np = np.concatenate([sa_np[:1], sa_np[:-1]])
        valid = np.ones(n, bool)
        valid[0] = False
        return batch_lcp_device(text_dev, i_np, j_np, valid)
    text = np.ascontiguousarray(text, dtype=np.uint16)
    sa32 = np.ascontiguousarray(sa, dtype=np.int32)
    out = np.zeros(n, dtype=np.int32)
    from .io import native as nat

    if n and nat.ensure_built():
        nat._lib.ft_kasai.restype = ctypes.c_int
        rc = nat._lib.ft_kasai(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            sa32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == 0:
            return out
    return _kasai_np(text, sa32)


def _kasai_np(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    n = len(text)
    lcp = np.zeros(n, dtype=np.int32)
    if n == 0:
        return lcp
    rank = np.zeros(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = int(sa[r - 1])
            while i + h < n and j + h < n and text[i + h] == text[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    return lcp


def sparse_plcp(text: np.ndarray, sa: np.ndarray, q: int = 64) -> np.ndarray:
    """Sampled PLCP (Kärkkäinen): plcp values at positions 0, q, 2q, ...
    The full PLCP can be reconstructed within q of a sample
    (computeSparsePLCP, SuffixSort.chpl:143, SuffixSortImpl.chpl:3130+).

    Computes ONLY the n/q sampled values: plcp[i] = lcp(T[i..], T[phi(i)..])
    with phi(i) = SA[ISA[i]-1], each pair compared by the parallel windowed
    batch — never materializing the full LCP array (the round-1 version
    ran a full sequential Kasai pass first)."""
    import jax.numpy as jnp

    n = len(text)
    if n == 0:
        return np.zeros(0, np.int32)
    sa_np = np.asarray(sa, dtype=np.int64)
    isa = np.empty(n, dtype=np.int64)
    isa[sa_np] = np.arange(n, dtype=np.int64)
    pos = np.arange(0, n, q, dtype=np.int64)
    r = isa[pos]
    valid = r > 0
    phi = sa_np[np.maximum(r - 1, 0)]
    text_dev = jnp.asarray(np.ascontiguousarray(text, np.int32))
    return batch_lcp_device(
        text_dev, pos.astype(np.int32), phi.astype(np.int32), valid
    )


def unique_lengths(prepared: PreparedText, sa: np.ndarray,
                   lcp: Optional[np.ndarray] = None) -> np.ndarray:
    """FindUnique: for each text position i, the length of the shortest
    substring starting at i that occurs nowhere else (0 if none exists
    within the document).  minUnique[i] = 1 + max(lcp with SA neighbors);
    capped at the document boundary (FindUnique.chpl semantics: output is a
    per-position length array)."""
    text = prepared.text
    n = len(text)
    if lcp is None:
        lcp = lcp_array(text, sa)
    rank = np.zeros(n, dtype=np.int64)
    rank[np.asarray(sa, dtype=np.int64)] = np.arange(n)
    lcp_next = np.concatenate([lcp[1:], np.zeros(1, np.int32)])
    need = 1 + np.maximum(lcp[rank], lcp_next[rank]).astype(np.int64)
    # distance to end of document (excluding the SEOF terminator)
    pos = np.arange(n, dtype=np.int64)
    doc_of = np.searchsorted(prepared.doc_starts, pos, side="right") - 1
    doc_content_end = prepared.doc_starts[doc_of + 1] - 1
    room = doc_content_end - pos
    out = np.where(need <= room, need, 0).astype(np.int32)
    # positions at/after a doc's content end (the SEOF itself) are 0
    out[room <= 0] = 0
    return out


def extract_unique_kmers(prepared: PreparedText, sa: np.ndarray, k: int,
                         lcp: Optional[np.ndarray] = None
                         ) -> List[Tuple[int, int]]:
    """ExtractUniqueKmers: (doc, offset) of every position whose minimal
    unique substring is at most k long (i.e. its k-mer is unique)."""
    ul = unique_lengths(prepared, sa, lcp)
    pos = np.nonzero((ul > 0) & (ul <= k))[0]
    doc_of = np.searchsorted(prepared.doc_starts, pos, side="right") - 1
    off = pos - prepared.doc_starts[doc_of]
    return list(zip(doc_of.tolist(), off.tolist()))


def suffix_similarity(prepared: PreparedText, sa: np.ndarray,
                      lcp: Optional[np.ndarray] = None,
                      min_lcp: int = 4) -> Dict[Tuple[int, int], float]:
    """SuffixSimilarity: score document pairs by shared substrings.

    Adjacent SA rows belonging to different documents with LCP >= min_lcp
    contribute their LCP to the pair's score; scores are normalized by the
    geometric mean of the two documents' lengths (the spirit of
    SuffixSimilarity.chpl's block-LCP scoring)."""
    text = prepared.text
    n = len(text)
    if lcp is None:
        lcp = lcp_array(text, sa)
    sa = np.asarray(sa, dtype=np.int64)
    doc_of = np.searchsorted(prepared.doc_starts, sa, side="right") - 1
    d_prev = doc_of[:-1]
    d_cur = doc_of[1:]
    l = lcp[1:]
    sel = (d_prev != d_cur) & (l >= min_lcp)
    pairs: Dict[Tuple[int, int], float] = {}
    a = np.minimum(d_prev[sel], d_cur[sel])
    b = np.maximum(d_prev[sel], d_cur[sel])
    for x, y, v in zip(a.tolist(), b.tolist(), l[sel].tolist()):
        pairs[(x, y)] = pairs.get((x, y), 0.0) + float(v)
    lens = np.maximum(np.diff(prepared.doc_starts) - 1, 1)
    return {
        (x, y): v / float(np.sqrt(lens[x] * lens[y]))
        for (x, y), v in pairs.items()
    }
