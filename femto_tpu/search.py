"""High-level query API: count / locate / extract over an FMIndex.

This is the user-facing analog of the reference's femto.h request layer
(/root/reference/src/main/femto.h:86-139) minus the server plumbing (which
lives in femto_tpu/server).  Patterns are byte strings; batching, padding to
static shapes, and jit caching are handled here.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .alphabet import CHARACTER_OFFSET, pattern_to_alpha
from .fmindex import FMIndex
from .ops import search_ops as S
from .ops import rank as R


def _bucket(x: int, minimum: int = 8) -> int:
    """Round up to a power of two to bound jit specializations."""
    b = minimum
    while b < x:
        b *= 2
    return b


def pack_patterns(
    patterns: Sequence[np.ndarray], pad_b: Optional[int] = None
) -> Tuple[np.ndarray, int]:
    """Right-align alpha-coded patterns into int32[B, P] padded with -1."""
    B = len(patterns)
    P = max((len(p) for p in patterns), default=1)
    P = max(P, 1)
    Bp = pad_b if pad_b is not None else _bucket(B)
    Pp = _bucket(P, minimum=4)
    out = np.full((Bp, Pp), -1, dtype=np.int32)
    for i, p in enumerate(patterns):
        if len(p):
            out[i, Pp - len(p):] = p
    return out, B


@functools.partial(jax.jit, static_argnames=("n", "row0"))
def _count_jit(arrays, n, pats, row0=0):
    first, last = S.backward_search(arrays, n, pats, row0=row0)
    return first, last


def _locate_jit(arrays, n, mark_period, rows):
    """Locate dispatch.  Large batches default to the DEVICE-compaction
    pyramid walk (capacity-halving phases, zero host syncs); small
    batches keep the single lockstep loop.  The host-driven phased walk
    stays opt-in via FEMTO_TPU_PHASED_LOCATE=1."""
    import os

    if os.environ.get("FEMTO_TPU_PHASED_LOCATE"):
        return S.locate_rows_phased(arrays, mark_period, rows)
    if rows.shape[0] >= 16384 and mark_period >= 6:
        return S.locate_rows_pyramid(arrays, mark_period, rows)
    return S._locate_rows_jit(arrays, mark_period, rows)


@jax.jit
def _locate_direct_jit(sa_direct, rows):
    """Direct-locate tier: offset = SA[row], one gather (FMIndex.sa_direct)."""
    return sa_direct[rows]


def _locate_rows_dispatch(index: FMIndex, rows: jax.Array):
    if index.sa_direct is not None:
        return _locate_direct_jit(index.sa_direct, rows)
    return _locate_jit(
        index.arrays, index.meta.n, index.meta.mark_period, rows
    )


@functools.partial(jax.jit, static_argnames=("n",))
def _docs_jit(arrays, n, offs):
    doc = jnp.searchsorted(arrays.doc_starts, offs, side="right").astype(jnp.int32) - 1
    doc_off = offs - arrays.doc_starts[doc]
    return doc, doc_off


@functools.partial(jax.jit, static_argnames=("n", "num_steps"))
def _extract_jit(arrays, n, rows, num_steps):
    return S.extract_backward(arrays, rows, num_steps)


def count_ranges(
    index: FMIndex, patterns: Sequence[bytes]
) -> Tuple[np.ndarray, np.ndarray]:
    """Row ranges [first, last) for each pattern."""
    from .metrics import metrics

    metrics.count("queries/count", len(patterns))
    metrics.count("queries/backward_steps",
                  sum(len(p) for p in patterns))
    if not patterns:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex: host-driven
        return index.count_ranges(patterns)
    pats, B = pack_patterns([pattern_to_alpha(p) for p in patterns])
    first, last = _count_jit(index.arrays, index.meta.n_rows,
                             jnp.asarray(pats), row0=index.meta.row0)
    return np.asarray(first)[:B].astype(np.int64), np.asarray(last)[:B].astype(np.int64)


def count(index: FMIndex, patterns: Sequence[bytes]) -> np.ndarray:
    """Number of occurrences of each pattern across the corpus."""
    first, last = count_ranges(index, patterns)
    return last - first


def locate_range(
    index: FMIndex, first: int, last: int, max_matches: Optional[int] = None
) -> np.ndarray:
    """Text offsets for all rows in [first, last), ascending by row."""
    from .metrics import metrics

    m = int(last - first)
    if max_matches is not None:
        m = min(m, max_matches)
    metrics.count("queries/locate_rows", max(m, 0))
    if m <= 0:
        return np.zeros(0, dtype=np.int64)
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex
        return index.locate_range(first, first + m)
    Bp = _bucket(m)
    rows = np.full(Bp, 0, dtype=np.int32)
    rows[:m] = np.arange(first, first + m, dtype=np.int32)
    offs = _locate_rows_dispatch(index, jnp.asarray(rows))
    return np.asarray(offs)[:m].astype(np.int64)


def offsets_to_docs(
    index: FMIndex, offs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Map global text offsets to (doc_id, offset_in_doc).

    Offsets are content-relative; matches inside a document's header
    section come back negative (header bytes precede content)."""
    if offs.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    doc = np.searchsorted(index.doc_starts_np, offs, side="right") - 1
    doc_off = offs - index.doc_starts_np[doc]
    if index.header_lens_np is not None:
        doc_off = doc_off - index.header_lens_np[doc]
    return doc.astype(np.int64), doc_off.astype(np.int64)


def range_docs(index: FMIndex, first: int, last: int) -> np.ndarray:
    """Unique doc ids for rows [first, last), using chunk doc-lists for
    whole segments when the index carries them (range_to_results_query
    whole-chunk path, server.c:4549) and per-row locate for the edges."""
    if index.chunk_docs_np is None:
        offs = locate_range(index, first, last)
        doc, _ = offsets_to_docs(index, offs)
        return np.unique(doc)
    seg = index.meta.seg
    s0 = -(-first // seg)   # first whole segment
    s1 = last // seg        # end of whole segments
    parts = []
    if s1 > s0:
        o = index.chunk_doc_offsets_np
        parts.append(index.chunk_docs_np[o[s0]:o[s1]].astype(np.int64))
        edges = [(first, min(s0 * seg, last)), (max(s1 * seg, first), last)]
    else:
        edges = [(first, last)]
    for f, l in edges:
        if l > f:
            offs = locate_range(index, f, l)
            d, _ = offsets_to_docs(index, offs)
            parts.append(d)
    if not parts:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(parts))


def locate(
    index: FMIndex, pattern: bytes, max_matches: Optional[int] = None
) -> List[Tuple[int, int]]:
    """All (doc_id, offset) matches of pattern, sorted."""
    first, last = count_ranges(index, [pattern])
    offs = locate_range(index, int(first[0]), int(last[0]), max_matches)
    doc, doc_off = offsets_to_docs(index, offs)
    return sorted(zip(doc.tolist(), doc_off.tolist()))


def extract_document(index: FMIndex, doc_id: int) -> bytes:
    """Reconstruct document bytes purely from the index (self-indexing),
    via a backward LF walk from the document's SEOF row — the analog of
    extract_document_query (server.h:399-406)."""
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex
        return index.extract_document(doc_id)
    dlen = int(index.doc_starts_np[doc_id + 1] - index.doc_starts_np[doc_id]) - 1
    if index.header_lens_np is not None:
        dlen -= int(index.header_lens_np[doc_id])
    if dlen == 0:
        return b""
    row = int(np.asarray(index.arrays.doc_seof_rows)[doc_id])
    rows = jnp.asarray(np.array([row], dtype=np.int32))
    chars, _ = _extract_jit(index.arrays, index.meta.n, rows, dlen)
    seq = np.asarray(chars)[0][::-1]  # reverse: walk was backwards
    return (seq - CHARACTER_OFFSET).astype(np.uint8).tobytes()


def extract_all_documents(index: FMIndex) -> List[bytes]:
    """Reconstruct every document from the index in one batched LF walk
    (rows = all doc SEOF rows, steps = longest document)."""
    starts = index.doc_starts_np
    lens = (np.diff(starts) - 1).astype(np.int64)
    if index.header_lens_np is not None:
        lens = lens - index.header_lens_np
    ndocs = len(lens)
    if ndocs == 0:
        return []
    maxlen = int(lens.max())
    if maxlen == 0:
        return [b""] * ndocs
    Bp = _bucket(ndocs)
    rows = np.zeros(Bp, dtype=np.int32)
    # shape-bucketed builds (pad_shape) carry degenerate trailing doc
    # slots in the device arrays; only the real docs are extracted
    rows[:ndocs] = np.asarray(index.arrays.doc_seof_rows)[:ndocs]
    chars, _ = _extract_jit(index.arrays, index.meta.n, jnp.asarray(rows),
                            maxlen)
    chars = np.asarray(chars)[:ndocs]
    out = []
    for d in range(ndocs):
        L = int(lens[d])
        seq = chars[d][:L][::-1]
        out.append((seq - CHARACTER_OFFSET).astype(np.uint8).tobytes())
    return out


@functools.partial(jax.jit, static_argnames=("n", "num_steps"))
def _psi_scan_jit(arrays, n, rows, num_steps):
    """Forward psi-walk collecting first-symbol chars: int32[B, steps]."""

    def step(rr, _):
        nxt, c = S.psi_step(arrays, n, rr)
        return nxt, c

    _, chars = jax.lax.scan(step, rows, None, length=num_steps)
    return chars.T


def locate_rows_array(index: FMIndex, rows: np.ndarray) -> np.ndarray:
    """Text offsets for an arbitrary batch of rows (one device call)."""
    m = len(rows)
    if m == 0:
        return np.zeros(0, np.int64)
    from .metrics import metrics

    metrics.count("queries/locate_rows", m)
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex
        return index.locate_rows_array(np.asarray(rows))
    Bp = _bucket(m)
    rr = np.zeros(Bp, dtype=np.int32)
    rr[:m] = rows
    offs = _locate_rows_dispatch(index, jnp.asarray(rr))
    return np.asarray(offs)[:m].astype(np.int64)


def extract_context_batch(
    index: FMIndex, rows, before: int, pattern_len: int, after: int
) -> List[bytes]:
    """Batched context extraction: for each match row, `before` chars of
    left context + the match + `after` chars of right context
    (context_query, server.c:2627), in TWO device dispatches for the whole
    batch (one backward LF scan, one forward psi scan) instead of one
    dispatch per character per row.  Stops at document boundaries."""
    n = index.meta.n
    B = len(rows)
    if B == 0:
        return []
    Bp = _bucket(B)
    rows_np = np.zeros(Bp, dtype=np.int32)
    rows_np[:B] = rows
    rows_dev = jnp.asarray(rows_np)
    fwd_steps = pattern_len + after
    if fwd_steps > 0:
        chars_fwd = np.asarray(
            _psi_scan_jit(index.arrays, n, rows_dev, fwd_steps)
        )[:B]
    else:
        chars_fwd = np.zeros((B, 0), np.int64)
    if before > 0:
        chars_back, _ = _extract_jit(
            index.arrays, n, rows_dev, _bucket(before)
        )
        chars_back = np.asarray(chars_back)[:B, :before]
    else:
        chars_back = np.zeros((B, 0), np.int64)
    out = []
    for i in range(B):
        left = chars_back[i][::-1]
        nonchar = left < CHARACTER_OFFSET
        if nonchar.any():
            left = left[int(np.nonzero(nonchar)[0].max()) + 1:]
        fwd = chars_fwd[i]
        stops = np.nonzero(fwd < CHARACTER_OFFSET)[0]
        if len(stops):
            fwd = fwd[: stops[0]]
        seq = np.concatenate([left.astype(np.int64), fwd.astype(np.int64)])
        out.append((seq - CHARACTER_OFFSET).astype(np.uint8).tobytes())
    return out


def extract_context(
    index: FMIndex, row: int, before: int, pattern_len: int, after: int
) -> bytes:
    """Single-row wrapper over extract_context_batch."""
    return extract_context_batch(index, [row], before, pattern_len, after)[0]
