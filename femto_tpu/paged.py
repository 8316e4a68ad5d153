"""Larger-than-device-memory serving: host/disk rows + a device row cache.

The reference's identity is *external memory*: it served a 182 GB corpus
from one machine's disks through mmap'd index blocks and two-level LRU
caches (/root/reference/src/main/index.c:1222 b_fault bucket cache,
server.c:3383,3656 block cache; doc/femto.pdf §4.1).  femto_tpu's
resident tiers stop at ~device-memory/0.9 B/char of text; this module is
the device analog of the bucket cache for anything bigger:

  * the ROW-TIER store (`bwt` — codes + symbol list + marks + relative
    checkpoints per row, ~90% of a vseg/vrle index's bytes) stays on the
    HOST (np.memmap over the flat .ftpu file, so it can also exceed host
    RAM and page from disk);
  * a fixed-budget DEVICE CACHE `uint32[cache_rows, W]` holds recently
    served segments; `FMArrays.seg_slot` (int32[n_seg], slot 0 = dummy)
    maps true segment ids to cache slots, and every serving kernel's row
    gather routes through it (ops/rank._bwt_row);
  * queries run as HOST-DRIVEN steps (one device dispatch per pattern
    character / LF step): before each dispatch the driver pulls the
    lanes' row ids (the whole batch's segment demand — the analog of the
    reference's row-sorted RB sweep, one bucket load serving many
    requests), faults the missing segments with ONE host->device copy,
    then dispatches the full batch.  FIFO-clock eviction.

Small arrays (C, occ_l1, alpha maps, mark_vals, seg_nsym/seg_woff,
seg_ovf, seg_cont, doc arrays) stay device-resident — together they are a
few percent of the index.  Only the row tiers (vseg/vrle) are pageable:
their one-row layout means ONE indirection pages codes, marks, and
checkpoints at once.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .alphabet import pattern_to_alpha
from .fmindex import FMArrays, FMIndex, FMMeta


# arrays of a flat index that never go to the device: the row store
# (paged through the cache) and the host-side document tables
HOST_RESIDENT = ("bwt", "doc_starts_np", "header_lens_np",
                 "chunk_doc_offsets_np", "chunk_docs_np", "sa_direct")


def _bucket(x: int, minimum: int = 64) -> int:
    b = minimum
    while b < x:
        b *= 2
    return b


@jax.jit
def _apply_faults(cache, slot_map, slots, rows, evict_segs, segs):
    """One fused cache update: write fetched rows into their slots, clear
    the evicted segments' map entries, then map the new segments.  Pad
    entries use out-of-range indices and drop."""
    cache = cache.at[slots].set(rows, mode="drop")
    slot_map = slot_map.at[evict_segs].set(0, mode="drop")
    slot_map = slot_map.at[segs].set(slots, mode="drop")
    return cache, slot_map


@jax.jit
def _pair_step(arrays, c, first, last):
    from .ops.rank import backward_step_pair

    active = c >= 0
    nf, nl = backward_step_pair(arrays, c, first, last)
    return (jnp.where(active, nf, first), jnp.where(active, nl, last))


@jax.jit
def _walk_step(arrays, rows, granks, steps, done, i):
    from .ops.rank import lf_grank_step

    nxt, bit, grank = lf_grank_step(arrays, rows)
    is_m = bit & (~done)
    granks = jnp.where(is_m, grank, granks)
    steps = jnp.where(is_m, i, steps)
    done = done | is_m
    rows = jnp.where(done, rows, nxt)
    return rows, granks, steps, done


@jax.jit
def _resolve_marks(arrays, granks, steps):
    from .ops.rank import mark_offset

    return mark_offset(arrays, granks) + steps


@jax.jit
def _extract_step(arrays, rows):
    from .ops.rank import bwt_at, lf_step

    return lf_step(arrays, rows), bwt_at(arrays, rows)


class PagedIndex:
    """Serve a row-tier index larger than the device-memory budget.

    Duck-types the FMIndex surface the query layer needs (count_ranges /
    locate via .paged drivers); `stats` records faults and bytes moved.
    """

    def __init__(self, meta: FMMeta, infos: List[bytes], arrs: dict,
                 budget_bytes: int,
                 doc_starts_np: Optional[np.ndarray] = None,
                 header_lens_np: Optional[np.ndarray] = None):
        if "seg_nsym" not in arrs:
            raise ValueError(
                "paged serving supports the row tiers (vseg/vrle); "
                "rebuild with tier='vrle' (the big-corpus tier)")
        self.meta = meta
        self.infos = infos
        self.bwt_np = arrs["bwt"]                    # host / memmap
        n_seg, W = self.bwt_np.shape
        row_bytes = W * 4
        resident = {}
        resident_bytes = 0
        for k, v in arrs.items():
            if k in HOST_RESIDENT:
                continue
            resident[k] = jnp.asarray(v)
            resident_bytes += resident[k].nbytes
        map_bytes = n_seg * 4
        # the budget is best-effort: resident arrays + a minimum useful
        # cache (256 rows) are always allocated, else no batch could run
        cache_rows = max(
            256, (budget_bytes - resident_bytes - map_bytes) // row_bytes)
        cache_rows = min(cache_rows, n_seg + 1)
        self.cache_rows = int(cache_rows)
        self._cache = jnp.zeros((self.cache_rows, W), jnp.uint32)
        self._slot_map = jnp.zeros((n_seg,), jnp.int32)
        self._slot_map_np = np.zeros(n_seg, np.int32)
        self._slot_seg = np.zeros(self.cache_rows, np.int64)  # slot -> seg+1
        self._clock = 1
        self.arrays = FMArrays(
            bwt=self._cache, seg_slot=self._slot_map, **resident)
        self.doc_starts_np = (
            np.asarray(doc_starts_np) if doc_starts_np is not None
            else np.asarray(arrs["doc_starts_np"]))
        self.header_lens_np = header_lens_np
        if header_lens_np is None and "header_lens_np" in arrs:
            self.header_lens_np = np.asarray(arrs["header_lens_np"])
        # the host-side engine surface (query/engine works against a
        # PagedIndex through the search.py dispatch points)
        self.chunk_doc_offsets_np = (
            np.asarray(arrs["chunk_doc_offsets_np"])
            if "chunk_doc_offsets_np" in arrs else None)
        self.chunk_docs_np = (np.asarray(arrs["chunk_docs_np"])
                              if "chunk_docs_np" in arrs else None)
        self.sa_direct = None
        self.stats = {"faults": 0, "hits": 0, "fetched_bytes": 0,
                      "dispatches": 0}

    # ---- cache management ----

    def _ensure(self, segs: np.ndarray) -> None:
        """Fault in every segment of `segs` (true ids, any shape)."""
        segs = np.unique(segs)
        segs = segs[(segs >= 0) & (segs < self.bwt_np.shape[0])]
        miss = segs[self._slot_map_np[segs] == 0]
        self.stats["hits"] += len(segs) - len(miss)
        if len(miss) == 0:
            return
        if len(segs) > self.cache_rows - 1:
            raise ValueError(
                f"batch touches {len(segs)} segments but the cache holds "
                f"{self.cache_rows - 1}; raise the budget or lower the "
                f"batch size")
        # FIFO clock allocation over slots [1, cache_rows), skipping slots
        # whose tenant is part of THIS dispatch's demand (evicting a hit
        # segment mid-step would feed the dispatch a dummy row)
        protected = np.zeros(self.bwt_np.shape[0] + 1, bool)
        protected[segs] = True
        slots = np.empty(len(miss), np.int64)
        for i in range(len(miss)):
            while True:
                s = self._clock
                self._clock = self._clock + 1
                if self._clock >= self.cache_rows:
                    self._clock = 1
                tenant = self._slot_seg[s] - 1
                if tenant < 0 or not protected[tenant]:
                    break
            slots[i] = s
        evict = self._slot_seg[slots]          # seg+1 of previous tenants
        evict_segs = evict[evict > 0] - 1
        # host bookkeeping
        self._slot_map_np[evict_segs] = 0
        self._slot_map_np[miss] = slots
        self._slot_seg[slots] = miss + 1
        # one host->device copy per fault batch (bucketed shapes so only
        # a few scatter programs ever compile)
        cap = _bucket(len(miss))
        segs_p = np.full(cap, self.bwt_np.shape[0], np.int64)
        segs_p[:len(miss)] = miss
        slots_p = np.full(cap, self.cache_rows, np.int64)
        slots_p[:len(miss)] = slots
        evict_p = np.full(cap, self.bwt_np.shape[0], np.int64)
        evict_p[:len(evict_segs)] = evict_segs
        rows = np.zeros((cap, self.bwt_np.shape[1]), np.uint32)
        rows[:len(miss)] = self.bwt_np[miss]
        self._cache, self._slot_map = _apply_faults(
            self._cache, self._slot_map,
            jnp.asarray(slots_p.astype(np.int32)),
            jnp.asarray(rows),
            jnp.asarray(evict_p.astype(np.int32)),
            jnp.asarray(segs_p.astype(np.int32)))
        self.arrays = self.arrays._replace(
            bwt=self._cache, seg_slot=self._slot_map)
        self.stats["faults"] += len(miss)
        self.stats["fetched_bytes"] += int(rows[:len(miss)].nbytes)

    def _segs_of_rows(self, rows: np.ndarray) -> np.ndarray:
        seg = self.meta.seg
        n_seg = self.bwt_np.shape[0]
        return np.minimum(rows // seg, n_seg - 1)

    def _ensure_rows(self, rows: np.ndarray) -> None:
        """Fault in the segments the given rows touch (the pre-dispatch
        hook the host regexp engine calls, query/regexp._backward_step)."""
        self._ensure(self._segs_of_rows(np.asarray(rows, np.int64)))

    # ---- queries (host-driven steps) ----

    def _batch_cap(self) -> int:
        """Rows per sub-batch so one dispatch's worst-case segment demand
        (one segment per lane-bound) always fits the cache."""
        return max(16, (self.cache_rows - 1) // 2)

    def count_ranges(self, patterns: Sequence[bytes]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched count: one device dispatch per pattern character, with
        the segment demand faulted in before each dispatch.  Batches
        bigger than the cache capacity split into sub-batches."""
        from .search import pack_patterns

        if not patterns:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cap = self._batch_cap()
        if len(patterns) > cap:
            outs = [self.count_ranges(patterns[i:i + cap])
                    for i in range(0, len(patterns), cap)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))
        pats, B = pack_patterns([pattern_to_alpha(p) for p in patterns])
        Bp, P = pats.shape
        n_rows = self.meta.n_rows
        first = jnp.full((Bp,), self.meta.row0, jnp.int32)
        last = jnp.full((Bp,), n_rows, jnp.int32)
        first_np = np.asarray(first)
        last_np = np.asarray(last)
        for t in range(P - 1, -1, -1):
            col = pats[:, t]
            if (col < 0).all():
                continue
            self._ensure(np.concatenate([
                self._segs_of_rows(first_np), self._segs_of_rows(last_np)]))
            first, last = _pair_step(
                self.arrays, jnp.asarray(col), first, last)
            self.stats["dispatches"] += 1
            first_np = np.asarray(first)
            last_np = np.asarray(last)
        return first_np[:B].astype(np.int64), last_np[:B].astype(np.int64)

    def count(self, patterns: Sequence[bytes]) -> np.ndarray:
        f, l = self.count_ranges(patterns)
        return l - f

    def locate_range(self, first: int, last: int,
                     max_matches: Optional[int] = None) -> np.ndarray:
        m = int(last - first)
        if max_matches is not None:
            m = min(m, max_matches)
        if m <= 0:
            return np.zeros(0, np.int64)
        return self.locate_rows_array(
            np.arange(first, first + m, dtype=np.int32))

    def locate_rows_array(self, rows: np.ndarray) -> np.ndarray:
        """Mark-walk locate, host-driven: fault + dispatch per LF step.
        Batches bigger than the cache capacity split into sub-batches."""
        m = len(rows)
        if m == 0:
            return np.zeros(0, np.int64)
        cap = self._batch_cap()
        if m > cap:
            return np.concatenate([
                self.locate_rows_array(rows[i:i + cap])
                for i in range(0, m, cap)])
        Bp = _bucket(m)
        rr = np.zeros(Bp, np.int32)
        rr[:m] = rows
        rows_d = jnp.asarray(rr)
        granks = jnp.zeros((Bp,), jnp.int32)
        steps = jnp.zeros((Bp,), jnp.int32)
        done = jnp.zeros((Bp,), bool)
        rows_np = rr
        done_np = np.zeros(Bp, bool)
        i = 0
        while i <= self.meta.mark_period and not done_np.all():
            self._ensure(self._segs_of_rows(rows_np[~done_np]))
            rows_d, granks, steps, done = _walk_step(
                self.arrays, rows_d, granks, steps, done, jnp.int32(i))
            self.stats["dispatches"] += 1
            rows_np = np.asarray(rows_d)
            done_np = np.asarray(done)
            i += 1
        offs = np.asarray(_resolve_marks(self.arrays, granks, steps))
        return offs[:m].astype(np.int64)

    def locate(self, pattern: bytes,
               max_matches: Optional[int] = None
               ) -> List[Tuple[int, int]]:
        from .search import offsets_to_docs

        f, l = self.count_ranges([pattern])
        offs = self.locate_range(int(f[0]), int(l[0]), max_matches)
        doc, doc_off = offsets_to_docs(self, offs)
        return sorted(zip(doc.tolist(), doc_off.tolist()))

    def extract_document(self, doc_id: int) -> bytes:
        """Self-indexing extraction, host-driven: one faulted LF step per
        character (search.extract_document semantics)."""
        from .alphabet import CHARACTER_OFFSET

        dlen = int(self.doc_starts_np[doc_id + 1]
                   - self.doc_starts_np[doc_id]) - 1
        if self.header_lens_np is not None:
            dlen -= int(self.header_lens_np[doc_id])
        if dlen <= 0:
            return b""
        row = int(np.asarray(self.arrays.doc_seof_rows)[doc_id])
        rows_d = jnp.asarray(np.array([row], np.int32))
        out = []
        rows_np = np.array([row], np.int64)
        for _ in range(dlen):
            self._ensure(self._segs_of_rows(rows_np))
            rows_d, c = _extract_step(self.arrays, rows_d)
            self.stats["dispatches"] += 1
            out.append(int(c[0]))
            rows_np = np.asarray(rows_d).astype(np.int64)
        seq = np.asarray(out[::-1], np.int64)
        return (seq - CHARACTER_OFFSET).astype(np.uint8).tobytes()


def load_paged(path: str, budget_bytes: Optional[int] = None) -> PagedIndex:
    """Open a flat .ftpu row-tier index for paged serving: rows stay on
    disk (np.memmap), the device holds `budget_bytes` of cache + the
    small resident arrays.  Budget defaults to FEMTO_TPU_HBM_BUDGET."""
    if budget_bytes is None:
        budget_bytes = int(os.environ.get(
            "FEMTO_TPU_HBM_BUDGET", str(1 << 30)))
    meta, infos, arrs = FMIndex.parse_flat(path)
    return PagedIndex(meta, infos, arrs, budget_bytes)


def load_auto(path: str, budget_bytes: Optional[int] = None):
    """FMIndex.load, unless the index exceeds the (optional) device
    budget — then a PagedIndex.  The budget comes from the argument or
    FEMTO_TPU_HBM_BUDGET; with neither set, always resident."""
    if budget_bytes is None:
        env = os.environ.get("FEMTO_TPU_HBM_BUDGET")
        budget_bytes = int(env) if env else None
    if budget_bytes is not None and os.path.isfile(path):
        meta, infos, arrs = FMIndex.parse_flat(path)
        total = sum(v.nbytes for v in arrs.values())
        if total > budget_bytes and "seg_nsym" in arrs:
            return PagedIndex(meta, infos, arrs, budget_bytes)
    return FMIndex.load(path)
