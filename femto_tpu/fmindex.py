"""Accelerator-native FM-index: flat, bit-packed, fixed-shape tensors.

Replaces the reference's byte-serialized block/bucket/wavelet-tree format
(/root/reference/src/main/block_format.txt, index.h:103-134) with an
array-native layout built for vectorized rank queries:

  * the BWT is stored as dense uint16 codes, reshaped into
    [n_seg, SEG] segments (SEG rows ≈ the reference's 128-byte bseq
    segments, wtree_funcs.h:34);
  * occurrence counts use the same 3-level prefix decomposition as the
    reference (C array + per-block occs + in-bucket rank,
    block_format.txt:45-49) collapsed to 2 levels: a global C array and a
    per-segment absolute checkpoint `occ_ckpt[s, c]` = #occurrences of c in
    BWT[0 : s*SEG).  rank(c, r) = occ_ckpt[r//SEG, c] + scan of one segment
    — the scan is a SEG-wide vector compare+sum instead of a serial
    gamma-coded bitvector walk (wtree.c:635);
  * mark sampling (sampled suffix array, index_types.h:134-144) is a packed
    bitmap over rows + per-segment mark-rank checkpoints + a dense value
    array, replacing per-bucket mark bitvectors and mark arrays
    (block_format.txt:105-151).

Everything is a static-shape device array, so queries jit/shard cleanly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .alphabet import (
    ALPHA_SIZE,
    CHARACTER_OFFSET,
    EOH,
    INVALID_ALPHA,
    PreparedText,
    SEOF,
    SOH,
    mark_positions_np,
)

# Rows per segment (the rank-scan granularity).  256 keeps the in-segment
# scan cheap while the checkpoint overhead is ALPHA*4/SEG ≈ 4 bytes/row.
DEFAULT_SEG = 256
DEFAULT_MARK_PERIOD = 20
L1_GROUP = 16  # segments per L1 checkpoint group (compact tier)


def l1_group_for(seg: int) -> int:
    """L1 group size for a segment length: the uint16 relative
    checkpoints must stay below 65536 within one group, so large
    segments halve the group (seg=4096 -> 8; derived on the serving
    side purely from array shapes, rank._l1_grp)."""
    g = L1_GROUP
    while g > 1 and seg * g > 0xFFFF:
        g //= 2
    if seg * g > 0xFFFF:
        raise ValueError("segment too large for uint16 checkpoints")
    return g


# Host->device text uploads are a chunked build's serial IO, so the text
# never ships as int32:
#   * uint8 bulk + on-device escape fixup (4x smaller): the prepared-text
#     layout ([SOH hdr EOH]? content SEOF per doc, alphabet.py) puts every
#     escape symbol at a position derivable from doc_starts/header_lens,
#     and (text - CHARACTER_OFFSET) mod 256 is exactly the content byte
#     elsewhere — verified host-side per build, falling back to
#   * uint16 bulk (2x smaller), widened on device.
_widen_i32 = jax.jit(lambda t: t.astype(jnp.int32))


@jax.jit
def _expand_u8(u8, n_real, seof_pos, soh_pos, eoh_pos):
    """Reconstruct int32 alphabet codes from raw content bytes + the escape
    positions derived host-side by _escape_positions (pad slots in the
    position arrays are -1, dropped by the scatter)."""
    t = u8.astype(jnp.int32) + CHARACTER_OFFSET
    pos = jnp.arange(u8.shape[0], dtype=jnp.int32)
    t = jnp.where(pos < n_real, t, 0)  # pad tail = ESCAPE(0)
    t = t.at[seof_pos].set(SEOF, mode="drop")
    t = t.at[soh_pos].set(SOH, mode="drop")
    t = t.at[eoh_pos].set(EOH, mode="drop")
    return t


def _escape_positions(prepared, ndocs_build: int):
    """(seof_pos, soh_pos, eoh_pos) int32 arrays padded to ndocs_build with
    INT32_MAX (out-of-bounds, dropped by the device scatter — negative pads
    would WRAP), or None if the text contains escape symbols NOT derivable
    from the doc layout (manually built PreparedText)."""
    starts = prepared.doc_starts
    ndocs = prepared.num_docs
    seof = (starts[1:] - 1).astype(np.int64)
    n_hdr = 0
    soh = eoh = None
    if prepared.header_lens is not None:
        h = prepared.header_lens
        hd = np.flatnonzero(h > 0)
        n_hdr = len(hd)
        soh = starts[hd]
        eoh = starts[hd] + h[hd] - 1
    text = prepared.text
    if not (
        np.all(text[seof] == SEOF)
        and (n_hdr == 0 or (np.all(text[soh] == SOH)
                            and np.all(text[eoh] == EOH)))
        and int(np.count_nonzero(text < CHARACTER_OFFSET))
        == ndocs + 2 * n_hdr
    ):
        return None

    def pad(a):
        out = np.full(ndocs_build, np.iinfo(np.int32).max, np.int32)
        if a is not None:
            out[: len(a)] = a.astype(np.int32)
        return out

    return pad(seof), pad(soh), pad(eoh)


class FMArrays(NamedTuple):
    """Device-array portion of the index (a pytree leaf bundle).

    Three storage tiers are supported (dispatched statically on dtypes and
    shapes; see ops/rank.py):
      * full:    bwt uint16 dense symbols; occ_ckpt int32 absolute counts;
        occ_l1 a [1, ALPHA] dummy (default — fastest queries);
      * compact: occ_ckpt uint16 RELATIVE to the enclosing group's occ_l1
        int32 row (L1_GROUP segments per group) — 28% smaller index for one
        extra (pipelined) gather stream per rank;
      * packed:  per-index DENSE alphabet (alpha_map/alpha_rev; K = #used
        symbols) with the BWT bit-packed into uint32 words (32//bits codes
        per word, bits = code width for K) on top of the compact
        checkpoints — ~2 B/char on English text, ~0.8 on DNA;
      * vseg:    the compressed SERVING tier — behavioral replacement for
        the reference's Huffman wavelet tree + RLE bseq compression
        (wtree.c:359-770, block_format.txt:161-188, 0.47 B/input-byte on
        English, ChangeLog 1.1.0).  `bwt` = uint32[n_seg, total] rows,
        one per segment: [codes at ONE size-optimal width, LOCAL to the
        segment's sorted symbol list | the packed symbol list | the mark
        bitmap words | the mark-rank checkpoint | the uint16-relative
        occ checkpoint row] — ONE gathered row serves a whole rank and a
        whole locate-walk step (gather cost is per issued row, so one
        co-located row replaces several gather streams).  Segments
        whose alphabet exceeds the chosen width live in the seg_ovf side
        table (8-9 bit global codes; seg_woff holds their 1-based side
        row); occ_ckpt/mark_bits/mark_ckpt become 1-row dtype/shape
        markers.  Dispatch: seg_nsym is not None.
      * vrle:    the vseg row shape with a RUN-LENGTH coded code area
        (round 4; BWT runs average 3.5-4.2 symbols on real text).  Per
        segment the area holds u8 RLE slots (local_sym << lenbits | len,
        lenbits from the segment's own alphabet; seg_woff == -1), RLE
        plus ONE continuation row in seg_cont (seg_woff == -(1+row)),
        fixed w_main-bit codes (seg_woff == 0), or the side table.
        0.90 B/char on real English prose, 0.54 on DNA, at mark period
        20 including locate support.  Dispatch: seg_rle is not None
        (shape [1, w_main]).
    """

    bwt: jax.Array        # uint16[n_seg, SEG] symbols | uint32[n_seg, W]
    #                       packed words | uint32[total_words] vseg stream
    occ_ckpt: jax.Array   # int32 absolute | uint16 relative [n_seg, K]
    occ_l1: jax.Array     # int32[n_seg/L1_GROUP, K] | dummy [1, K]
    C: jax.Array          # int32[K+1]; C[c] = #codes < c (K=ALPHA_SIZE or
    #                       the dense alphabet size)
    mark_bits: jax.Array  # uint32[n_seg, SEG//32]; marked-row bitmap
    mark_ckpt: jax.Array  # int32[n_seg]; marked rows before segment
    mark_vals: jax.Array  # uint32[n_words + exc_cap]: bit-packed grid
    #                       mark values (k = offset // period at
    #                       mark_meta[0] bits per slot) + int32 exception
    #                       region (doc starts/SEOFs); legacy indexes:
    #                       int32[n_marks_pad] raw offsets (mark_meta None)
    doc_starts: jax.Array  # int32[ndocs+1]
    doc_seof_rows: jax.Array  # int32[ndocs]; row whose suffix starts at the
    #                           doc's SEOF (used by extract: walk LF backward)
    alpha_map: jax.Array  # int32[ALPHA_SIZE]: symbol -> dense code | -1
    alpha_rev: jax.Array  # int32[K]: dense code -> symbol (identity when
    #                       the index is not remapped)
    # vseg tier only (None elsewhere):
    seg_ovf: Optional[jax.Array] = None   # uint32[n_ovf+1, W_side]
    #                                       overflow segments at 8-9 bits,
    #                                       GLOBAL codes; row 0 dummy
    seg_nsym: Optional[jax.Array] = None  # uint8[n_seg] K_s (255 =
    #                                       identity/overflow sentinel)
    seg_woff: Optional[jax.Array] = None  # int32[n_seg]: 1-based side row
    #                                       in seg_ovf, 0 = main
    seg_syms: Optional[jax.Array] = None  # uint8|uint16[n_seg, SMAX]
    #                                       sorted dense codes present
    # packed mark-value geometry (ops/build_ops.mark_pack_geom):
    # [bits, exc_base, period, exc_off(words), cap]; None = legacy raw
    # int32 mark_vals
    mark_meta: Optional[jax.Array] = None
    # vrle tier marker (rank.is_vrle): int32[1, w_main] dummy — presence
    # means the row's code area is per-segment RLE slots (seg_woff <= -1)
    # or fixed w_main-bit codes (seg_woff == 0); shape carries the static
    # W-mode width
    seg_rle: Optional[jax.Array] = None
    # vrle continuation table: uint32[n_cont + 1, Cw] (row 0 dummy) — RLE
    # segments whose slots exceed the main code area continue in one of
    # these rows (seg_woff == -(1 + cont_row)); lets the main area sit at
    # the slot-count MEDIAN instead of ~P95
    seg_cont: Optional[jax.Array] = None
    # larger-than-HBM paged serving (paged.PagedIndex): when set, `bwt`
    # is a DEVICE ROW CACHE and seg_slot[s] maps true segment ids to
    # cache slots (slot 0 = dummy/uncached; the paged driver guarantees
    # every segment a dispatch touches is mapped first).  The device
    # analog of the reference's bucket/block LRU caches over mmap'd blocks
    # (index.c:1222, server.c:3383; femto.pdf §4.1 — 182 GB served from
    # one machine's disks).  None = fully device-resident (no indirection).
    seg_slot: Optional[jax.Array] = None


@dataclasses.dataclass(frozen=True)
class FMMeta:
    """Static (hashable) metadata; passed as jit-static argument."""

    n: int            # real text length (symbols)
    seg: int          # rows per segment
    mark_period: int
    num_docs: int
    n_marks: int
    n_seg: int = 0    # segments (>= n//seg + 1; padded for mesh sharding)
    alpha_used: int = 0  # dense alphabet size K (0 = identity alphabet)
    # Sharded device builds keep the text's mesh padding as extra leading
    # rows (pad suffixes are all-0 strings, which sort first and can never
    # match a pattern): the searchable row space is [row0, n_rows).
    n_rows: int = 0   # total rows (n, or n_pad for sharded builds)
    row0: int = 0     # first real row (= n_rows - n)

    def __post_init__(self):
        if self.n_seg == 0:
            object.__setattr__(self, "n_seg", self.n // self.seg + 1)
        if self.n_rows == 0:
            object.__setattr__(self, "n_rows", self.n)


@dataclasses.dataclass
class FMIndex:
    """Full index: device arrays + static meta + host-side metadata."""

    arrays: FMArrays
    meta: FMMeta
    doc_starts_np: np.ndarray  # int64[ndocs+1] host copy (region bounds)
    infos: List[bytes]
    header_lens_np: Optional[np.ndarray] = None  # int64[ndocs] or None
    # Optional chunk doc-lists (block_format.txt:105-151 chunk doc lists /
    # block_chunk_request index.c:2196): per segment, the sorted unique doc
    # ids of its rows — lets docs-only queries skip per-row locate for
    # whole segments.  Host-side ragged arrays.
    chunk_doc_offsets_np: Optional[np.ndarray] = None  # int64[n_seg+1]
    chunk_docs_np: Optional[np.ndarray] = None         # int32[total]
    # Optional direct-locate tier: the full suffix array, device-resident
    # (int32[n]).  locate(row) = one gather instead of a ~mark_period-step
    # LF walk (+4 B/char).  The reference cannot afford this (its SA
    # sample lives on disk, mark arrays block_format.txt:105-151); in
    # device memory the memory/speed trade lands differently, so it ships
    # as a tier (build_index(locate="direct")).
    sa_direct: Optional[Any] = None  # int32[n] device array

    @property
    def n(self) -> int:
        return self.meta.n

    @property
    def num_docs(self) -> int:
        return self.meta.num_docs

    # ---- persistence (the analog of flatten_index, index.c:2260) ----

    def save(self, path: str) -> None:
        """Write the index as one directory: meta.json + arrays.npz."""
        os.makedirs(path, exist_ok=True)
        meta = dataclasses.asdict(self.meta)
        meta["infos"] = [i.decode("utf-8", "surrogateescape") for i in self.infos]
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        arrs = {k: np.asarray(v) for k, v in self.arrays._asdict().items()
                if v is not None}
        arrs["doc_starts_np"] = self.doc_starts_np
        if self.header_lens_np is not None:
            arrs["header_lens_np"] = self.header_lens_np
        if self.chunk_docs_np is not None:
            arrs["chunk_doc_offsets_np"] = self.chunk_doc_offsets_np
            arrs["chunk_docs_np"] = self.chunk_docs_np
        if self.sa_direct is not None:
            arrs["sa_direct"] = np.asarray(self.sa_direct)
        np.savez(os.path.join(path, "arrays.npz"), **arrs)

    @classmethod
    def load(cls, path: str, device: Optional[Any] = None) -> "FMIndex":
        if os.path.isfile(path):
            return cls.load_flat(path)
        with open(os.path.join(path, "meta.json")) as f:
            meta_d = json.load(f)
        infos = [s.encode("utf-8", "surrogateescape") for s in meta_d.pop("infos")]
        meta = FMMeta(**meta_d)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            doc_starts_np = z["doc_starts_np"]
            header_lens_np = (
                z["header_lens_np"] if "header_lens_np" in z.files else None
            )
            vals = {k: z[k] for k in FMArrays._fields if k in z.files}
            if "occ_l1" not in vals:  # pre-compact-tier index files
                vals["occ_l1"] = np.zeros((1, ALPHA_SIZE), np.int32)
            if "alpha_map" not in vals:  # pre-packed-tier index files
                vals["alpha_map"] = np.arange(ALPHA_SIZE, dtype=np.int32)
                vals["alpha_rev"] = np.arange(ALPHA_SIZE, dtype=np.int32)
            cdo = z["chunk_doc_offsets_np"] if "chunk_doc_offsets_np" in z.files else None
            cdv = z["chunk_docs_np"] if "chunk_docs_np" in z.files else None
            sa_direct = (jnp.asarray(z["sa_direct"])
                         if "sa_direct" in z.files else None)
            arrays = FMArrays(**{k: jnp.asarray(v) for k, v in vals.items()})
        _check_layout(arrays)
        return cls(arrays=arrays, meta=meta, doc_starts_np=doc_starts_np,
                   infos=infos, header_lens_np=header_lens_np,
                   chunk_doc_offsets_np=cdo, chunk_docs_np=cdv,
                   sa_direct=sa_direct)

    # ---- single-file flat format (the analog of flatten_index's
    #      page-aligned .femto file, index.c:2260-2366) ----

    MAGIC = b"FTPU0001"
    PAGE = 4096

    def save_flat(self, path: str, compress: bool = False) -> None:
        """Pack the whole index into one page-aligned file.

        compress=True zlib-compresses each array blob — the storage-level
        analog of the reference's RLE-gamma/Huffman bucket compression
        (wtree.c:359-770; ChangeLog 1.1.0: 0.47 B per input byte on English
        text).  The serving tier is device-resident arrays, so entropy
        coding lives at the file boundary: compressed files cannot be
        memory-mapped and are inflated on load."""
        meta = dataclasses.asdict(self.meta)
        meta["infos"] = [i.decode("utf-8", "surrogateescape") for i in self.infos]
        arrs = {k: np.ascontiguousarray(np.asarray(v))
                for k, v in self.arrays._asdict().items() if v is not None}
        arrs["doc_starts_np"] = np.ascontiguousarray(self.doc_starts_np)
        if self.header_lens_np is not None:
            arrs["header_lens_np"] = np.ascontiguousarray(self.header_lens_np)
        if self.chunk_docs_np is not None:
            arrs["chunk_doc_offsets_np"] = np.ascontiguousarray(
                self.chunk_doc_offsets_np)
            arrs["chunk_docs_np"] = np.ascontiguousarray(self.chunk_docs_np)
        if self.sa_direct is not None:
            arrs["sa_direct"] = np.ascontiguousarray(np.asarray(self.sa_direct))
        manifest = []
        # header is written last (need offsets); reserve after computing
        blobs = []
        for name, a in arrs.items():
            entry = {"name": name, "dtype": str(a.dtype),
                     "shape": list(a.shape)}
            b = a.tobytes()
            if compress:
                import zlib

                b = zlib.compress(b, level=6)
                entry["codec"] = "zlib"
                entry["csize"] = len(b)
            manifest.append(entry)
            blobs.append(b)
        # two passes: compute offsets with a conservative header size, then
        # write everything once
        probe = json.dumps({"meta": meta, "arrays": manifest}).encode()
        hdr_reserve = -(-(len(self.MAGIC) + 8 + len(probe) + 24 * len(manifest))
                        // self.PAGE) * self.PAGE
        off = hdr_reserve
        for m, b in zip(manifest, blobs):
            m["offset"] = off
            off += len(b) + ((-len(b)) % self.PAGE)
        hj = json.dumps({"meta": meta, "arrays": manifest}).encode()
        assert len(self.MAGIC) + 8 + len(hj) <= hdr_reserve
        with open(path, "wb") as f:
            f.write(self.MAGIC)
            f.write(len(hj).to_bytes(8, "little"))
            f.write(hj)
            f.write(b"\0" * (hdr_reserve - len(self.MAGIC) - 8 - len(hj)))
            for b in blobs:
                f.write(b)
                f.write(b"\0" * ((-len(b)) % self.PAGE))

    @classmethod
    def parse_flat(cls, path: str):
        """Parse a flat index file WITHOUT uploading anything: returns
        (meta, infos, arrs) where arrs maps array names to host numpy
        views (np.memmap for uncompressed blobs — the disk-resident
        entry point of the paged serving tier, paged.PagedIndex)."""
        with open(path, "rb") as f:
            magic = f.read(len(cls.MAGIC))
            if magic != cls.MAGIC:
                raise ValueError("not a FTPU flat index file")
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen))
        meta_d = header["meta"]
        infos = [s.encode("utf-8", "surrogateescape") for s in meta_d.pop("infos")]
        meta = FMMeta(**meta_d)
        arrs = {}
        for m in header["arrays"]:
            if m.get("codec") == "zlib":
                import zlib

                with open(path, "rb") as f:
                    f.seek(m["offset"])
                    raw = zlib.decompress(f.read(m["csize"]))
                arrs[m["name"]] = np.frombuffer(
                    raw, dtype=np.dtype(m["dtype"])
                ).reshape(tuple(m["shape"]))
            else:
                arrs[m["name"]] = np.memmap(
                    path,
                    dtype=np.dtype(m["dtype"]),
                    mode="r",
                    offset=m["offset"],
                    shape=tuple(m["shape"]),
                )
        return meta, infos, arrs

    @classmethod
    def load_flat(cls, path: str) -> "FMIndex":
        """Load a flat index file; arrays are memory-mapped then staged to
        device on first use."""
        meta, infos, arrs = cls.parse_flat(path)
        doc_starts_np = np.asarray(arrs.pop("doc_starts_np"))
        header_lens_np = None
        if "header_lens_np" in arrs:
            header_lens_np = np.asarray(arrs.pop("header_lens_np"))
        if "occ_l1" not in arrs:  # pre-compact-tier index files
            arrs["occ_l1"] = np.zeros((1, ALPHA_SIZE), np.int32)
        if "alpha_map" not in arrs:  # pre-packed-tier index files
            arrs["alpha_map"] = np.arange(ALPHA_SIZE, dtype=np.int32)
            arrs["alpha_rev"] = np.arange(ALPHA_SIZE, dtype=np.int32)
        cdo = (np.asarray(arrs.pop("chunk_doc_offsets_np"))
               if "chunk_doc_offsets_np" in arrs else None)
        cdv = (np.asarray(arrs.pop("chunk_docs_np"))
               if "chunk_docs_np" in arrs else None)
        sa_direct = (jnp.asarray(arrs.pop("sa_direct"))
                     if "sa_direct" in arrs else None)
        arrays = FMArrays(**{k: jnp.asarray(arrs[k]) for k in FMArrays._fields
                             if k in arrs})
        _check_layout(arrays)
        return cls(arrays=arrays, meta=meta, doc_starts_np=doc_starts_np,
                   infos=infos, header_lens_np=header_lens_np,
                   chunk_doc_offsets_np=cdo, chunk_docs_np=cdv,
                   sa_direct=sa_direct)


def _check_layout(arrays: "FMArrays") -> None:
    """Reject index files from obsolete array layouts with a clear error
    (the vseg tier's layout changed during round 3: seg_w removed,
    seg_ovf/one-row serving format added)."""
    if arrays.seg_nsym is not None and (
            arrays.seg_ovf is None or arrays.bwt.ndim != 2):
        raise ValueError(
            "this vseg index uses an obsolete on-disk layout; rebuild it "
            "with the current version (tier='vseg')"
        )


def _pack_bits_u32(bits: np.ndarray) -> np.ndarray:
    """bool[n] (n % 32 == 0) -> uint32[n//32], little-endian within words."""
    b = bits.astype(np.uint8).reshape(-1, 32)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    return (b.astype(np.uint64) * weights).sum(axis=1).astype(np.uint32)


def build_fm_arrays(
    text_np: np.ndarray,
    sa_np: np.ndarray,
    doc_starts: np.ndarray,
    seg: int = DEFAULT_SEG,
    mark_period: int = DEFAULT_MARK_PERIOD,
    seg_multiple: int = 1,
) -> "tuple[FMArrays, FMMeta]":
    """Assemble index arrays from a suffix array (host-side finalization).

    The heavy lifting (SA construction) runs on device; this packaging step
    is O(n) numpy and mirrors the reference's constructor_* bucket writers
    (construct.c:41-160) without the serial compression.

    seg_multiple: round the segment count up to this multiple so the
    leading (segment) dimension can be sharded evenly over a device mesh.
    """
    n = int(text_np.shape[0])
    assert seg % 32 == 0
    n_seg = n // seg + 1
    n_seg = -(-n_seg // seg_multiple) * seg_multiple
    n_pad = n_seg * seg

    text_np = np.asarray(text_np, dtype=np.uint16)
    sa_np = np.asarray(sa_np, dtype=np.int64)

    bwt = np.full(n_pad, INVALID_ALPHA, dtype=np.uint16)
    prev = np.where(sa_np == 0, n - 1, sa_np - 1)
    bwt[:n] = text_np[prev]
    bwt2d = bwt.reshape(n_seg, seg)

    # C array.
    counts = np.bincount(text_np, minlength=ALPHA_SIZE).astype(np.int64)
    C = np.zeros(ALPHA_SIZE + 1, dtype=np.int32)
    np.cumsum(counts, out=C[1:])

    # Per-segment absolute occurrence checkpoints (exclusive).
    seg_ids = np.arange(n_pad, dtype=np.int64) // seg
    flat = seg_ids[:n] * ALPHA_SIZE + text_np[prev].astype(np.int64)
    per_seg = np.bincount(flat, minlength=n_seg * ALPHA_SIZE).reshape(
        n_seg, ALPHA_SIZE
    )
    occ_ckpt = np.zeros_like(per_seg)
    np.cumsum(per_seg[:-1], axis=0, out=occ_ckpt[1:])
    occ_ckpt = occ_ckpt.astype(np.int32)

    # Mark sampling.
    marked_pos = mark_positions_np(doc_starts.astype(np.int64), mark_period)
    marked_row = np.zeros(n_pad, dtype=bool)
    marked_row[:n] = marked_pos[sa_np]
    mark_bits = _pack_bits_u32(marked_row).reshape(n_seg, seg // 32)
    per_seg_marks = marked_row.reshape(n_seg, seg).sum(axis=1)
    mark_ckpt = np.zeros(n_seg, dtype=np.int64)
    np.cumsum(per_seg_marks[:-1], out=mark_ckpt[1:])
    mark_vals_raw = sa_np[marked_row[:n]].astype(np.int64)
    n_marks = int(mark_vals_raw.shape[0])
    # bit-packed grid store, IDENTICAL geometry to the device path so the
    # host/device packaging parity tests compare arrays verbatim
    from .ops.build_ops import mark_cap, pack_mark_vals_np
    ndocs = int(doc_starts.shape[0]) - 1
    cap = mark_cap(n, ndocs, mark_period, seg)
    mark_vals, mark_meta = pack_mark_vals_np(
        mark_vals_raw, n=n, period=mark_period, ndocs=ndocs, cap=cap)

    # Row of each document's SEOF position (inverse SA at doc_end-1).
    isa = np.empty(n, dtype=np.int64)
    isa[sa_np] = np.arange(n, dtype=np.int64)
    seof_pos = doc_starts[1:].astype(np.int64) - 1
    doc_seof_rows = isa[seof_pos].astype(np.int32)

    arrays = FMArrays(
        bwt=jnp.asarray(bwt2d),
        occ_ckpt=jnp.asarray(occ_ckpt),
        occ_l1=jnp.zeros((1, ALPHA_SIZE), jnp.int32),
        C=jnp.asarray(C),
        mark_bits=jnp.asarray(mark_bits),
        mark_ckpt=jnp.asarray(mark_ckpt.astype(np.int32)),
        mark_vals=jnp.asarray(mark_vals),
        doc_starts=jnp.asarray(doc_starts.astype(np.int32)),
        doc_seof_rows=jnp.asarray(doc_seof_rows),
        alpha_map=jnp.arange(ALPHA_SIZE, dtype=jnp.int32),
        alpha_rev=jnp.arange(ALPHA_SIZE, dtype=jnp.int32),
        mark_meta=jnp.asarray(mark_meta),
    )
    meta = FMMeta(
        n=n,
        seg=seg,
        mark_period=mark_period,
        num_docs=int(doc_starts.shape[0]) - 1,
        n_marks=n_marks,
        n_seg=n_seg,
    )
    return arrays, meta


def compute_chunk_doc_lists(sa_np, doc_starts, seg: int, n_seg: int):
    """Per-segment sorted unique doc ids (the chunk doc-lists of
    block_format.txt:105-151, vectorized).  Returns (offsets int64[n_seg+1],
    docs int32[total])."""
    n = len(sa_np)
    doc_of = (
        np.searchsorted(doc_starts.astype(np.int64), sa_np, side="right") - 1
    )
    pad = n_seg * seg - n
    d2 = np.concatenate([doc_of, np.full(pad, -1, dtype=doc_of.dtype)])
    d2 = np.sort(d2.reshape(n_seg, seg), axis=1)
    uniq = np.ones_like(d2, dtype=bool)
    uniq[:, 1:] = d2[:, 1:] != d2[:, :-1]
    uniq &= d2 >= 0
    counts = uniq.sum(axis=1)
    offsets = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, d2[uniq].astype(np.int32)


def build_index(
    prepared: PreparedText,
    seg: int = DEFAULT_SEG,
    mark_period: int = DEFAULT_MARK_PERIOD,
    sa: Optional[np.ndarray] = None,
    device_build: bool = True,
    checkpoint_dir: Optional[str] = None,
    compact: bool = False,
    doc_chunks: bool = False,
    tier: Optional[str] = None,
    locate: str = "walk",
    pad_shape: Optional[Tuple[int, int]] = None,
    text_dev16: Optional[jax.Array] = None,
    text_dev32: Optional[jax.Array] = None,
) -> FMIndex:
    """End-to-end single-device index build: SA and packaging on device.

    tier: "full" (default), "compact", "packed", "vseg", or "vrle" (see
    FMArrays docstring; compact=True is the back-compat spelling of
    tier="compact").  "vseg" is the fixed-width compressed serving tier
    (per-segment dense remap at a size-optimal shared width); "vrle" adds
    per-segment RUN-LENGTH coded rows — the smallest tier on real text,
    where BWT runs average 3.5-4.2 symbols (the role of the reference's
    RLE-gamma bseq compression, wtree.c:359-770).

    locate: "walk" (default; mark-sampled LF walk, memory-lean) or
    "direct" (keep the whole suffix array device-resident: locate = one
    gather instead of an LF walk, +4 B/char — see FMIndex.sa_direct).

    checkpoint_dir: if set, the suffix array is materialized there after the
    sort phase and reused on re-runs — the analog of the reference's
    disk-materialized per-phase bin files (dcx.hh:846-861), giving builds a
    resume point.

    pad_shape: optional (n_pad, ndocs_pad) SHAPE BUCKET.  The text is
    padded with trailing 0 symbols and doc_starts with degenerate empty
    docs, so every build with the same pad_shape compiles ONCE — the fix
    for ragged chunk recompiles in chunked >2^31 builds.
    Pad suffixes are all-zero strings that sort first and can match no
    pattern (the same trailing-ESCAPE(0) scheme as the sharded builds,
    parallel/dist_build.py): the index keeps them as `meta.row0` leading
    rows and queries run over [row0, n_rows) unchanged.

    text_dev16: optional device-resident uint16[n_build] copy of the
    (padded) prepared text, e.g. prefetched by build_chunked_prepared while
    the previous chunk was building.  The text ships as uint16 (symbols <
    261), half the host->device bytes of int32, and is widened on device.

    text_dev32: optional int32[n_build] device text with escapes already in
    place — the uint8 bulk-upload path (4x smaller transfer): callers ship
    raw content bytes and reconstruct escapes on device via _expand_u8 +
    _escape_positions (build_chunked_prepared does this automatically).
    """
    from .metrics import metrics
    from .suffix import suffix_array

    if tier is None:
        tier = "compact" if compact else "full"
    n = prepared.n
    if n == 0:
        raise ValueError("cannot index an empty corpus")
    if tier != "full" and not device_build:
        raise ValueError("compact/packed tiers require device_build=True")
    if (text_dev16 is not None or text_dev32 is not None) \
            and not device_build:
        raise ValueError("text_dev16/text_dev32 require device_build=True")
    if text_dev16 is not None and text_dev32 is not None:
        raise ValueError("pass at most one of text_dev16/text_dev32")
    if n >= 2**31:
        raise ValueError(
            "single-index corpora are limited to 2^31 symbols (int32 row "
            "ids); use femto_tpu.multi.build_chunked_prepared, which "
            "composes per-chunk int32 indexes into global int64 results "
            "(the CLI `index` command does this automatically)"
        )
    if checkpoint_dir is not None and sa is None:
        ckpt_path = os.path.join(checkpoint_dir, f"sa_{n}.npy")
        if os.path.exists(ckpt_path):
            sa = np.load(ckpt_path)
        else:
            with metrics.timer("build/suffix_array"):
                sa = np.asarray(
                    suffix_array(jnp.asarray(prepared.text.astype(np.int32)))
                )
            os.makedirs(checkpoint_dir, exist_ok=True)
            np.save(ckpt_path, sa)
    if pad_shape is not None:
        n_build, ndocs_build = pad_shape
        if not device_build:
            raise ValueError("pad_shape requires device_build=True")
        if sa is not None or checkpoint_dir is not None:
            raise ValueError("pad_shape is incompatible with a "
                             "precomputed/checkpointed suffix array")
        if n_build < n or ndocs_build < prepared.num_docs:
            raise ValueError("pad_shape smaller than the corpus")
    else:
        n_build, ndocs_build = n, prepared.num_docs
    if device_build:
        from .ops.build_ops import (
            _FUSE_DOC_LIMIT, build_fm_arrays_device, build_sa_payload,
        )
        from .ops.rank import n_segments

        doc_starts_np32 = prepared.doc_starts.astype(np.int32)
        if ndocs_build > prepared.num_docs:
            doc_starts_np32 = np.concatenate([
                doc_starts_np32,
                np.full(ndocs_build - prepared.num_docs, n, np.int32),
            ])
        if text_dev32 is not None:
            if (text_dev32.shape[0] != n_build
                    or text_dev32.dtype != jnp.int32):
                raise ValueError("text_dev32 must be int32[n_build]")
            text_dev = text_dev32
        else:
            if text_dev16 is None:
                text16 = prepared.text  # uint16: half the transfer of int32
                if text16.dtype != np.uint16:
                    # lossless: alphabet codes are < 261
                    text16 = text16.astype(np.uint16)
                if n_build > n:
                    text16 = np.concatenate(
                        [text16, np.zeros(n_build - n, np.uint16)]
                    )
                text_dev16 = jnp.asarray(text16)
            elif (text_dev16.shape[0] != n_build
                  or text_dev16.dtype != jnp.uint16):
                raise ValueError("text_dev16 must be uint16[n_build]")
            text_dev = _widen_i32(text_dev16)
            text_dev16 = None  # drop this frame's ref to the uint16 buffer
        doc_starts_dev = jnp.asarray(doc_starts_np32)
        pull = None
        # the corpus is host-resident: one bincount gives the symbol set,
        # sparing suffix_array its device histogram + host round-trip
        alpha_np = np.nonzero(
            np.bincount(prepared.text, minlength=ALPHA_SIZE)
        )[0].astype(np.int32)
        if n_build > n and alpha_np[0] != 0:
            alpha_np = np.concatenate([np.zeros(1, np.int32), alpha_np])
        if sa is None and ndocs_build < _FUSE_DOC_LIMIT:
            # fused path: the suffix sort carries the BWT+aux word as a
            # free payload operand, skipping the O(n) packaging gather
            payload = build_sa_payload(
                text_dev, doc_starts_dev, n=n_build, mark_period=mark_period,
                ndocs=ndocs_build,
            )
            sa_dev, pull = suffix_array(
                text_dev, payload=payload, alpha=alpha_np,
                n_real=n if n_build > n else None)
        else:
            sa_dev = (
                suffix_array(text_dev, alpha=alpha_np,
                             n_real=n if n_build > n else None)
                if sa is None
                else jnp.asarray(np.asarray(sa, dtype=np.int32))
            )
        arrays, n_marks, alpha_used = build_fm_arrays_device(
            text_dev,
            sa_dev,
            doc_starts_dev,
            n=n_build,
            seg=seg,
            mark_period=mark_period,
            ndocs=ndocs_build,
            tier=tier,
            pull=pull,
            alpha=alpha_np,
        )
        meta = FMMeta(
            n=n,
            seg=seg,
            mark_period=mark_period,
            num_docs=prepared.num_docs,
            n_marks=int(n_marks),
            n_seg=n_segments(arrays),
            alpha_used=alpha_used,
            n_rows=n_build,
            row0=n_build - n,
        )
    else:
        if sa is None:
            sa = np.asarray(
                suffix_array(jnp.asarray(prepared.text.astype(np.int32)))
            )
        arrays, meta = build_fm_arrays(
            prepared.text, sa, prepared.doc_starts, seg=seg,
            mark_period=mark_period,
        )
    if locate not in ("walk", "direct"):
        raise ValueError(f"unknown locate tier {locate!r}")
    index = FMIndex(
        arrays=arrays,
        meta=meta,
        doc_starts_np=prepared.doc_starts.astype(np.int64),
        infos=list(prepared.infos),
        header_lens_np=prepared.header_lens,
        sa_direct=(
            (sa_dev if device_build else jnp.asarray(
                np.asarray(sa, dtype=np.int32)))
            if locate == "direct" else None
        ),
    )
    if doc_chunks:
        if device_build:
            # device pass (works under pad_shape: pad rows drop out)
            from .ops.build_ops import build_doc_lists_device

            offs, docs_arr = build_doc_lists_device(
                sa_dev, doc_starts_dev, n=n, n_seg=meta.n_seg, seg=seg)
        else:
            sa_np = np.asarray(sa).astype(np.int64)
            offs, docs_arr = compute_chunk_doc_lists(
                sa_np, prepared.doc_starts, seg, meta.n_seg
            )
        index.chunk_doc_offsets_np = offs
        index.chunk_docs_np = docs_arr
    return index
