"""Command-line tools: the femto tool-suite equivalents.

Reference tools (SURVEY.md §2.9): femto_index, femto_search, femto_extract,
femto_scan, femto_size, femto_suffix_sort, femto_flatten, femto_info,
femto_multiquery, femto_common, femto_similar.  Here one `femto-tpu`
multi-command binary:

  femto-tpu index   OUT --input PATH... [--fasta] [--seg N] [--mark-period N]
  femto-tpu search  INDEX QUERY [--count|--offsets|--matches|--docs] ...
  femto-tpu extract INDEX (--doc N | --all)
  femto-tpu scan    QUERY PATH...
  femto-tpu size    PATH...
  femto-tpu suffix-sort IN OUT
  femto-tpu flatten INDEXDIR OUTFILE
  femto-tpu info    INDEX
  femto-tpu multiquery INDEX QUERYFILE [--locate]
  femto-tpu common  INDEX --length N [--top N]
  femto-tpu similar INDEX FILE...
  femto-tpu serve   INDEX [--port P]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load_index(path: str):
    import os

    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, "multi.json")):
        from .multi import MultiIndex

        return MultiIndex.load(path)
    # FEMTO_TPU_HBM_BUDGET (bytes): flat row-tier indexes larger than the
    # budget open in PAGED mode (paged.PagedIndex) — rows stay on disk,
    # a device cache serves them (the external-memory serving story)
    from .paged import load_auto

    return load_auto(path)


def cmd_index(args) -> int:
    from .fmindex import build_index
    from .io.corpus import read_corpus, read_fasta

    t0 = time.time()
    if args.fasta:
        prepared = read_fasta(args.input)
    else:
        prepared = read_corpus(args.input, max_bytes=args.max_bytes)
    print(f"read {prepared.num_docs} docs, {prepared.n} symbols",
          file=sys.stderr)
    kw = dict(seg=args.seg, mark_period=args.mark_period,
              compact=args.compact, doc_chunks=args.doc_chunks,
              tier=args.tier, locate=args.locate_tier)
    from .multi import MAX_CHUNK_SYMBOLS, build_chunked_prepared

    if prepared.n > MAX_CHUNK_SYMBOLS:
        # >2^31-symbol corpora: per-chunk int32 row ids, global int64
        # doc ids/offsets (reference: 39-bit offsets, index_tool.cc:45).
        mi = build_chunked_prepared(prepared, **kw)
        mi.save(args.out)
        print(f"chunked into {len(mi.indexes)} sub-indexes",
              file=sys.stderr)
    else:
        index = build_index(prepared, **kw)
        if args.out.endswith(".ftpu"):
            index.save_flat(args.out)
        else:
            index.save(args.out)
    dt = time.time() - t0
    print(f"indexed {prepared.n/1e6:.2f}M symbols in {dt:.1f}s "
          f"({prepared.n/dt/1e6:.2f} MB/s) -> {args.out}", file=sys.stderr)
    return 0


def cmd_search(args) -> int:
    """Search one or more indexes (comma-separated paths fan the query
    across them, like the reference's femto_search index list)."""
    from .query.engine import count_query, find_strings

    paths = args.index.split(",")
    loaded_single = _load_index(paths[0]) if len(paths) == 1 else None
    from .multi import MultiIndex

    if len(paths) > 1 or isinstance(loaded_single, MultiIndex):
        mi = (loaded_single if loaded_single is not None
              else MultiIndex([_load_index(p) for p in paths]))
        for query in args.query:
            if args.count:
                print(f"{mi.count_query(query)} {query}")
            else:
                for doc, info, offs in mi.docs_query(
                    query, max_matches=args.max_results,
                    with_offsets=args.offsets,
                ):
                    if args.offsets:
                        print(f"{info.decode('utf-8', 'replace')} "
                              f"{' '.join(map(str, offs))}")
                    else:
                        print(info.decode("utf-8", "replace"))
        return 0

    index = loaded_single
    out_json = []
    for query in args.query:
        if args.grep:
            from .query.engine import term_ranges, apply_icase
            from .query.parser import parse_query
            from .query.ast import QTerm
            from .search import (
                extract_context_batch,
                locate_rows_array,
                offsets_to_docs,
            )

            node = parse_query(query)
            if args.icase:
                node = apply_icase(node)
            if not isinstance(node, QTerm):
                print("--grep needs a single term", file=sys.stderr)
                return 1
            # gather rows across all ranges, then ONE batched locate and
            # ONE batched context extraction (no per-row device calls)
            rows = []
            for f, l, cost in term_ranges(index, node):
                take = min(l - f, args.max_results - len(rows))
                rows.extend(range(f, f + take))
                if len(rows) >= args.max_results:
                    break
            rows_np = np.asarray(rows, dtype=np.int64)
            offs = locate_rows_array(index, rows_np)
            doc, doc_off = offsets_to_docs(index, offs)
            ctxs = extract_context_batch(index, rows_np, before=args.grep,
                                         pattern_len=0,
                                         after=args.grep + 16)
            for i in range(len(rows)):
                info = index.infos[int(doc[i])].decode("utf-8", "replace")
                print(f"{info}:{int(doc_off[i])}: "
                      f"{ctxs[i].decode('utf-8', 'replace')}")
        elif args.matches:
            for m in find_strings(index, query, max_results=args.max_results,
                                  icase=args.icase):
                print(f"[{m.first},{m.last}) cost={m.cost} "
                      f"match={m.match!r} count={m.last - m.first}")
        elif args.count:
            c = count_query(index, query, icase=args.icase)
            if args.json:
                out_json.append({"query": query, "count": c})
            else:
                print(f"{c} {query}")
        else:
            from .query.engine import docs_query_ex

            rows, truncated = docs_query_ex(
                index, query, max_matches=args.max_results,
                with_offsets=args.offsets, icase=args.icase)
            if truncated:
                print(f"warning: query {query!r} hit the Boolean term "
                      "cap; results may be incomplete", file=sys.stderr)
            if args.json:
                out_json.append({
                    "query": query,
                    "results": [
                        {"doc_info": info.decode("utf-8", "replace"),
                         **({"offsets": offsets} if args.offsets else {})}
                        for _, info, offsets in rows
                    ],
                    **({"truncated": True} if truncated else {}),
                })
            else:
                for doc, info, offsets in rows:
                    if args.offsets:
                        print(f"{info.decode('utf-8', 'replace')} "
                              f"{' '.join(map(str, offsets))}")
                    else:
                        print(info.decode("utf-8", "replace"))
    if args.json:
        print(json.dumps(out_json if len(out_json) > 1 else out_json[0]))
    return 0


def cmd_extract(args) -> int:
    from .search import extract_document

    index = _load_index(args.index)
    docs = range(index.num_docs) if args.all else [args.doc]
    for d in docs:
        data = extract_document(index, d)
        sys.stdout.buffer.write(data)
        if args.all:
            sys.stdout.buffer.write(b"\n")
    return 0


def cmd_scan(args) -> int:
    from .tools import scan_files

    for path, off, match in scan_files(args.query, args.path,
                                       max_matches=args.max_results):
        print(f"{path}:{off} {match!r}")
    return 0


def cmd_size(args) -> int:
    from .io.corpus import iter_files
    import os

    total, nfiles = 0, 0
    for fp in iter_files(args.path):
        total += os.path.getsize(fp)
        nfiles += 1
    print(f"{nfiles} files, {total} bytes")
    return 0


def cmd_suffix_sort(args) -> int:
    import numpy as np
    import jax.numpy as jnp

    from .suffix import suffix_array
    from .alphabet import bytes_to_alpha

    with open(args.input, "rb") as f:
        data = f.read()
    text = bytes_to_alpha(data).astype(np.int32)
    sa = np.asarray(suffix_array(jnp.asarray(text)))
    sa.astype(np.int64).tofile(args.out)
    print(f"wrote {len(sa)} suffix offsets to {args.out}", file=sys.stderr)
    return 0


def cmd_bwt(args) -> int:
    """Stage-by-stage pipeline debugging (bwt_tool/bwt_dump analog):
    print the SA, BWT, and C-array summary for a small input."""
    import numpy as np
    import jax.numpy as jnp

    from .alphabet import bytes_to_alpha, CHARACTER_OFFSET, ALPHA_SIZE
    from .suffix import suffix_array, bwt_from_sa

    with open(args.input, "rb") as f:
        data = f.read()
    if args.limit:
        data = data[: args.limit]
    text = jnp.asarray(bytes_to_alpha(data).astype(np.int32))
    sa = suffix_array(text)
    bwt = np.asarray(bwt_from_sa(text, sa))
    sa = np.asarray(sa)
    counts = np.bincount(np.asarray(text), minlength=ALPHA_SIZE)
    print(f"n={len(data)}")
    if args.verbose:
        for r in range(len(sa)):
            ch = bwt[r] - CHARACTER_OFFSET
            printable = chr(ch) if 32 <= ch < 127 else f"\\x{ch:02x}"
            print(f"row {r}: SA={sa[r]} BWT={printable}")
    else:
        out = bytes((bwt - CHARACTER_OFFSET).astype(np.uint8))
        sys.stdout.buffer.write(out)
        sys.stdout.buffer.write(b"\n")
    used = np.nonzero(counts)[0]
    print(f"alphabet in use: {len(used)} symbols", file=sys.stderr)
    return 0


def cmd_flatten(args) -> int:
    index = _load_index(args.index)
    index.save_flat(args.out)
    print(f"flattened -> {args.out}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    import dataclasses

    index = _load_index(args.index)
    meta = dataclasses.asdict(index.meta)
    meta["num_docs"] = index.num_docs
    meta["doc_infos"] = [i.decode("utf-8", "replace")
                         for i in index.infos[:20]]
    print(json.dumps(meta, indent=2))
    return 0


def cmd_multiquery(args) -> int:
    """Batch count/locate driver (femto_multiquery, Pizza&Chili style)."""
    from .search import count, locate

    index = _load_index(args.index)
    with open(args.queryfile, "rb") as f:
        pats = [line.rstrip(b"\r\n") for line in f if line.strip()]
    t0 = time.time()
    if args.locate:
        total = 0
        for p in pats:
            res = locate(index, p, max_matches=args.max_results)
            total += len(res)
            print(f"{p!r}: {len(res)} occurrences")
        dt = time.time() - t0
        print(f"{len(pats)} locate queries, {total} occs in {dt:.3f}s",
              file=sys.stderr)
    else:
        counts = count(index, pats)
        for p, c in zip(pats, counts):
            print(f"{int(c)} {p!r}")
        dt = time.time() - t0
        print(f"{len(pats)} count queries in {dt:.3f}s "
              f"({len(pats)/dt:.0f} q/s)", file=sys.stderr)
    return 0


def cmd_common(args) -> int:
    from .tools import common_substrings

    index = _load_index(args.index)
    for s, c in common_substrings(index, args.length, args.min_count,
                                  args.top):
        print(f"{c}\t{s!r}")
    return 0


def cmd_similar(args) -> int:
    from .tools import similarity

    index = _load_index(args.index)
    for fp in args.file:
        with open(fp, "rb") as f:
            data = f.read()
        print(f"{similarity(index, data, k=args.k):.4f}\t{fp}")
    return 0


def _prepared_and_sa(args):
    import jax.numpy as jnp
    import numpy as np

    from .io.corpus import read_corpus, read_fasta
    from .suffix import suffix_array

    prepared = (read_fasta(args.input) if getattr(args, "fasta", False)
                else read_corpus(args.input))
    sa = np.asarray(
        suffix_array(jnp.asarray(prepared.text.astype("int32")))
    )
    return prepared, sa


def cmd_find_unique(args) -> int:
    """Minimal unique substrings per position (FindUnique)."""
    from .lcp import unique_lengths

    prepared, sa = _prepared_and_sa(args)
    ul = unique_lengths(prepared, sa)
    for d in range(prepared.num_docs):
        s, e = int(prepared.doc_starts[d]), int(prepared.doc_starts[d + 1]) - 1
        lens = ul[s:e]
        info = prepared.infos[d].decode("utf-8", "replace")
        print(f"{info}: {' '.join(map(str, lens.tolist()))}")
    return 0


def cmd_unique_kmers(args) -> int:
    from .lcp import extract_unique_kmers

    prepared, sa = _prepared_and_sa(args)
    for doc, off in extract_unique_kmers(prepared, sa, args.k):
        info = prepared.infos[doc].decode("utf-8", "replace")
        print(f"{info}\t{off}")
    return 0


def cmd_suffix_similarity(args) -> int:
    from .lcp import suffix_similarity

    prepared, sa = _prepared_and_sa(args)
    sim = suffix_similarity(prepared, sa, min_lcp=args.min_lcp)
    for (a, b), score in sorted(sim.items(), key=lambda kv: -kv[1]):
        ia = prepared.infos[a].decode("utf-8", "replace")
        ib = prepared.infos[b].decode("utf-8", "replace")
        print(f"{score:.4f}\t{ia}\t{ib}")
    return 0


def cmd_request(args) -> int:
    """One-shot generic protocol request (femto_handle_request analog)."""
    from .server.server import FemtoServer

    index = _load_index(args.index)
    srv = FemtoServer(index)
    try:
        print(srv.request(args.request))
    finally:
        srv.stop()
    return 0


def cmd_serve(args) -> int:
    from .server.server import serve

    serve(args.index, host=args.host, port=args.port,
          num_threads=args.threads)
    return 0


def main(argv=None) -> int:
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="femto-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("index", help="build an index")
    s.add_argument("out")
    s.add_argument("--input", nargs="+", required=True)
    s.add_argument("--fasta", action="store_true")
    s.add_argument("--seg", type=int, default=256)
    s.add_argument("--mark-period", type=int, default=20)
    s.add_argument("--max-bytes", type=int, default=None)
    s.add_argument("--compact", action="store_true",
                   help="uint16 relative checkpoints (smaller index)")
    s.add_argument("--tier",
                   choices=["full", "compact", "packed", "vseg", "vrle"],
                   default=None,
                   help="storage tier (vseg = per-segment-width compressed"
                        " serving tier, smallest index)")
    s.add_argument("--doc-chunks", action="store_true",
                   help="store per-segment doc lists (fast doc queries)")
    s.add_argument("--locate-tier", choices=["walk", "direct"],
                   default="walk",
                   help="direct = keep the full SA resident: locate is one"
                        " gather (+4 B/char)")
    s.set_defaults(fn=cmd_index)

    s = sub.add_parser("search", help="query an index")
    s.add_argument("index")
    s.add_argument("query", nargs="+")
    s.add_argument("--count", action="store_true")
    s.add_argument("--offsets", action="store_true")
    s.add_argument("--matches", action="store_true")
    s.add_argument("--icase", action="store_true",
                   help="case-insensitive matching")
    s.add_argument("--grep", type=int, default=0, metavar="CTX",
                   help="grep-style output with CTX chars of context")
    s.add_argument("--json", action="store_true", help="JSON output")
    s.add_argument("--max-results", type=int, default=1000)
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("extract", help="extract document(s) from the index")
    s.add_argument("index")
    s.add_argument("--doc", type=int, default=0)
    s.add_argument("--all", action="store_true")
    s.set_defaults(fn=cmd_extract)

    s = sub.add_parser("scan", help="sequential search of raw files")
    s.add_argument("query")
    s.add_argument("path", nargs="+")
    s.add_argument("--max-results", type=int, default=1000)
    s.set_defaults(fn=cmd_scan)

    s = sub.add_parser("size", help="measure input size")
    s.add_argument("path", nargs="+")
    s.set_defaults(fn=cmd_size)

    s = sub.add_parser("suffix-sort", help="standalone suffix array")
    s.add_argument("input")
    s.add_argument("out")
    s.set_defaults(fn=cmd_suffix_sort)

    s = sub.add_parser("bwt", help="dump SA/BWT for a small input (debug)")
    s.add_argument("input")
    s.add_argument("--limit", type=int, default=0)
    s.add_argument("--verbose", action="store_true")
    s.set_defaults(fn=cmd_bwt)

    s = sub.add_parser("flatten", help="pack an index into one file")
    s.add_argument("index")
    s.add_argument("out")
    s.set_defaults(fn=cmd_flatten)

    s = sub.add_parser("info", help="dump index metadata")
    s.add_argument("index")
    s.set_defaults(fn=cmd_info)

    s = sub.add_parser("multiquery", help="batch queries from a file")
    s.add_argument("index")
    s.add_argument("queryfile")
    s.add_argument("--locate", action="store_true")
    s.add_argument("--max-results", type=int, default=None)
    s.set_defaults(fn=cmd_multiquery)

    s = sub.add_parser("common", help="most common substrings")
    s.add_argument("index")
    s.add_argument("--length", type=int, default=8)
    s.add_argument("--min-count", type=int, default=2)
    s.add_argument("--top", type=int, default=20)
    s.set_defaults(fn=cmd_common)

    s = sub.add_parser("similar", help="similarity of files vs the index")
    s.add_argument("index")
    s.add_argument("file", nargs="+")
    s.add_argument("-k", type=int, default=8)
    s.set_defaults(fn=cmd_similar)

    s = sub.add_parser("find-unique", help="minimal unique substring lengths")
    s.add_argument("--input", nargs="+", required=True)
    s.add_argument("--fasta", action="store_true")
    s.set_defaults(fn=cmd_find_unique)

    s = sub.add_parser("unique-kmers", help="positions with unique k-mers")
    s.add_argument("--input", nargs="+", required=True)
    s.add_argument("--fasta", action="store_true")
    s.add_argument("-k", type=int, default=16)
    s.set_defaults(fn=cmd_unique_kmers)

    s = sub.add_parser("suffix-similarity",
                       help="document similarity by shared substrings")
    s.add_argument("--input", nargs="+", required=True)
    s.add_argument("--fasta", action="store_true")
    s.add_argument("--min-lcp", type=int, default=8)
    s.set_defaults(fn=cmd_suffix_similarity)

    s = sub.add_parser("request", help="one-shot generic protocol request")
    s.add_argument("index")
    s.add_argument("request")
    s.set_defaults(fn=cmd_request)

    s = sub.add_parser("serve", help="start the query server")
    s.add_argument("index")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7733)
    s.add_argument("--threads", type=int, default=4)
    s.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
