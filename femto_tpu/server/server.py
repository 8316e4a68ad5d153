"""Batching query server + femto.h text protocol over HTTP.

The reference server is N worker pthreads with per-thread RB-trees of leaf
queries, work stealing, and row-sorted sweeps (/root/reference/src/main/
server.c:3093-3604) — request batching is its signature throughput idea.
On the accelerator the batch dimension IS the request batching: a
collector thread drains the pending-request queue every few milliseconds
and executes ONE batched backward-search for all of them.

The text protocol matches femto.h:86-139:
  find_strings PATTERN
  find_docs MAX_MATCHES OFFSETS? PATTERN
  docs_for_range MAX_MATCHES OFFSETS? START_ROW END_ROW
  string_rows CHARACTER...            (numeric alphabet codes)
  string_rows_left / string_rows_right / string_rows_all CHARACTER...
served over HTTP POST (mod_femto style: POST /femto/<index>/ with the
request line as the body) and usable in-process via FemtoServer.request().
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Tuple

import numpy as np

from ..alphabet import CHARACTER_OFFSET, pattern_to_alpha
from ..fmindex import FMIndex
from ..search import (
    count_ranges,
    offsets_to_docs,
    pack_patterns,
)


class _BatchCollector:
    """Collects concurrent requests of EVERY protocol type and runs each
    window as one device batch per leaf-query kind — the whole-surface
    analog of the reference's row-sorted worker sweep over all leaf query
    types (server.c:3093-3340), collapsed into batch dimensions.

    Kinds: "count" (pattern -> row range) and "locate" (rows -> offsets).
    find_docs / docs_for_range / string_rows all feed the same queues, so a
    mixed concurrent workload shares device dispatches."""

    def __init__(self, index: FMIndex, window_ms: float = 2.0,
                 max_batch: int = 4096):
        self.index = index
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.q: "queue.Queue[Tuple[str, object, dict]]" = queue.Queue()
        self.stats = {"batches": 0, "queries": 0,
                      "count_batches": 0, "locate_batches": 0}
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, kind: str, payload):
        holder = {"event": threading.Event(), "result": None, "error": None}
        self.q.put((kind, payload, holder))
        return holder

    def _wait(self, holder):
        holder["event"].wait()
        if holder["error"] is not None:
            raise holder["error"]
        return holder["result"]

    def count(self, pattern: bytes) -> Tuple[int, int]:
        """Row range of a literal pattern (batched across requests)."""
        return self._wait(self.submit("count", pattern_to_alpha(pattern)))

    def locate(self, rows: np.ndarray) -> np.ndarray:
        """Text offsets of arbitrary rows (batched across requests)."""
        if len(rows) == 0:
            return np.zeros(0, np.int64)
        return self._wait(self.submit("locate", np.asarray(rows)))

    def _run(self):
        import jax  # noqa: F401 — keeps the backend initialized per thread

        while not self._stop:
            try:
                first_item = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first_item]
            deadline = time.perf_counter() + self.window
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            counts = [(p, h) for k, p, h in batch if k == "count"]
            locs = [(p, h) for k, p, h in batch if k == "locate"]
            # Stats update BEFORE result delivery: a waiter whose event is
            # set may read .stats immediately, so incrementing after the
            # events would race (observed as a rare stats-assertion flake).
            self.stats["batches"] += 1
            self.stats["queries"] += len(batch)
            if counts:
                self._run_counts(counts)
            if locs:
                self._run_locates(locs)

    def _run_counts(self, items):
        try:
            packed, B = pack_patterns([p for p, _ in items])
            first, last = _count_jit_cached(self.index, packed)
            first, last = np.asarray(first), np.asarray(last)
            self.stats["count_batches"] += 1  # before the events (see _run)
            for i, (_, holder) in enumerate(items):
                holder["result"] = (int(first[i]), int(last[i]))
                holder["event"].set()
        except Exception as e:  # noqa: BLE001 — keep the collector alive
            self.stats["errors"] = self.stats.get("errors", 0) + 1
            for _, holder in items:
                holder["error"] = e
                holder["event"].set()

    def _run_locates(self, items):
        try:
            from ..search import locate_rows_array

            rows = np.concatenate([p for p, _ in items])
            offs = locate_rows_array(self.index, rows)
            self.stats["locate_batches"] += 1  # before the events (see _run)
            pos = 0
            for p, holder in items:
                holder["result"] = offs[pos: pos + len(p)]
                holder["event"].set()
                pos += len(p)
        except Exception as e:  # noqa: BLE001
            self.stats["errors"] = self.stats.get("errors", 0) + 1
            for _, holder in items:
                holder["error"] = e
                holder["event"].set()

    def stop(self):
        self._stop = True


# Back-compat alias (round-1 name)
_BatchingCounter = _BatchCollector


def _count_jit_cached(index: FMIndex, packed: np.ndarray):
    from ..search import _count_jit
    import jax.numpy as jnp

    return _count_jit(index.arrays, index.meta.n_rows,
                      jnp.asarray(packed), row0=index.meta.row0)


class FemtoServer:
    """In-process server: request batching + the generic text protocol."""

    def __init__(self, index: FMIndex, window_ms: float = 2.0):
        self.index = index
        self.counter = _BatchingCounter(index, window_ms=window_ms)

    # ---- protocol entry (femto_create_generic_request analog) ----

    def request(self, line: str) -> str:
        parts = line.strip().split(" ", 1)
        cmd = parts[0]
        rest = parts[1] if len(parts) > 1 else ""
        if cmd == "find_strings":
            return self._find_strings(rest)
        if cmd == "find_docs":
            return self._find_docs(rest)
        if cmd == "docs_for_range":
            return self._docs_for_range(rest)
        if cmd == "string_rows":
            return self._string_rows(rest, "none")
        if cmd == "string_rows_left":
            return self._string_rows(rest, "left")
        if cmd == "string_rows_right":
            return self._string_rows(rest, "right")
        if cmd == "string_rows_all":
            return self._string_rows(rest, "all")
        raise ValueError(f"unknown request: {cmd}")

    # ---- handlers ----

    def _find_strings(self, pattern: str) -> str:
        from ..query.engine import find_strings

        matches = find_strings(self.index, pattern)
        return json.dumps({
            "matches": [
                {
                    "range": [m.first, m.last],
                    "cost": m.cost,
                    "match": [b + CHARACTER_OFFSET for b in m.match],
                }
                for m in matches
            ]
        })

    def _find_docs(self, rest: str) -> str:
        parts = rest.split(" ", 2)
        max_matches = int(parts[0])
        with_offsets = parts[1] == "1"
        pattern = parts[2]
        rows, truncated = self._find_docs_rows(
            pattern, max_matches, with_offsets)
        return json.dumps({
            "results": [
                {
                    "doc_info": info.decode("utf-8", "replace"),
                    **({"offsets": offs} if with_offsets else {}),
                }
                for _, info, offs in rows
            ],
            # a Boolean term hit the materialization cap: doc set may be
            # incomplete (engine.TruncationWarning)
            **({"truncated": True} if truncated else {}),
        })

    def _find_docs_rows(self, pattern: str, max_matches: int,
                        with_offsets: bool):
        """Literal terms ride the batching collector (count + locate batch
        shared with all concurrent requests); regex/Boolean queries fall
        back to the query engine."""
        from ..query.ast import QTerm, as_literal
        from ..query.parser import parse_query
        from ..query.planning import streamline

        cap = max_matches if max_matches > 0 else None
        node = parse_query(pattern)
        lit = None
        if isinstance(node, QTerm) and node.approx.cost_bound <= 1:
            lit = as_literal(streamline(node.regexp))
        if lit is None:
            from ..query.engine import docs_query_ex

            return docs_query_ex(self.index, pattern, max_matches=cap,
                                 with_offsets=with_offsets)
        first, last = self.counter.count(lit)
        m = last - first if cap is None else min(last - first, cap)
        offs = self.counter.locate(
            np.arange(first, first + m, dtype=np.int32))
        doc, doc_off = offsets_to_docs(self.index, np.asarray(offs))
        per_doc = {}
        for d, o in zip(doc.tolist(), doc_off.tolist()):
            per_doc.setdefault(d, []).append(o)
        return [
            (d, self.index.infos[d], sorted(o))
            for d, o in sorted(per_doc.items())
        ], False

    def _docs_for_range(self, rest: str) -> str:
        parts = rest.split()
        max_matches, with_offsets = int(parts[0]), parts[1] == "1"
        start, end = int(parts[2]), int(parts[3])
        m = end - start
        if max_matches > 0:
            m = min(m, max_matches)
        offs = self.counter.locate(
            np.arange(start, start + max(m, 0), dtype=np.int32))
        doc, doc_off = offsets_to_docs(self.index, np.asarray(offs))
        per_doc = {}
        for d, o in zip(doc.tolist(), doc_off.tolist()):
            per_doc.setdefault(d, []).append(o)
        return json.dumps({
            "range": [start, end],
            "results": [
                {
                    "doc_info": self.index.infos[d].decode("utf-8", "replace"),
                    **({"offsets": sorted(o)} if with_offsets else {}),
                }
                for d, o in sorted(per_doc.items())
            ],
        })

    def _string_rows(self, rest: str, mode: str) -> str:
        chars = [int(c) for c in rest.split()] if rest.strip() else []
        pattern = bytes(
            c - CHARACTER_OFFSET for c in chars if c >= CHARACTER_OFFSET
        )
        first, last = self.counter.count(pattern)
        out = {}
        if mode == "none":
            return json.dumps({"range": [first, last]})
        if mode in ("left", "all"):
            out["left"] = self._extensions_left(pattern)
        if mode in ("right", "all"):
            out["right"] = self._extensions_right(pattern)
        if mode == "all":
            out = {"range": [first, last], **out}
        return json.dumps(out)

    def _extensions_left(self, pattern: bytes) -> List[dict]:
        """Ranges of c+pattern for every byte c — one extra backward step,
        batched over the alphabet."""
        pats = [bytes([c]) + pattern for c in range(256)]
        first, last = count_ranges(self.index, pats)
        return [
            {"ch": c + CHARACTER_OFFSET, "range": [int(f), int(l)]}
            for c, (f, l) in enumerate(zip(first, last))
            if l > f
        ]

    def _extensions_right(self, pattern: bytes) -> List[dict]:
        """Ranges of pattern+c for every byte c, as ONE device batch of 256
        searches.  This matches the reference exactly: its
        string_rows_addright also runs ALPHA_SIZE full string queries of
        pattern+c (setup_string_rows_addleftright_query,
        /root/reference/src/main/server.c:4262-4302) — there is no
        single-select shortcut for right extension in a backward FM-index."""
        pats = [pattern + bytes([c]) for c in range(256)]
        first, last = count_ranges(self.index, pats)
        return [
            {"ch": c + CHARACTER_OFFSET, "range": [int(f), int(l)]}
            for c, (f, l) in enumerate(zip(first, last))
            if l > f
        ]

    def stop(self):
        self.counter.stop()


class IndexPool:
    """LRU of loaded indexes, keyed by path — the analog of the reference
    server's per-thread block cache over multiple mounted indexes
    (server.h:626-631); mod_femto serves several indexes by URL path."""

    def __init__(self, max_loaded: int = 4):
        self.max_loaded = max_loaded
        self._lock = threading.Lock()
        self._servers: "dict[str, FemtoServer]" = {}
        self._order: List[str] = []

    def get(self, path: str) -> FemtoServer:
        with self._lock:
            if path in self._servers:
                self._order.remove(path)
                self._order.append(path)
                return self._servers[path]
        index = FMIndex.load(path)
        srv = FemtoServer(index)
        with self._lock:
            self._servers[path] = srv
            self._order.append(path)
            while len(self._order) > self.max_loaded:
                old = self._order.pop(0)
                self._servers.pop(old).stop()
        return srv

    def stop(self):
        with self._lock:
            for srv in self._servers.values():
                srv.stop()
            self._servers.clear()
            self._order.clear()


def make_handler(default_server: FemtoServer, pool: IndexPool,
                 base_dir: str, index_path: str = ""):
    """HTTP request handler class (mod_femto style: POST body = one
    protocol line) over an in-process FemtoServer.

    POST /              -> query default_server
    POST /femto/NAME/   -> query sibling index NAME in base_dir (via pool)
    GET  /stats         -> metrics snapshot
    """
    import os

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length).decode("utf-8", "replace")
            try:
                srv = default_server
                parts = [p for p in self.path.split("/") if p]
                if len(parts) >= 2 and parts[0] == "femto":
                    name = parts[1]
                    cand = os.path.join(base_dir, name)
                    # refuse names that escape base_dir ("..", absolute, ...)
                    inside = os.path.abspath(cand).startswith(
                        os.path.abspath(base_dir) + os.sep
                    )
                    if inside \
                            and os.path.abspath(cand) != os.path.abspath(index_path) \
                            and os.path.exists(cand):
                        srv = pool.get(cand)
                resp = srv.request(body)
                code = 200
            except Exception as e:  # noqa: BLE001
                resp = json.dumps({"error": str(e)})
                code = 400
            data = resp.encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            from ..metrics import metrics

            if self.path.rstrip("/") == "/stats":
                snap = dict(metrics.snapshot())
                snap["batching"] = default_server.counter.stats
                data = json.dumps(snap).encode()
                code = 200
            elif self.path in ("/", "/index.html"):
                # minimal browser search UI (the mod_femto/femto-js analog)
                ui = os.path.join(os.path.dirname(__file__), "ui.html")
                with open(ui, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            else:
                data = b'{"error": "POST protocol requests to /"}'
                code = 404
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    return Handler


def serve(index_path: str, host: str = "127.0.0.1", port: int = 7733,
          num_threads: int = 4):
    """HTTP front end over the index at index_path (see make_handler)."""
    import os

    pool = IndexPool()
    default_server = pool.get(index_path)
    base_dir = os.path.dirname(os.path.abspath(index_path))
    httpd = ThreadingHTTPServer(
        (host, port),
        make_handler(default_server, pool, base_dir, index_path))
    print(f"femto-tpu server on http://{host}:{port}/ "
          f"(index: {index_path}, n={default_server.index.meta.n})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        pool.stop()
