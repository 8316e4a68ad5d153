"""Tools, CLI, flat format, and server protocol tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import femto_tpu as ft
from femto_tpu.tools import (
    ast_to_python_regex,
    common_substrings,
    scan_files,
    similarity,
)
from femto_tpu.server.server import FemtoServer
from femto_tpu.alphabet import CHARACTER_OFFSET
from tests.oracle import naive_count


@pytest.fixture(scope="module")
def corpus_index(tmp_path_factory):
    docs = [
        b"the quick brown fox jumps over the lazy dog",
        b"banana bandana cabana",
        b"sheep black sheep",
        b"abcdabcdabcdabcd",
    ]
    prepared = ft.prepare_documents(docs)
    index = ft.build_index(prepared, seg=64, mark_period=8)
    return docs, index


def test_flat_roundtrip(corpus_index, tmp_path):
    docs, index = corpus_index
    path = str(tmp_path / "idx.ftpu")
    index.save_flat(path)
    loaded = ft.FMIndex.load(path)
    pats = [b"banana", b"sheep", b"abcd"]
    np.testing.assert_array_equal(ft.count(loaded, pats), ft.count(index, pats))
    assert loaded.meta == index.meta
    assert loaded.infos == index.infos


def test_common_substrings(corpus_index):
    docs, index = corpus_index
    out = common_substrings(index, length=4, min_count=2, top_k=5)
    assert out, "should find common substrings"
    top, cnt = out[0]
    assert cnt == naive_count(docs, top)
    assert (b"abcd", 4) in out


def test_similarity(corpus_index):
    docs, index = corpus_index
    assert similarity(index, docs[1], k=4) == 1.0
    assert similarity(index, b"zzzzyyyyxxxxwwww", k=4) == 0.0


def test_scan_matches_index(corpus_index, tmp_path):
    docs, index = corpus_index
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"doc{i}.bin"
        p.write_bytes(d)
        paths.append(str(p))
    from femto_tpu.query.engine import count_query

    for q in ["sheep", "ban(ana|dana)", "ab[cd]d"]:
        hits = scan_files(q, sorted(paths))
        assert len(hits) == count_query(index, q), q


def test_cli_end_to_end(tmp_path):
    docdir = tmp_path / "docs"
    docdir.mkdir()
    (docdir / "a.txt").write_bytes(b"the quick brown fox")
    (docdir / "b.txt").write_bytes(b"lazy dogs sleep quickly")
    idx = str(tmp_path / "idx")
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def run(*args):
        r = subprocess.run(
            [sys.executable, "-m", "femto_tpu.cli", *args],
            capture_output=True, env=env, timeout=300,
        )
        assert r.returncode == 0, r.stderr.decode()
        return r.stdout.decode()

    run("index", idx, "--input", str(docdir), "--seg", "64")
    out = run("search", idx, "quick", "--count")
    assert out.startswith("2 ")
    out = run("search", idx, "quick", "--offsets")
    assert "a.txt" in out and "b.txt" in out
    out = run("info", idx)
    meta = json.loads(out)
    assert meta["num_docs"] == 2
    out = run("extract", idx, "--doc", "0")
    assert out == "the quick brown fox"
    flat = str(tmp_path / "idx.ftpu")
    run("flatten", idx, flat)
    out = run("search", flat, "quick", "--count")
    assert out.startswith("2 ")
    qf = tmp_path / "queries.txt"
    qf.write_bytes(b"quick\nlazy\nzz\n")
    out = run("multiquery", idx, str(qf))
    assert out.splitlines()[0].startswith("2 ")
    out = run("size", str(docdir))
    assert "2 files" in out
    out = run("scan", "quick", str(docdir))
    assert len(out.splitlines()) == 2


def test_server_protocol(corpus_index):
    docs, index = corpus_index
    srv = FemtoServer(index, window_ms=1.0)
    try:
        r = json.loads(srv.request("find_strings sheep"))
        assert r["matches"][0]["range"][1] - r["matches"][0]["range"][0] == 2
        r = json.loads(srv.request("find_docs 10 1 sheep"))
        assert len(r["results"]) == 1
        assert r["results"][0]["offsets"] == [0, 12]
        chars = " ".join(str(b + CHARACTER_OFFSET) for b in b"sheep")
        r = json.loads(srv.request("string_rows " + chars))
        f, l = r["range"]
        assert l - f == 2
        r2 = json.loads(srv.request("docs_for_range 10 1 %d %d" % (f, l)))
        assert len(r2["results"]) == 1
        r = json.loads(srv.request("string_rows_all " + chars))
        left_chars = {e["ch"] - CHARACTER_OFFSET for e in r["left"]}
        assert ord(" ") in left_chars  # " sheep"
        right_chars = {e["ch"] - CHARACTER_OFFSET for e in r["right"]}
        assert ord(" ") in right_chars  # "sheep "
    finally:
        srv.stop()


def test_server_batching(corpus_index):
    docs, index = corpus_index
    srv = FemtoServer(index, window_ms=5.0)
    try:
        import threading

        results = {}

        def worker(p):
            results[p] = srv.counter.count(p)

        pats = [b"sheep", b"banana", b"fox", b"the", b"zz", b"abcd"]
        threads = [threading.Thread(target=worker, args=(p,)) for p in pats]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for p in pats:
            f, l = results[p]
            assert l - f == naive_count(docs, p), p
        # The collector updates stats BEFORE delivering results (events),
        # so by the time every worker joined, all stats are final.
        stats = dict(srv.counter.stats)
        assert stats["queries"] == len(pats), stats
        assert stats["batches"] <= len(pats), stats
        assert stats["batches"] >= 1, stats
    finally:
        srv.stop()


def test_ast_to_python_regex():
    import re

    from femto_tpu.query.parser import parse_query

    node = parse_query("ab[c-e]+(f|g){2}")
    pat = re.compile(ast_to_python_regex(node.regexp))
    assert pat.fullmatch(b"abcdeff")
    assert pat.fullmatch(b"abcfg")
    assert not pat.fullmatch(b"abfg")


def test_server_mixed_protocol_batching(corpus_index):
    """Concurrent requests of DIFFERENT protocol types must share collector
    batches (VERDICT round-1 item 7: batch the whole server surface)."""
    docs, index = corpus_index
    srv = FemtoServer(index, window_ms=60.0)
    try:
        import threading

        results = {}

        def w_count():
            chars = " ".join(str(b + CHARACTER_OFFSET) for b in b"sheep")
            results["count"] = json.loads(srv.request("string_rows " + chars))

        def w_docs():
            results["docs"] = json.loads(srv.request("find_docs 10 1 sheep"))

        def w_range():
            f, l = ft.count_ranges(index, [b"black"])
            results["range"] = json.loads(
                srv.request("docs_for_range 10 1 %d %d" % (int(f[0]), int(l[0]))))

        threads = [threading.Thread(target=f)
                   for f in (w_count, w_docs, w_range)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        f, l = results["count"]["range"]
        assert l - f == naive_count(docs, b"sheep")
        assert results["docs"]["results"][0]["offsets"] == [0, 12]
        assert len(results["range"]["results"]) >= 1
        st = srv.counter.stats
        # 4+ leaf queries (2 counts via find_docs+string_rows, 2 locates)
        # landed in fewer collector windows than requests
        assert st["queries"] >= 4
        assert st["batches"] < st["queries"]
        assert st["locate_batches"] >= 1 and st["count_batches"] >= 1
    finally:
        srv.stop()
