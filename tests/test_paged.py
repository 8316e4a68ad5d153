"""Larger-than-device-memory paged serving (paged.PagedIndex): a row-tier index
several times larger than the device budget must serve EXACT
count/locate/regex through the host-resident row store + device row
cache — the device analog of the reference's bucket/block LRU caches over
mmap'd blocks (index.c:1222, server.c:3383; femto.pdf §4.1)."""

import os

import numpy as np
import pytest

import femto_tpu as ft
from femto_tpu.paged import PagedIndex, load_auto, load_paged


@pytest.fixture(scope="module")
def corpus():
    import pydoc_data.topics as t

    buf = ("\n".join(sorted(t.topics.values()))).encode()[:400000]
    docs = [buf[i:i + 30000] for i in range(0, len(buf), 30000)]
    docs += [b"zz-needle-zz" + buf[:500]]
    return docs, ft.prepare_documents(docs)


@pytest.fixture(scope="module", params=["vrle", "vseg"])
def paged_pair(corpus, request, tmp_path_factory):
    docs, prep = corpus
    ix = ft.build_index(prep, tier=request.param, seg=256, mark_period=8)
    p = str(tmp_path_factory.mktemp("pg") / "idx.ftpu")
    ix.save_flat(p)
    meta, infos, arrs = ft.FMIndex.parse_flat(p)
    bwt_bytes = arrs["bwt"].nbytes
    resident = sum(v.nbytes for k, v in arrs.items() if k != "bwt")
    n_seg = arrs["bwt"].shape[0]
    # row-store budget = 1/4 of the rows: the index is ~4x the cache
    budget = resident + n_seg * 4 + bwt_bytes // 4
    pg = load_paged(p, budget_bytes=budget)
    assert pg.cache_rows < n_seg // 3
    return docs, ix, pg


def naive_count(docs, pat):
    c = 0
    for d in docs:
        i = 0
        while True:
            i = d.find(pat, i)
            if i < 0:
                break
            c += 1
            i += 1
    return c


def test_paged_count_exact(paged_pair):
    docs, ix, pg = paged_pair
    pats = [b"the", b"of ", b"index", b"zz-needle-zz", b"qqqqzz", b"a"]
    got = pg.count(pats)
    want = np.asarray([naive_count(docs, p) for p in pats])
    assert (got == want).all(), (got, want)
    # warm re-run: same answers, zero extra faults
    before = pg.stats["faults"]
    got2 = pg.count(pats)
    assert (got2 == want).all()
    assert pg.stats["faults"] == before


def test_paged_locate_exact(paged_pair):
    docs, ix, pg = paged_pair
    f, l = pg.count_ranges([b"index"])
    offs = np.sort(pg.locate_range(int(f[0]), int(l[0])))
    from femto_tpu.search import locate_range

    want = np.sort(locate_range(ix, int(f[0]), int(l[0])))
    assert (offs == want).all()
    # (doc, offset) resolution
    locs = pg.locate(b"zz-needle-zz")
    assert locs == ft.locate(ix, b"zz-needle-zz")


def test_paged_regexp(paged_pair):
    docs, ix, pg = paged_pair
    from femto_tpu.query.nfa import compile_nfa
    from femto_tpu.query.parser import parse_query
    from femto_tpu.query.planning import streamline
    from femto_tpu.query.regexp import run_regexp

    for q in ("ind[ea]x", "APPROX 1 indx"):
        node = parse_query(q)
        nfa = compile_nfa(streamline(node.regexp))
        got = sorted((m.first, m.last, m.cost)
                     for m in run_regexp(pg, nfa, node.approx))
        want = sorted((m.first, m.last, m.cost)
                      for m in run_regexp(ix, nfa, node.approx))
        assert got == want, q


def test_paged_eviction_cycles(paged_pair):
    """Touch far more distinct segments than the cache holds: eviction
    must recycle slots without corrupting answers."""
    docs, ix, pg = paged_pair
    n = pg.meta.n
    rng = np.random.default_rng(3)
    from femto_tpu.search import locate_rows_array

    start_faults = pg.stats["faults"]
    for trial in range(3):  # disjoint batches force slot recycling
        rows = rng.integers(0, n, size=320).astype(np.int32)
        want = locate_rows_array(ix, rows)
        got = pg.locate_rows_array(rows)
        assert (got == want).all()
    assert pg.stats["faults"] - start_faults > pg.cache_rows  # recycled


def test_paged_engine_and_extract(paged_pair):
    """The full query engine runs against a PagedIndex through the
    search.py dispatch points: Boolean docs, count_query, extraction."""
    docs, ix, pg = paged_pair
    from femto_tpu.query.engine import count_query, docs_query

    for q in ('"the" AND "index"', "ind[ea]x", '"needle"'):
        got = {d for d, _, _ in docs_query(pg, q)}
        want = {d for d, _, _ in docs_query(ix, q)}
        assert got == want, q
        assert count_query(pg, q) == count_query(ix, q), q
    assert pg.extract_document(len(docs) - 1) == docs[-1]


def test_paged_cli_search(corpus, tmp_path, monkeypatch, capsys):
    """CLI search against a paged index via the FEMTO_TPU_HBM_BUDGET
    knob gives byte-identical output to the resident run."""
    docs, prep = corpus
    from femto_tpu.cli import main as cli_main

    ix = ft.build_index(prep, tier="vrle", seg=256, mark_period=8)
    p = str(tmp_path / "idx.ftpu")
    ix.save_flat(p)
    argv = ["search", p, "index", "--count"]
    assert cli_main(argv) == 0
    resident_out = capsys.readouterr().out
    monkeypatch.setenv("FEMTO_TPU_HBM_BUDGET",
                       str(os.path.getsize(p) // 3))
    assert cli_main(argv) == 0
    assert capsys.readouterr().out == resident_out


def test_load_auto_dispatch(corpus, tmp_path):
    docs, prep = corpus
    ix = ft.build_index(prep, tier="vrle", seg=256, mark_period=8)
    p = str(tmp_path / "idx.ftpu")
    ix.save_flat(p)
    total = os.path.getsize(p)
    assert isinstance(load_auto(p, budget_bytes=total // 3), PagedIndex)
    assert isinstance(load_auto(p, budget_bytes=total * 10), ft.FMIndex)
    # env knob
    os.environ["FEMTO_TPU_HBM_BUDGET"] = str(total // 3)
    try:
        assert isinstance(load_auto(p), PagedIndex)
    finally:
        del os.environ["FEMTO_TPU_HBM_BUDGET"]
    assert isinstance(load_auto(p), ft.FMIndex)
