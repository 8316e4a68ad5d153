"""Serving-size probe on REAL text: feed genuine
code/prose corpora (this repo's sources + the reference's C sources read
as opaque text) through the normal loader and measure B/char per tier,
with a per-array breakdown.  Sizes are data properties, so this runs on
the CPU backend.

Usage: python examples/size_probe_real.py [--seg 256,512] [--tiers packed,vseg]
"""
import argparse
import os
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import femto_tpu as ft                                   # noqa: E402
from femto_tpu.io.corpus import iter_files, read_corpus  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def breakdown(index):
    """{array: B/char} for every stored array (incl. vseg side tables)."""
    n = index.meta.n
    out = {}
    for k, v in index.arrays._asdict().items():
        if v is not None:
            out[k] = np.asarray(v).nbytes / n
    return out


def probe(name, prepared, seg, mark_period, tier):
    index = ft.build_index(prepared, seg=seg, mark_period=mark_period,
                           tier=tier)
    bd = breakdown(index)
    total = sum(bd.values())
    big = sorted(bd.items(), key=lambda kv: -kv[1])[:5]
    parts = ", ".join(f"{k} {v:.3f}" for k, v in big if v >= 0.005)
    print(f"{name:>14} | {tier:>6}, seg={seg:<4} mark={mark_period:<3}| "
          f"{total:.3f} B/char | {parts}", flush=True)
    return index, total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--segs", default="512,1024,2048")
    ap.add_argument("--tiers", default="packed,vseg,vrle")
    ap.add_argument("--mark", default="20,40")
    ap.add_argument("--max-mb", type=float, default=16.0)
    args = ap.parse_args()

    corpora = {}

    # real English/code text: the reference's C sources (multi-MB of
    # genuine prose-dense code) and this repo's Python/Markdown
    ref_files = [f for f in iter_files(["/root/reference/src"])
                 if not f.endswith((".o", ".a", ".so"))]
    prepared = read_corpus(ref_files,
                           max_bytes=int(args.max_mb * (1 << 20)))
    corpora["ref-src(code)"] = prepared
    log(f"ref-src: {prepared.n/1e6:.2f}M symbols, {prepared.num_docs} docs")

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_files = iter_files([os.path.join(repo, p) for p in (
        "femto_tpu", "tests", "PERF.md", "SURVEY.md", "README.md")])
    prepared2 = read_corpus(repo_files,
                            max_bytes=int(args.max_mb * (1 << 20)))
    corpora["repo(py+md)"] = prepared2
    log(f"repo: {prepared2.n/1e6:.2f}M symbols, {prepared2.num_docs} docs")

    # genuine English prose: UNIQUE docstring/pydoc text (corpus_real;
    # never tiled, so BWT runs are honest)
    try:
        from corpus_real import english_prose

        buf = english_prose(args.max_mb)
        pieces = [buf[i:i + 65536] for i in range(0, len(buf), 65536)]
        corpora["english(prose)"] = ft.prepare_documents(pieces)
        log(f"english: {corpora['english(prose)'].n/1e6:.2f}M symbols")
    except ImportError:
        pass

    # DNA (uniform ACGT) + zipf-English synthetics for comparability with
    # the synthetic corpora of earlier size tables
    rng = np.random.default_rng(7)
    nmb = int(min(args.max_mb, 4.0) * (1 << 20))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    dna_docs = [acgt[rng.integers(0, 4, size=1 << 16)].tobytes()
                for _ in range(nmb >> 16)]
    corpora["dna(synth)"] = ft.prepare_documents(dna_docs)
    letters = np.frombuffer(b"etaoin shrdlucmfwypvbgkqjxz.,\n", np.uint8)
    probs = 1.0 / np.arange(1, 31)
    probs /= probs.sum()
    zipf_docs = [letters[rng.choice(30, size=1 << 16, p=probs)].tobytes()
                 for _ in range(nmb >> 16)]
    corpora["zipf(synth)"] = ft.prepare_documents(zipf_docs)

    segs = [int(s) for s in args.segs.split(",")]
    tiers = args.tiers.split(",")
    marks = [int(m) for m in args.mark.split(",")]
    for name, prep in corpora.items():
        for tier in tiers:
            for seg in segs:
                for mp in marks:
                    probe(name, prep, seg, mp, tier)


if __name__ == "__main__":
    main()
