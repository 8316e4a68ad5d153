"""chip_smoke.py on the CPU: its phases at a tiny corpus size, its refusal
to run without a GPU, and the exactness of the build primitives it times
(seg_hist, map_codes, the alphabet histogram) against numpy."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import naive_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

MB = 0.125
N_PATS = 256


@pytest.fixture(scope="module")
def smoke():
    clock = cs.CompileClock()
    times = {}
    corpus = cs.Corpus(MB, 0)
    indexes = cs.phase_build(corpus, clock, times)
    pats = corpus.patterns(np.random.default_rng(1), N_PATS, N_PATS // 8)
    counts = cs.phase_count(corpus, indexes, pats, clock, times)
    return corpus, indexes, pats, counts, clock, times


def test_corpus_oracle_matches_naive_count():
    corpus = cs.Corpus(MB, 3)
    pats = corpus.patterns(np.random.default_rng(2), 200, 20)
    pats += list(cs.NEEDLES) + [b"e", b"NEEDLE"]
    for p in pats:
        assert corpus.count(p) == naive_count(corpus.docs, p), p
    assert len(corpus.docs) >= 8
    a, b, c = cs.NEEDLES
    assert corpus.docs_with(a) & corpus.docs_with(b)
    assert corpus.docs_with(b) & corpus.docs_with(c)
    # seeded: the same seed gives the same corpus
    assert cs.Corpus(MB, 3).docs == corpus.docs


def test_build_and_count(smoke):
    corpus, indexes, pats, counts, _, times = smoke
    assert set(indexes) == {"packed", "vrle"}
    assert any(k.startswith("build[vrle") for k in times)
    assert (counts > 0).sum() >= N_PATS - N_PATS // 8
    assert (counts == 0).sum() >= N_PATS // 8


def test_queries_phase(smoke):
    corpus, indexes, pats, counts, clock, times = smoke
    cs.phase_queries(corpus, indexes, pats, counts, clock, times)
    assert "boolean[vrle]" in times


def test_server_phase(smoke):
    corpus, indexes, pats, counts, clock, times = smoke
    cs.phase_server(corpus, indexes["packed"], pats, counts, clock, times)


def test_paged_phase(smoke):
    corpus, indexes, pats, counts, clock, times = smoke
    cs.phase_paged(corpus, indexes["vrle"], pats, counts, clock, times)


def test_primitives_phase(smoke):
    corpus, _, _, _, clock, times = smoke
    rows = cs.phase_primitives(corpus, clock, times)
    assert len(rows) == 4


def test_check_catches_a_wrong_count(smoke):
    corpus, _, pats, counts, _, _ = smoke
    bad = counts.copy()
    bad[0] += 1
    with pytest.raises(cs.SmokeFailure):
        cs.check_counts(corpus, pats, bad, "mutated")


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                        "--mb", "0.01"], capture_output=True, text=True,
                       env=env, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert "'cpu'" in r.stderr
    assert '"ok"' not in r.stdout
    assert r.stdout.splitlines()[0].startswith("card: ")


def test_result_line_keys():
    line = json.loads(cs.result_line(jax.devices()[:1]))
    assert line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == 1
    assert line["device"]["platform"] == jax.devices()[0].platform


@pytest.mark.parametrize("seg", [256, 2048])
@pytest.mark.parametrize("alpha", [261, 512])
def test_build_primitives_exact(seg, alpha):
    """seg_hist and map_codes equal numpy at the tiers' segment widths and
    both alphabet widths; -1 pads and symbols >= alpha count nothing."""
    from femto_tpu.ops.build_ops import map_codes, seg_hist

    rng = np.random.default_rng(seg + alpha)
    n_seg = 24
    codes = rng.integers(0, alpha, size=(n_seg, seg)).astype(np.int32)
    codes[0, :7] = -1                          # pads
    codes[1, :5] = alpha                       # out of range
    codes[2] = 17                              # one symbol fills a segment
    got = np.asarray(seg_hist(jnp.asarray(codes), alpha))
    want = np.zeros((n_seg, alpha), np.int64)
    for s in range(n_seg):
        row = codes[s]
        want[s] = np.bincount(row[(row >= 0) & (row < alpha)],
                              minlength=alpha)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)

    used = np.sort(rng.choice(alpha, size=min(alpha, 97), replace=False))
    x = rng.choice(used, size=seg * 8).astype(np.int32)
    x[:3] = 511                                # INVALID_ALPHA: past all used
    got = np.asarray(map_codes(jnp.asarray(x), jnp.asarray(used, np.int32)))
    np.testing.assert_array_equal(got, np.searchsorted(used, x))


def test_alpha_hist_exact():
    from femto_tpu.suffix import _alpha_hist

    rng = np.random.default_rng(9)
    text = rng.integers(1, 512, size=100_003).astype(np.int32)
    got = np.asarray(_alpha_hist(jnp.asarray(text), n=text.size))
    np.testing.assert_array_equal(got, np.bincount(text, minlength=512))


def test_replaced_forms_agree_with_plain():
    """The formulations the smoke times the primitives against compute the
    same integers (so its timing compares like with like)."""
    from femto_tpu.ops.build_ops import map_codes, seg_hist

    rng = np.random.default_rng(4)
    c2 = jnp.asarray(rng.integers(-1, 261, size=(40, 256)).astype(np.int32))
    np.testing.assert_array_equal(np.asarray(cs.onehot_seg_hist(c2, 261)),
                                  np.asarray(seg_hist(c2, 261)))
    t = jnp.asarray(rng.integers(1, 300, size=5000).astype(np.int32))
    np.testing.assert_array_equal(np.asarray(cs.onehot_alpha_hist(t)),
                                  np.bincount(np.asarray(t), minlength=512))
    used = jnp.asarray(np.unique(np.asarray(t)))
    np.testing.assert_array_equal(np.asarray(cs.compare_map_codes(t, used)),
                                  np.asarray(map_codes(t, used)))
