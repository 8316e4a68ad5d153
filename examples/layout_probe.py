"""Offline layout simulator for the vseg serving tier (round 4).

Builds the BWT of small real/synthetic corpora on the host (numpy
oracle) and simulates candidate serving layouts exactly (bytes/char),
without building device indexes.  This is the measurement behind the
round-4 compression diet: the round-3 synthetic-zipf table hid that on
REAL text the per-segment occ checkpoint row (uint16 x K) and the code
area dominate.

Usage: python examples/layout_probe.py [--mb 2.0]
"""
import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from femto_tpu.suffix import suffix_array_np  # noqa: E402
from femto_tpu.io.corpus import iter_files    # noqa: E402


def log(*a):
    print(*a, flush=True)


def read_text_corpus(paths, exts, max_bytes):
    bufs, total = [], 0
    for f in iter_files(paths):
        if exts and not f.endswith(exts):
            continue
        try:
            b = open(f, "rb").read()
        except OSError:
            continue
        # text files only: reject if >5% high-bit/control bytes
        arr = np.frombuffer(b, np.uint8)
        if arr.size == 0:
            continue
        bad = ((arr > 126) | ((arr < 9) & (arr != 0)) |
               ((arr > 13) & (arr < 32))).mean()
        if bad > 0.05:
            continue
        bufs.append(b)
        total += len(b)
        if total >= max_bytes:
            break
    return np.frombuffer(b"".join(bufs)[:max_bytes], np.uint8)


def seg_stats(bwt, S):
    n = bwt.shape[0]
    n_seg = n // S
    rows = np.sort(bwt[: n_seg * S].reshape(n_seg, S), axis=1)
    uniq = np.concatenate(
        [np.ones((n_seg, 1), bool), rows[:, 1:] != rows[:, :-1]], axis=1)
    return uniq.sum(axis=1)  # nsym per segment


def run_stats(bwt):
    runs = np.flatnonzero(np.diff(bwt.astype(np.int16))).size + 1
    return bwt.size / runs


def W_of(S, w):
    return -(-S // (32 // w))


def simulate(name, bwt, K, ndocs, S, mark_p=20):
    n = bwt.shape[0]
    nsym = seg_stats(bwt, S)
    n_seg = nsym.shape[0]
    SMAX = 32
    wide = K > 256
    w_side = 9 if wide else 8
    Wside = W_of(S, w_side)
    sym_b = 2 if wide else 1

    pct = np.percentile(nsym, [10, 50, 90, 99])
    mean_run = run_stats(bwt)

    # marks: bitmap (S/8 per seg) + current int32 vals vs packed vals
    bm = 0.125
    mv32 = 4.0 / mark_p
    bits_packed = int(np.ceil(np.log2(max(n // mark_p + 2 * ndocs + 2, 2))))
    mv_packed = bits_packed / 8.0 / mark_p
    l1 = 4.0 * K / (16 * S)
    mck = 4.0 / S

    # current single-width scheme (rel row in-band: ceil(K/2) u32 words)
    relw = -(-K // 2) * 4
    best_cur = None
    for w in (1, 2, 3, 4, 5):
        w_eff = 32 // (-(-S // W_of(S, w)))
        cov = (nsym <= (1 << w_eff)) & (nsym <= SMAX)
        bytes_w = (n_seg * (W_of(S, w_eff) * 4 + SMAX * sym_b + S // 8
                            + 4 + relw)
                   + int((~cov).sum()) * Wside * 4)
        if best_cur is None or bytes_w < best_cur[0]:
            best_cur = (bytes_w, w_eff, float((~cov).mean()))
    cur = best_cur[0] / n + bm + mv32 + l1 + mck

    # diet 1: right-sized symbol list (min(2^w, SMAX) entries) + packed
    # mark vals
    best_d1 = None
    for w in (1, 2, 3, 4, 5):
        w_eff = 32 // (-(-S // W_of(S, w)))
        s_store = -(-min(1 << w_eff, SMAX) // 4) * 4
        cov = (nsym <= (1 << w_eff)) & (nsym <= SMAX)
        bytes_w = (n_seg * (W_of(S, w_eff) * 4 + s_store * sym_b + S // 8
                            + 4 + relw)
                   + int((~cov).sum()) * Wside * 4)
        if best_d1 is None or bytes_w < best_d1[0]:
            best_d1 = (bytes_w, w_eff, float((~cov).mean()))
    d1 = best_d1[0] / n + bm + mv_packed + l1 + mck

    # diet 2: d1 + TWO width classes (separate main tables) + side
    best_d2 = None
    for w1 in (1, 2, 3, 4):
        for w2 in range(w1 + 1, 6):
            we1 = 32 // (-(-S // W_of(S, w1)))
            we2 = 32 // (-(-S // W_of(S, w2)))
            if we1 == we2:
                continue
            f1 = (nsym <= (1 << we1))
            f2 = (nsym <= (1 << we2)) & (nsym <= SMAX)
            in1 = f1
            in2 = f2 & ~f1
            ovf = ~(f1 | f2)
            s1 = -(-min(1 << we1, SMAX) // 4) * 4
            s2 = -(-min(1 << we2, SMAX) // 4) * 4
            fixed = S // 8 + 4 + relw
            bytes_w = (int(in1.sum()) * (W_of(S, we1) * 4 + s1 * sym_b
                                         + fixed)
                       + int(in2.sum()) * (W_of(S, we2) * 4 + s2 * sym_b
                                           + fixed)
                       + int(ovf.sum()) * (Wside * 4 + fixed))
            if best_d2 is None or bytes_w < best_d2[0]:
                best_d2 = (bytes_w, (we1, we2), float(ovf.mean()),
                           float(in1.mean()))
    d2 = best_d2[0] / n + bm + mv_packed + l1 + mck

    # diet 4: RLE-slot main rows.  Each slot is one u8/u16:
    # (local_sym << lenbits) | (len - 1); runs longer than 2^lenbits
    # split.  Segments whose (split-adjusted) run count exceeds R_cap go
    # to the side table.  rank(c, off) = sum over slots of
    # (sym==c) * clamp(off - start, 0, len) — same one-row-gather serving
    # shape as the width rows, pure VPU decode.
    starts = np.arange(0, n_seg * S, S)
    seg_of = np.minimum(np.arange(n)[: n_seg * S] // S, n_seg - 1)
    # per-segment run counts (runs break at segment boundaries)
    b = bwt[: n_seg * S]
    brk = np.ones(n_seg * S, bool)
    brk[1:] = (b[1:] != b[:-1])
    brk[starts] = True
    runs_per_seg = np.bincount(seg_of[brk], minlength=n_seg)
    run_lens = np.diff(np.flatnonzero(np.concatenate([brk, [True]])))
    d4 = {}
    for slot_bits in (8, 16):
        best = None
        for w in (2, 3, 4, 5):
            if (1 << w) > SMAX:
                continue
            lenbits = slot_bits - w
            if lenbits < 2:
                continue
            # split-adjusted run count per segment
            splits = np.maximum(
                -(-run_lens // (1 << lenbits)) - 1, 0)
            seg_of_run = seg_of[np.flatnonzero(brk)]
            extra = np.bincount(seg_of_run, weights=splits,
                                minlength=n_seg)
            slots = runs_per_seg + extra.astype(np.int64)
            fits_alpha = nsym <= min(1 << w, SMAX)
            for R_cap in (64, 96, 128, 192, 256, 384, 512, 768, 1024):
                if R_cap > S:
                    continue
                cov = fits_alpha & (slots <= R_cap)
                s_store = -(-min(1 << w, SMAX) // 4) * 4
                bytes_w = (n_seg * (R_cap * (slot_bits // 8)
                                    + s_store * sym_b + S // 8 + 4 + relw)
                           + int((~cov).sum()) * Wside * 4)
                if best is None or bytes_w < best[0]:
                    best = (bytes_w, w, R_cap, float((~cov).mean()))
        if best:
            d4[slot_bits] = (best[0] / n + bm + mv_packed + l1 + mck,
                             best[1], best[2], best[3])

    # diet 5: THREE classes — RLE u8-slot rows (runs <= R_cap, nsym <=
    # 2^w), fixed-width rows at w2 (nsym <= min(2^w2, SMAX)), and the
    # global-code side table.  Both main classes carry the same in-row
    # tail (syms + marks + mck + rel).
    d5 = None
    for w in (2, 3, 4, 5):
        lenbits = 8 - w
        splits = np.maximum(-(-run_lens // (1 << lenbits)) - 1, 0)
        seg_of_run = seg_of[np.flatnonzero(brk)]
        extra = np.bincount(seg_of_run, weights=splits, minlength=n_seg)
        slots = runs_per_seg + extra.astype(np.int64)
        fits_alpha = nsym <= min(1 << w, SMAX)
        for w2 in (4, 5):
            we2 = 32 // (-(-S // W_of(S, w2)))
            f2 = nsym <= min(1 << we2, SMAX)
            for R_cap in (64, 96, 128, 192, 256, 384, 512, 768, 1024):
                if R_cap > S:
                    continue
                c_rle = fits_alpha & (slots <= R_cap)
                c_w = f2 & ~c_rle
                ovf = ~(c_rle | f2)
                s1 = -(-min(1 << w, SMAX) // 4) * 4
                s2 = -(-min(1 << we2, SMAX) // 4) * 4
                fixed = S // 8 + 4 + relw
                bytes_w = (int(c_rle.sum()) * (-(-R_cap // 4) * 4
                                               + s1 * sym_b + fixed)
                           + int(c_w.sum()) * (W_of(S, we2) * 4
                                               + s2 * sym_b + fixed)
                           + int(ovf.sum()) * (Wside * 4 + fixed))
                tot = bytes_w / n + bm + mv_packed + l1 + mck
                if d5 is None or tot < d5[0]:
                    d5 = (tot, w, we2, R_cap, float(c_rle.mean()),
                          float(ovf.mean()))
    log(f"{'':>14}   d5(rle+w+side)={d5[0]:.3f} (w_rle={d5[1]}, "
        f"w2={d5[2]}, R={d5[3]}, rle={d5[4]:.2f}, ovf={d5[5]:.2f}) "
        f"[marks: bm={bm:.3f} mv={mv_packed:.3f}]")

    # diet 6: UNIFORM-ROW multi-mode ("vrle" candidate): one main table,
    # code area = A bytes per row; per-segment mode = cheapest exact
    # encoding that fits A: RLE u8 slots at the segment's own width
    # w_s = ceil(log2 nsym) (len field 8-w_s bits, long runs split), or
    # fixed-width w_s-bit codes, else side table.  One gather serves all.
    seg_of_run = seg_of[np.flatnonzero(brk)]
    w_seg = np.maximum(np.ceil(np.log2(np.maximum(nsym, 2))), 1).astype(int)
    # per-segment RLE slot count at that segment's width
    slots_at = np.zeros(n_seg, np.int64)
    for ws in range(1, 7):
        lenbits = 8 - ws
        splits = np.maximum(-(-run_lens // (1 << lenbits)) - 1, 0)
        extra = np.bincount(seg_of_run, weights=splits, minlength=n_seg)
        sl = runs_per_seg + extra.astype(np.int64)
        slots_at = np.where(w_seg == ws, sl, slots_at)
    for SM in (32, 64):
        ok_alpha = nsym <= SM
        d6 = None
        for A in (64, 96, 128, 192, 256, 320, 384, 448, 512, 640, 768,
                  896, 1024, 1280):
            if A > 2 * S:
                continue
            rle_fit = ok_alpha & (slots_at <= A) & (w_seg <= 6)
            wfit = ok_alpha & (-(-S * w_seg // 8) <= A) & (w_seg <= 6)
            cov = rle_fit | wfit
            s_store = SM  # u8 syms
            bytes_w = (n_seg * (A + s_store * sym_b + S // 8 + 4 + relw)
                       + int((~cov).sum()) * Wside * 4)
            tot = bytes_w / n + bm + mv_packed + l1 + mck
            if d6 is None or tot < d6[0]:
                d6 = (tot, A, float(rle_fit.mean()),
                      float((wfit & ~rle_fit).mean()), float((~cov).mean()))
        log(f"{'':>14}   d6(uni SMAX={SM})={d6[0]:.3f} (A={d6[1]}, "
            f"rle={d6[2]:.2f}, w={d6[3]:.2f}, ovf={d6[4]:.2f})")

    # diet 7: vrle as implemented (u8 RLE at per-seg width | W(w_main) |
    # side) PLUS a u16 slot mode (sym 6b | len 10b — no practical
    # splitting) as a 4th per-segment encoding.  Uniform code area A.
    w_seg7 = np.maximum(np.ceil(np.log2(np.maximum(nsym, 2))), 1).astype(int)
    rle8 = np.zeros(n_seg, np.int64)
    for ws in range(1, 7):
        lenbits = 8 - ws
        splits = np.maximum(-(-run_lens // ((1 << lenbits) - 1)) - 1, 0)
        extra = np.bincount(seg_of_run, weights=splits, minlength=n_seg)
        rle8 = np.where(w_seg7 == ws, runs_per_seg + extra.astype(np.int64),
                        rle8)
    SM7 = 64  # vrle symbol-list capacity
    rle8_bytes = np.where(nsym <= SM7, rle8, 1 << 30)
    rle16_bytes = np.where(nsym <= SM7, runs_per_seg * 2, 1 << 30)
    d7 = {}
    for use16 in (False, True):
        best = None
        for w_eff, Wm in [(32 // (-(-S // W_of(S, w))), W_of(S, w))
                          for w in (1, 2, 3, 4, 5)]:
            wbytes = np.where(nsym <= (1 << w_eff), Wm * 4, 1 << 30)
            per_seg_best = np.minimum(rle8_bytes, wbytes)
            if use16:
                per_seg_best = np.minimum(per_seg_best, rle16_bytes)
            for q in (50, 60, 70, 80, 90, 95, 99, 100):
                A = int(-(-np.percentile(per_seg_best[
                    per_seg_best < (1 << 30)], q) // 4) * 4) \
                    if (per_seg_best < (1 << 30)).any() else Wm * 4
                A = max(A, 4)
                cov = per_seg_best <= A
                s_store = SM7
                bytes_w = (n_seg * (A + s_store * sym_b + S // 8 + 4 + relw)
                           + int((~cov).sum()) * Wside * 4)
                tot = bytes_w / n + mv_packed + l1 + mck
                if best is None or tot < best[0]:
                    best = (tot, w_eff, A, float((~cov).mean()))
        d7[use16] = best
    log(f"{'':>14}   d7(vrle)={d7[False][0]:.3f} (w={d7[False][1]}, "
        f"A={d7[False][2]}B, ovf={d7[False][3]:.2f}) | "
        f"d7+u16={d7[True][0]:.3f} (w={d7[True][1]}, A={d7[True][2]}B, "
        f"ovf={d7[True][3]:.2f})")

    # diet 3: d1 + sparse rel checkpoints: a FULL uint16 rel row only on
    # every A-th segment (anchor); others rebuild from the anchor plus the
    # per-segment in-row symbol counts of the <A intermediate rows (which
    # a rank gathers anyway in a halo batch).  Non-anchor rows instead
    # carry u16 counts for their OWN local symbols (s_store entries).
    d3 = {}
    for A in (2, 4):
        best_d3 = None
        for w in (1, 2, 3, 4, 5):
            w_eff = 32 // (-(-S // W_of(S, w)))
            s_store = -(-min(1 << w_eff, SMAX) // 4) * 4
            cov = (nsym <= (1 << w_eff)) & (nsym <= SMAX)
            n_anchor = -(-n_seg // A)
            bytes_w = (n_seg * (W_of(S, w_eff) * 4 + s_store * sym_b
                                + S // 8 + 4 + s_store * 2)
                       + n_anchor * relw
                       + int((~cov).sum()) * Wside * 4)
            if best_d3 is None or bytes_w < best_d3[0]:
                best_d3 = (bytes_w, w_eff, float((~cov).mean()))
        d3[A] = best_d3[0] / n + bm + mv_packed + l1 / A + mck

    log(f"{name:>14} S={S:<5} K={K:<3} nsym p10/50/90/99="
        f"{pct[0]:.0f}/{pct[1]:.0f}/{pct[2]:.0f}/{pct[3]:.0f} "
        f"run={mean_run:.2f}")
    log(f"{'':>14}   cur={cur:.3f} (w={best_cur[1]}, ovf="
        f"{best_cur[2]:.2f}) | d1(sym+mv)={d1:.3f} (w={best_d1[1]}, "
        f"ovf={best_d1[2]:.2f}) | d2(2cls)={d2:.3f} (w={best_d2[1]}, "
        f"ovf={best_d2[2]:.2f}, c1={best_d2[3]:.2f}) | "
        f"d3(relA2)={d3[2]:.3f} d3(relA4)={d3[4]:.3f}")
    for sb, (tot, w, rc, ovf) in d4.items():
        log(f"{'':>14}   d4(rle u{sb})={tot:.3f} (w={w}, R={rc}, "
            f"ovf={ovf:.2f})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=2.0)
    args = ap.parse_args()
    nb = int(args.mb * (1 << 20))

    corpora = {}
    corpora["ref-src(text)"] = read_text_corpus(
        ["/root/reference/src"], (".c", ".h", ".cc", ".hh", ".txt",
                                  ".chpl", ".l", ".y"), nb)
    corpora["repo(py+md)"] = read_text_corpus(
        [os.path.join(REPO, "femto_tpu"), os.path.join(REPO, "tests")],
        (".py", ".md"), nb)
    prose = read_text_corpus(
        ["/usr/lib/python3.11", "/usr/lib/python3"],
        (".txt", ".rst", ".md"), nb)
    if prose.size < nb // 4:
        # fall back: pydoc topics are genuine English prose
        import pydoc_data.topics as t
        buf = ("\n".join(t.topics.values())).encode()[:nb]
        prose = np.frombuffer(buf, np.uint8)
    corpora["english(prose)"] = prose

    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    corpora["dna(synth)"] = acgt[rng.integers(0, 4, size=nb)]
    letters = np.frombuffer(b"etaoin shrdlucmfwypvbgkqjxz.,\n", np.uint8)
    probs = 1.0 / np.arange(1, 31)
    probs /= probs.sum()
    corpora["zipf(synth)"] = letters[rng.choice(30, size=nb, p=probs)]

    for name, text in corpora.items():
        if text.size < 1 << 16:
            log(f"{name}: too small ({text.size}), skipped")
            continue
        log(f"--- {name}: {text.size/1e6:.2f}M chars, building SA...")
        sa = suffix_array_np(text)
        prev = np.where(sa == 0, text.size - 1, sa - 1)
        bwt = text[prev]
        K = int(np.unique(text).size) + 3  # ~specials of a real build
        ndocs = max(text.size // 65536, 1)
        for S in (512, 1024, 2048):
            simulate(name, bwt, K, ndocs, S)


if __name__ == "__main__":
    main()
