"""The frozen bounds reproduce the C2 bounds of PERF.md from the shapes
alone (C2: synth_windows(4, 8, 768, H=160, L=100, seed=2), 24576
pairs)."""

import pytest

from benchmark import roofline

B, H_PAD, L_PAD, NUMT = 24576, 176, 112, 7
DP_BOUNDS = (100, 49, 47)          # (L_act, MB, MN) of the C2 data
WALKED = 2433024                   # finish's walked steps at C2
COLS, NR, NH = 2457600, 3072, 32   # pair_stats' read columns, tables


def test_k1_c2():
    ms, by, _ = roofline.dp_bound(B, H_PAD, L_PAD, NUMT, DP_BOUNDS)
    assert by == "bytes"
    assert ms == pytest.approx(0.1720, abs=5e-5)


def test_k2_c2():
    ms, by = roofline.finish_bound(B, 2 * (H_PAD + 2), L_PAD, WALKED, 4)
    assert by == "bytes"
    assert ms == pytest.approx(0.056437, abs=5e-7)


def test_k3_c2():
    ms, by = roofline.stats_bound(B, L_PAD, 4, NR, NH, H_PAD, COLS)
    assert by == "bytes"
    assert ms == pytest.approx(0.0049393, abs=5e-8)


def test_k4_c2():
    ms, by = roofline.window_bound(8, 8, 4, 768, 4 * 768, 4)
    assert by == "bytes"
    assert ms == pytest.approx(0.0000911, abs=5e-8)


def test_walked_steps_counts_both_walks():
    # anchor 3 of a 10-base read: 3 rows down, 6 up (to read_len - 2)
    assert roofline.walked_steps([3], [10], 16) == 3 + 6


def test_k1_per_pair_is_the_padded_count_without_padding():
    # every pair full length with one anchor: the padded rows are the
    # pairs' own
    n, b = 64, 40
    own = roofline.dp_pair_bound([H_PAD] * n, [L_PAD] * n, [b] * n, L_PAD,
                                 NUMT)
    padded = roofline.dp_bound(n, H_PAD, L_PAD, NUMT, (L_PAD, b, b))
    assert own == pytest.approx(padded)


def test_k1_per_pair_counts_each_pairs_own_lengths():
    # two pairs: 10 haplotype bases and 20 read bases, 30 and 5; the
    # anchors do not change the row steps (forward to it, backward from
    # the read's end down to it)
    _, _, steps = roofline.dp_pair_bound([10, 30], [20, 5], [3, 99], 112, 7)
    assert steps == 12 * 19 + 32 * 4
    short = roofline.dp_pair_bound([10], [20], [3], 112, 7)[0]
    assert short < roofline.dp_pair_bound([100], [20], [3], 112, 7)[0]


def test_k2_per_pair_is_the_padded_count_without_padding():
    n = 64
    bm, rl = [30] * n, [L_PAD] * n
    own = roofline.finish_pair_bound([H_PAD] * n, rl, bm, L_PAD, 4)
    steps = roofline.walked_steps(bm, rl, L_PAD)
    assert own == pytest.approx(roofline.finish_bound(
        n, 2 * (H_PAD + 2), L_PAD, steps, 4))
