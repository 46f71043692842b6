"""check.py's comparison of GLF rows."""

import math

from benchmark import check

ROW = ("ok 1 dip 1 3272 3391 3332 3332 1 NA -AC 47 NA NA NA -66.5037 NA 0 50 "
       "1 1 15 15 0 15 15 3425 7 -3 0 0 0/0:-404.954,0/1:-87.2743,"
       "1/1:-66.5037")


def _set(row, col, val):
    parts = row.split()
    parts[check.COLUMNS.index(col)] = val
    return " ".join(parts)


def test_same_rows():
    assert check.compare([ROW], [ROW]) == (0.0, 0, 0)


def test_row_missing():
    assert check.compare([], [ROW]) == (math.inf, 1, 0)


def test_key_field():
    assert check.compare([_set(ROW, "nref_all", "-A")], [ROW])[:2] == (
        math.inf, 1)


def test_genotypes():
    row = ROW.replace("1/1:", "2/2:")
    assert check.compare([row], [ROW])[0] == math.inf


def test_counts():
    assert check.compare([_set(ROW, "num_cover_forward", "14")],
                         [ROW]) == (0.0, 1, 1)


def test_value_gap_is_relative():
    g, d, c = check.compare([_set(ROW, "logZ", "-66.5038")], [ROW])
    assert (d, c) == (1, 0)
    assert abs(g - 0.0001 / 66.5037) < 1e-12
    g, _, _ = check.compare([ROW.replace("0/1:-87.2743", "0/1:-87.2753")],
                            [ROW])
    assert abs(g - 0.001 / 87.2743) < 1e-12


def test_na_against_a_number():
    assert check.compare([_set(ROW, "logZ", "NA")], [ROW])[0] == math.inf


def test_numbers_cover_each_pass_up_to_its_last_window():
    ref = {1: [ROW], 2: [_set(ROW, "index", "2")]}
    full = {1: [ROW], 2: [_set(ROW, "index", "2")]}
    cut = {1: [ROW]}
    n = check.numbers([full, cut], ref)
    assert n["compared"] == 3 and n["value_gap"] == 0 and n["rows_differ"] == 0
    n = check.numbers([{1: [ROW], 3: []}], ref)
    assert n["value_gap"] == math.inf    # window 2 covered, not written


def test_sample_is_seeded_and_has_the_largest_window():
    passes = [{i: ["r"] * (3 if i == 7 else 1) for i in range(1, 21)}]
    a = check.sample(passes, 20, 5, 123)
    assert a[0] == 7 and len(set(a)) == 5
    assert a == check.sample(passes, 20, 5, 123)
    assert a != check.sample(passes, 20, 5, 2**33 + 5)


def test_verdict_takes_the_numbers_the_limits_name():
    nums = dict(value_gap=0.0, rows_differ=3, counts_differ=1, compared=0)
    assert not check.verdict(nums, {"value_gap": 0.0})[0]
    nums["compared"] = 1
    ok, rows = check.verdict(nums, {"value_gap": 0.0})
    assert ok and rows == [("value_gap", 0.0, 0.0)]
    assert not check.verdict(nums, {"rows_differ": 0})[0]
