"""check.py's comparison of GLF rows."""

import math
import types

from benchmark import check
from benchmark.reference import caller

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


def _old_compare(prog, ref):
    """check.compare as it was before configurations named their value
    columns: the default has to give the same on every row."""
    keys = tuple(c for c in check.COLUMNS
                 if c not in check.COUNTS + check.VALUES + ("glf",))

    def glf(s):
        if s == "NA":
            return []
        return [part.partition(":")[::2] for part in s.split(",")]
    rows = sum(a != b for a, b in zip(prog, ref)) + abs(len(prog) - len(ref))
    if len(prog) != len(ref):
        return math.inf, rows, 0
    counts, gap = 0, 0.0
    for lp, lr in zip(prog, ref):
        p = dict(zip(check.COLUMNS, lp.split()))
        r = dict(zip(check.COLUMNS, lr.split()))
        gp, gr = glf(p.get("glf", "")), glf(r.get("glf", ""))
        if (len(p) != len(check.COLUMNS) or len(r) != len(check.COLUMNS)
                or any(p[c] != r[c] for c in keys)
                or [g for g, _ in gp] != [g for g, _ in gr]):
            gap = math.inf
            continue
        counts += any(p[c] != r[c] for c in check.COUNTS)
        for c in check.VALUES:
            gap = max(gap, check._gap(p[c], r[c]))
        for (_, vp), (_, vr) in zip(gp, gr):
            gap = max(gap, check._gap(vp, vr))
    return gap, rows, counts


MAP_ROW = ("ok 1 dip.map 1 7372 7491 7432 7432 1 NA -AC 33 NA 142.43 NA NA "
           "NA 0 50 NA NA 6 10 0 2 3 NA NA NA NA NA 0/1:142.43")
EDITS = [(c, v) for c in check.COLUMNS for v in (
    "NA", "0", "-66.5038", "1e-05", "3425", "0/0:-1,0/1:-2", "x")] + [
    ("glf", "0/0:-404.954,0/1:-87.2743"), ("glf", "NA"),
    ("glf", "0/0:-404.955,0/1:-87.2743,1/1:-66.5037"),
    ("glf", "0/0:-404.954;0/1:-87.2743;1/1:-66.5037")]


def test_the_default_compares_as_before():
    import random
    rng = random.Random(5)
    bases = [ROW, MAP_ROW]
    for base in bases:
        for col, val in EDITS:
            a = _set(base, col, val)
            for prog, ref in (([a], [base]), ([base], [a]), ([a, base],
                              [base, base]), ([a], [base, base])):
                assert check.compare(prog, ref) == _old_compare(prog, ref)
        for _ in range(2000):
            a, b = base, base
            for _ in range(rng.randint(1, 3)):
                col, val = rng.choice(EDITS)
                a = _set(a, col, val) if rng.random() < 0.5 else a
                b = _set(b, col, val) if rng.random() < 0.5 else b
            assert check.compare([a], [b]) == _old_compare([a], [b])
    assert check.compare([ROW + " extra"], [ROW]) == _old_compare(
        [ROW + " extra"], [ROW])


POOLED = ("ok 1 singlevariant 1 7372 7491 7432 7432 1 NA -AC 14 1 NA "
          "0.288642 -46.5975 REF:0.709512;7432,-AC:0.28864 0 50 NA NA 0 2 "
          "0 2 3 NA NA NA NA NA 0/0:-30.8264;0/1:-13.3362;1/1:-49.2457")


def test_value_columns_are_compared_by_their_gap():
    values = check.VALUES + ("est_freq",)
    near = _set(POOLED, "est_freq", "0.288643")
    g, d, c = check.compare([near], [POOLED], values)
    assert 0 < g < 1e-5 and (d, c) == (1, 0)
    # by default the column is text, as the diploid rows have it
    assert check.compare([near], [POOLED])[0] == math.inf
    assert check.compare([_set(POOLED, "est_freq", "NA")], [POOLED],
                         values)[0] == math.inf
    # a changed count fails the counts, not the values
    assert check.compare([_set(POOLED, "num_cover_forward", "3")], [POOLED],
                         values) == (0.0, 1, 1)
    # a column of several numbers is not parsed here: its text is compared
    far = _set(POOLED, "hapfreqs", "REF:0.709513;7432,-AC:0.288641")
    assert check.compare([far], [POOLED], values + ("hapfreqs",))[0] \
        == math.inf


def test_a_reference_brings_its_own_row_comparison():
    seen = []

    def compare_row(lp, lr, values):
        seen.append(values)
        return 0.5, lp != lr, False
    ref = types.SimpleNamespace(compare_row=compare_row)
    row = check.row_comparison(["est_freq"], ref)
    bad = _set(POOLED, "hapfreqs", "x")
    nums = check.numbers([{1: [bad]}], {1: [POOLED]}, row)
    assert (nums["value_gap"], nums["counts_differ"]) == (0.5, 1)
    assert seen == [("est_freq",)]
    line, = check.over_limit(nums, {"counts_differ": 0}, [{1: [bad]}],
                             {1: [POOLED]}, row=row)
    assert repr(bad) in line
    # a reference without one takes this module's
    assert check.row_comparison(check.VALUES, caller).func is check.compare_row


def test_over_limit_names_the_window_and_its_row_pair():
    bad = _set(ROW, "num_cover_forward", "14")
    far = ROW.replace("0/1:-87.2743", "0/1:-88.2743")
    ref = {1: [ROW], 2: [ROW, ROW], 3: [ROW]}
    passes = [{1: [ROW], 2: [ROW, bad], 3: [far]}, {1: [ROW], 2: [bad, ROW]}]
    nums = check.numbers(passes, ref)
    assert nums["counts_differ"] == 2 and nums["value_gap"] > 1e-3
    lines = check.over_limit(nums, {"value_gap": 1e-3, "counts_differ": 0},
                             passes, ref, {2: "1 3000 3100 3050,-AC"})
    assert len(lines) == 2
    assert lines[0].startswith("value_gap") and "window 3 " in lines[0]
    assert repr(far) in lines[0] and repr(ROW) in lines[0]
    assert lines[1].startswith("counts_differ 1 in window 2 [1 3000 3100 "
                               "3050,-AC], pass 0")
    assert repr(bad) in lines[1]
    assert check.over_limit(nums, {"value_gap": 1.0, "rows_differ": 5},
                            passes, ref) == []
    missing = check.numbers([{1: [], 2: [ROW, ROW], 3: [ROW]}], ref)
    line, = check.over_limit(missing, {"value_gap": 1e-3}, passes[:1] and
                             [{1: [], 2: [ROW, ROW], 3: [ROW]}], ref)
    assert "window 1 " in line and "program row None" in line


TIED_ROW = _set(ROW, "num_cover_reverse", "8") + (
    " #tied:nmmBQT=5-7;num_cover_reverse=8-9")


def test_a_count_in_the_references_tie_range_agrees():
    assert check.split_note(TIED_ROW) == (
        _set(ROW, "num_cover_reverse", "8"),
        {"nmmBQT": (5, 7), "num_cover_reverse": (8, 9)})
    assert check.split_note(ROW) == (ROW, {})
    inside = _set(ROW, "num_cover_reverse", "9")
    assert check.compare_window([inside], [TIED_ROW]) == (0.0, 1, 0, 1)
    assert check.compare_window([_set(ROW, "num_cover_reverse", "8")],
                                [TIED_ROW]) == (0.0, 0, 0, 0)
    for col, val in (("num_cover_reverse", "10"), ("num_cover_reverse", "7"),
                     ("num_cover_forward", "14"), ("nmmBQT", "8")):
        got = check.compare_window([_set(inside, col, val)], [TIED_ROW])
        assert got[2] == 1 and got[3] == 0, (col, val)
    nums = check.numbers([{1: [inside]}], {1: [TIED_ROW]})
    assert (nums["counts_differ"], nums["counts_tied"]) == (0, 1)
    assert check.behind([inside], [TIED_ROW], "counts_differ", 0) is None
