"""A count that a tie decides: on seed 2147483951 of the batched cell,
window 203's `R=>G` row counts 9 reverse reads covering the SNP in every
path of the program (float32 slabs and the float64 streaming engine
alike) and 8 in the plain reference.  Two reads have the same likelihood
on the called pair's two haplotypes in exact arithmetic; the reference's
float64 (one ulp apart, as the compiled C++ pair-HMM computes them) and
the program's (equal) decide the diploid caller's per-read choice, and
the haplotypes place the reads differently.  The reference's row carries
the range its tied reads leave each count, and the program's count lies
in it.  Full size: the genome of that seed is made whole."""

import json

import pytest

from benchmark import check, drive, spec
from benchmark.gen import make_dataset
from benchmark.reference import caller

SEED, WINDOW = 2147483951, 203
CFG = spec.config(spec.benchmark(), "dip30x-batched")


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    d = tmp_path_factory.mktemp("ties")
    data = make_dataset(str(d / "data"), CFG["sequencing"],
                        spec.traffic("isolated"), SEED)
    line = open(data["windows"]).read().splitlines()[WINDOW - 1]
    (d / "w.txt").write_text(line + "\n")
    return data, line, d


def _program_rows(data, d, cli):
    eng = drive.build_engine(dict(CFG, cli=cli), data["fasta"], data["bams"],
                             data["bam_list"], "cpu")
    out = d / f"prog{len(cli)}.glf.txt"
    try:
        eng.detect_indels(str(d / "w.txt"), str(out))
    finally:
        eng.close()
    # the one-line window file numbers the window 1
    return [r.replace(" 1 ", f" {WINDOW} ", 1)
            for r in check.read_glf(out)[1]]


def test_the_reference_row_carries_the_tie_range(window):
    data, line, _ = window
    ref = caller.glf_rows(data["fasta"], data["bams"], {WINDOW: line}, {})
    row, = [r for r in ref[WINDOW] if " R=>G " in r and " 1017434 " in r]
    text, ranges = check.split_note(row)
    assert dict(zip(check.COLUMNS, text.split()))["num_cover_reverse"] == "8"
    assert ranges["num_cover_reverse"] == (8, 9)


@pytest.mark.parametrize("cli", [
    CFG["cli"], ["--analysis", "indels", "--doDiploid"]], ids=json.dumps)
def test_the_programs_count_lies_in_the_range(window, cli):
    data, line, d = window
    ref = caller.glf_rows(data["fasta"], data["bams"], {WINDOW: line}, {})
    prog = _program_rows(data, d, cli)
    row, = [r for r in prog if " R=>G " in r and " 1017434 " in r]
    assert dict(zip(check.COLUMNS, row.split()))["num_cover_reverse"] == "9"
    gap, _, counts, tied = check.compare_window(prog, ref[WINDOW])
    assert (counts, tied) == (0, 1) and gap < CFG["limits"]["value_gap"]


def test_the_tie_readings_of_a_window():
    import numpy as np
    from benchmark import ties
    # four reads at the pair (0, 1): an exact tie the program rounds the
    # other way, a read 2e-5 apart, one 0.5 apart, and one whose choice
    # moves no count
    ref_ll = np.array([[-3.0, -2.0, -4.0, -7.0],
                       [-3.0, -2.00004, -6.0, -1.0]])
    prog_ll = ref_ll.copy()
    prog_ll[1, 0] += 1e-6
    prog_ll[0, 1] -= 1e-8
    relevant = np.array([True, True, True, False])
    got = ties.readings({5: (ref_ll, [(0, 1, relevant)])}, {5: prog_ll})
    flip, = got["flips"]
    assert (flip["window"], flip["read"], flip["gap"]) == (5, 0, 0.0)
    assert got["drift"] == pytest.approx(1e-6 / 3)
    assert got["tie_moved"] == pytest.approx(1e-6 / 3)
    (gap, moved), = got["near"]
    assert gap == pytest.approx(4e-5 / 2.00004)
    assert moved == pytest.approx(1e-8 / 2.00004)
    assert got["fault_gap"] == gap
    assert dict(zip(ties.WIDTHS, got["ranged"]))[1e-5] == 1
    assert got["rows"] == 1 and got["windows_unmatched"] == 0
    assert ties.readings({5: (ref_ll, [])}, {})["windows_unmatched"] == 1
