"""A configuration names its samples, its calling mode (through the CLI
arguments the program's own CLI turns into an engine) and its plain
reference: two samples through a whole run on the CPU, the pooled
caller built from a configuration, a reference found by name."""

import argparse
import json
import sys
import types

import pytest

from benchmark import check, drive, run, spec
from benchmark.gen import make_dataset
from benchmark.reference import caller

BENCH = spec.benchmark()
CFG = spec.config(BENCH, "dip30x-batched")
TWO = dict(CFG, sequencing=dict(CFG["sequencing"], samples=2, coverage=12))


def _run(capsys, tmp_path, cfg, seed=31, trace=0):
    """run.run of a cell of `cfg` on the isolated mix, three sites, on
    the CPU; (result, work directory)."""
    args = argparse.Namespace(workload="test.isolated", seed=seed,
                              seconds=8.0, trace=trace, cpu_rehearsal=3)
    cell = dict(name="test.isolated", config=cfg["name"],
                traffic="isolated", chips=1)
    traffic = dict(spec.traffic("isolated"), sites=3)
    rc = run.run(args, BENCH, cell, cfg, traffic, "cpu", True, tmp_path)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_two_samples_through_the_harness(capsys, tmp_path, monkeypatch):
    seen = {}
    real = check.numbers

    def numbers(passes, ref, *a):
        seen.update(passes=passes, ref=ref)
        return real(passes, ref, *a)
    monkeypatch.setattr(check, "numbers", numbers)
    out = _run(capsys, tmp_path, TWO)
    assert out["correct"], out
    data = tmp_path / "data"
    bams = [str(data / "sample0.bam"), str(data / "sample1.bam")]
    lines = open(data / "windows.txt").read().splitlines()
    chosen = {i: lines[i - 1] for i in seen["ref"]}
    both = caller.glf_rows(str(data / "sim.fa"), bams, chosen, {})
    assert both == seen["ref"]
    nums = check.numbers(seen["passes"], both)
    assert check.verdict(nums, CFG["limits"])[0]
    # the program read both BAMs: against one sample's reads it fails
    first = caller.glf_rows(str(data / "sim.fa"), bams[:1], chosen, {})
    assert not check.verdict(check.numbers(seen["passes"], first),
                             CFG["limits"])[0]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("two")
    return make_dataset(str(d), TWO["sequencing"],
                        dict(spec.traffic("isolated"), sites=3), 5)


def _cli(*extra, drop=("--doDiploid",)):
    return dict(CFG, cli=[a for a in CFG["cli"] if a not in drop]
                + list(extra))


def test_pooled_rows_through_the_clis_engine(two, tmp_path):
    eng = drive.build_engine(_cli("--doPooled"), two["fasta"], two["bams"],
                             two["bam_list"], "cpu")
    glf = tmp_path / "pooled.glf.txt"
    try:
        assert isinstance(eng.stats, drive.HarnessStats)
        eng.detect_indels(two["windows"], str(glf))
    finally:
        eng.close()
    rows = [r.split() for rs in check.read_glf(glf).values() for r in rs]
    col = {c: i for i, c in enumerate(check.COLUMNS)}
    ok = [r for r in rows if r[0] == "ok"]
    assert ok and all(r[col["analysis_type"]] == "singlevariant" for r in ok)
    # a row per BAM, the pool's haplotype frequencies on the first
    assert {r[col["indidx"]] for r in ok} == {"0", "1"}
    assert all(":" in r[col["hapfreqs"]] for r in ok
               if r[col["indidx"]] == "0")
    assert all(float(r[col["est_freq"]]) >= 0 for r in ok)


def test_flags_reach_the_engine(two):
    from dindel_tpu_torch.engine.batched import BatchedWindowEngine
    from dindel_tpu_torch.engine.window import WindowEngine
    eng = drive.build_engine(_cli("--doDiploid", "--batchWindows", "7"),
                             two["fasta"], two["bams"], two["bam_list"],
                             "cpu")
    try:
        assert type(eng) is BatchedWindowEngine
        assert eng.batch_windows == 7
        assert len(eng.bams) == 2
    finally:
        eng.close()
    one = drive.build_engine(
        dict(CFG, cli=["--analysis", "indels", "--doDiploid"]),
        two["fasta"], two["bams"][:1], two["bam_list"], "cpu")
    try:
        assert type(one) is WindowEngine and len(one.bams) == 1
    finally:
        one.close()
    # the engines construct as before once the harness has its engine
    again = BatchedWindowEngine([two["bams"][0]], two["fasta"],
                                eng.params, device="cpu")
    again.close()


def test_stage_procs_is_refused(two):
    with pytest.raises(ValueError, match="stageProcs"):
        drive.build_engine(_cli("--doDiploid", "--stageProcs", "2"),
                           two["fasta"], two["bams"], two["bam_list"], "cpu")


def test_the_configurations_reference_is_loaded(capsys, tmp_path,
                                                 monkeypatch):
    calls = []
    stub = types.ModuleType("benchmark.reference.stubref")

    def glf_rows(fasta, bams, window_lines, flags, device="cpu"):
        calls.append((bams, sorted(window_lines), flags, device))
        return caller.glf_rows(fasta, bams, window_lines, flags,
                               device=device)
    stub.glf_rows = glf_rows
    monkeypatch.setitem(sys.modules, "benchmark.reference.stubref", stub)
    assert spec.reference("stubref") is stub
    assert spec.reference("caller") is caller
    out = _run(capsys, tmp_path, dict(CFG, reference="stubref"))
    assert out["correct"], out
    assert len(calls) == 1
    bams, windows, flags, device = calls[0]
    assert bams == [str(tmp_path / "data" / "sim.bam")]
    assert windows and flags == {} and device == "cpu"


@pytest.mark.parametrize("name", ["no_such_reference", "../caller", "a.b"])
def test_a_missing_reference_is_a_spec_error(name):
    with pytest.raises(spec.SpecError):
        spec.reference(name)
