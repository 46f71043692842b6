"""The generator: deterministic per seed, its mixes as the traffic files
say, and its window file what getCIGARindels and makeWindows make of its
BAM."""

import filecmp
import json
from collections import Counter

import numpy as np
import pytest

from benchmark import spec
from benchmark.gen import make_dataset
from benchmark.gen.sim import make_genome

SEQ = json.load(open(spec.HERE / "configs" / "dip30x-batched.json"))[
    "sequencing"]


def _traffic(name, sites):
    return dict(spec.traffic(name), sites=sites)


@pytest.mark.parametrize("seed", [7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_files(tmp_path, seed):
    a = make_dataset(str(tmp_path / "a"), SEQ, _traffic("isolated", 6), seed)
    b = make_dataset(str(tmp_path / "b"), SEQ, _traffic("isolated", 6), seed)
    for k in ("fasta", "bam", "windows"):
        assert filecmp.cmp(a[k], b[k], shallow=False)
    assert filecmp.cmp(a["bam"] + ".bai", b["bam"] + ".bai", shallow=False)
    c = make_dataset(str(tmp_path / "c"), SEQ, _traffic("isolated", 6),
                     seed + 1)
    assert not filecmp.cmp(a["bam"], c["bam"], shallow=False)


def _sites(name, n, seed=11):
    ref, _, _, sites = make_genome(SEQ, _traffic(name, n), seed)
    return ref, sites


def test_isolated_mix():
    ref, sites = _sites("isolated", 600)
    kinds = Counter()
    het = 0
    for s in sites:
        a = [x for x in s.alleles if x]
        assert len(set(a)) == 1
        v = a[0]
        kinds["AC" if v == "-AC" else "ins" if v[0] == "+" else "hp"] += 1
        het += len(a) == 1
        if v[0] == "-" and v != "-AC":
            b = v[1]
            assert set(v[1:]) == {b} and ref[s.pos + len(v) - 1] == ord(b)
    for k in ("AC", "ins", "hp"):
        assert 150 <= kinds[k] <= 250, kinds
    assert 0.5 <= het / len(sites) <= 0.7


def test_str_mix():
    ref, sites = _sites("str", 600)
    compound = sum(all(s.alleles) and s.alleles[0] != s.alleles[1]
                   for s in sites)
    assert 0.25 <= compound / len(sites) <= 0.42
    units = Counter()
    for s in sites:
        for v in s.alleles:
            if not v:
                continue
            tract = bytes(ref[s.pos:s.pos + 40])
            unit = tract[:1] if tract[1] == tract[0] else tract[:2]
            units[len(unit)] += 1
            body = v[1:].encode()
            assert body == unit * (len(body) // len(unit))
            assert 1 <= len(body) // len(unit) <= 2
    assert units[1] and units[2]


@pytest.mark.parametrize("name", ["isolated", "str"])
def test_left_normalised(name):
    ref, sites = _sites(name, 300)
    for s in sites:
        for v in s.alleles:
            if v:
                assert ref[s.pos - 1] != ord(v[-1])


@pytest.mark.parametrize("seed", [2024, 3000000001])
@pytest.mark.parametrize("name", ["isolated", "str"])
def test_windows_are_the_pipelines(tmp_path, name, seed):
    from dindel_tpu_torch import cli
    d = make_dataset(str(tmp_path), SEQ, _traffic(name, 40), seed)
    assert cli.main(["--analysis", "getCIGARindels", "--bamFile", d["bam"],
                     "--ref", d["fasta"], "--outputFile",
                     str(tmp_path / "cand")]) == 0
    assert cli.main(["--analysis", "makeWindows", "--inputVarFile",
                     str(tmp_path / "cand.variants.txt"),
                     "--windowFilePrefix", str(tmp_path / "win")]) == 0
    assert (tmp_path / "win.1.txt").read_text() == open(d["windows"]).read()


def test_reads_cover_the_contig_at_the_design_coverage(tmp_path):
    from dindel_tpu_torch.io.bam import BamReader
    d = make_dataset(str(tmp_path), SEQ, _traffic("isolated", 10), 5)
    recs = list(BamReader(d["bam"]))
    assert len(recs) == d["n_reads"]
    assert all(len(r.seq) == SEQ["read_len"] for r in recs)
    pos = np.array([r.pos for r in recs])
    assert (np.diff(pos) >= 0).all()
    cov = len(recs) * SEQ["read_len"] / d["ref_len"]
    assert abs(cov - SEQ["coverage"]) < 1
