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


# sha256 (first 32 hex digits) of the files make_dataset wrote for one
# sample before designs could have several: the same seed has to give
# the same bytes
ONE_SAMPLE = {
    ("isolated", 7): ("3f3df6428db774ae48446e834c3bcd1c",
                      "3315c67f3ab0b7caae43a0523334aacb",
                      "5074a32a0e753d2bff391bba7b97d5e7",
                      "827f488f824c0ed51bb8e52a16ade62d"),
    ("isolated", 2147483951): ("0f349a9f5b32471a22e104bbd41458a9",
                               "bcb19da57b77d26219c0a738212c5797",
                               "1c0ce6ade822f7c205167521ae2f1121",
                               "67c21575af5ba82489dd41cc3204f777"),
    ("str", 7): ("af5191bf5a3fdc0decfa6b3c87288d7d",
                 "84c4020afadc606c19a2155ab17f5ec7",
                 "499b2bb8a521a329caca93cac19951bb",
                 "a6ad931730edf853e17f990da75a8877"),
    ("str", 2147483951): ("d69f72a166e8372e35f38a192bbb2f33",
                          "22a394315f693010cd2a0256b9bd10d2",
                          "da0aa5d7fcd56096f6fa79f91f1e4848",
                          "232abf622e5388f27098a97e8d2b6dbf"),
}


@pytest.mark.parametrize("name,seed", sorted(ONE_SAMPLE))
def test_one_sample_files_are_unchanged(tmp_path, name, seed):
    import hashlib
    d = make_dataset(str(tmp_path), SEQ, _traffic(name, 20), seed)
    files = (d["fasta"], d["bam"], d["bam"] + ".bai", d["windows"])
    got = tuple(hashlib.sha256(open(f, "rb").read()).hexdigest()[:32]
                for f in files)
    assert got == ONE_SAMPLE[(name, seed)]
    assert d["bams"] == [d["bam"]]
    assert open(d["bam_list"]).read() == d["bam"] + "\n"


TWO = dict(SEQ, samples=2, coverage=12)


def _header_text(path):
    from dindel_tpu_torch.io.bam import BamReader
    r = BamReader(path)
    try:
        return r.header.text
    finally:
        r.close()


@pytest.mark.parametrize("name", ["isolated", "str"])
def test_two_samples_and_the_pipelines_windows(tmp_path, name):
    """Two BAMs, each its own sample and read group, listed in bams.txt;
    the window file is what getCIGARindels over the list and makeWindows
    make of them."""
    from dindel_tpu_torch import cli
    from dindel_tpu_torch.io.bam import BamReader
    d = make_dataset(str(tmp_path), TWO, _traffic(name, 30), 2024)
    assert len(d["bams"]) == 2
    assert open(d["bam_list"]).read().split() == d["bams"]
    names = set()
    for k, b in enumerate(d["bams"]):
        text = _header_text(b)
        assert f"ID:rg{k + 1}\tLB:lib{k + 1}\tSM:SAMPLE{k}" in text
        recs = list(BamReader(b))
        assert abs(len(recs) * SEQ["read_len"] / d["ref_len"] - 12) < 1
        mine = {r.qname for r in recs}
        assert not mine & names       # no read name in two samples
        names |= mine
    assert len(names) * 2 == d["n_reads"]
    out = tmp_path / "cand.txt"
    assert cli.main(["--analysis", "getCIGARindels", "--bamFiles",
                     d["bam_list"], "--ref", d["fasta"], "--region",
                     f"0-{d['ref_len']}", "--tid", "1", "--outputFile",
                     str(out)]) == 0
    assert cli.main(["--analysis", "makeWindows", "--inputVarFile", str(out),
                     "--windowFilePrefix", str(tmp_path / "win")]) == 0
    assert (tmp_path / "win.1.txt").read_text() == open(d["windows"]).read()
    # the second sample's reads add candidates the first's lack (their
    # own sequencing errors inside insertions), or at least as many
    one = make_dataset(str(tmp_path / "one"), dict(TWO, samples=1),
                       _traffic(name, 30), 2024)
    assert d["n_windows"] >= one["n_windows"]


def test_sample_zero_is_the_one_sample_design(tmp_path):
    a = make_dataset(str(tmp_path / "a"), dict(SEQ, coverage=12),
                     _traffic("isolated", 8), 99)
    b = make_dataset(str(tmp_path / "b"), TWO, _traffic("isolated", 8), 99)
    assert filecmp.cmp(a["fasta"], b["fasta"], shallow=False)
    from dindel_tpu_torch.io.bam import BamReader
    def recs(path):
        return [(r.qname, r.pos, r.flag, r.seq, r.cigar)
                for r in BamReader(path)]
    assert recs(a["bam"]) == recs(b["bams"][0])


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_other_samples_draw_their_own_genotypes(seed):
    from benchmark.gen.sim import sample_sites
    traffic = _traffic("str", 300)
    _, _, _, sites = make_genome(SEQ, traffic, seed)
    samples = sample_sites(sites, traffic, 3, seed)
    assert samples[0] is sites
    for s in samples[1:]:
        assert [x.pos for x in s] == [x.pos for x in sites]
        het = sum(bool(a) != bool(b) for a, b in (x.alleles for x in s))
        compound = sum(all(x.alleles) and x.alleles[0] != x.alleles[1]
                       for x in s)
        het0 = sum(bool(a) != bool(b) for a, b in (x.alleles for x in sites))
        comp0 = sum(all(x.alleles) and x.alleles[0] != x.alleles[1]
                    for x in sites)
        # the same shares as sample 0 (a compound site overrides its
        # het draw), on other sites
        assert compound == comp0 and abs(het - het0) <= 15
        assert [x.alleles for x in s] != [x.alleles for x in sites]
        for x in s:
            assert set(x.alleles) - {""} <= set(x.alts)


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_pool_allele_counts(seed):
    from benchmark.gen.sim import sample_sites
    weights = [4, 2, 1, 1, 0, 0, 0, 0]
    traffic = dict(_traffic("isolated", 400), pool_allele_counts=weights)
    _, _, _, sites = make_genome(SEQ, traffic, seed)
    samples = sample_sites(sites, traffic, 4, seed)
    assert len(samples) == 4
    counts = Counter()
    for i, s in enumerate(sites):
        carried = [a for k in range(4) for a in samples[k][i].alleles if a]
        assert set(carried) == {s.alts[0]}
        counts[len(carried)] += 1
    # every seed the same multiset: the weights' shares, rounded
    assert counts == {1: 200, 2: 100, 3: 50, 4: 50}
    with pytest.raises(ValueError):
        sample_sites(sites, traffic, 3, seed)
