"""The plain reference: its vectorised pair-HMM is the oracle's bit for
bit, its parameters are the CLI's, and its GLF rows are the program's
float64 streaming engine's on the same files."""

import dataclasses
import json

import pytest
import torch

from benchmark import spec
from benchmark.gen import make_dataset
from benchmark.reference import caller
from benchmark.reference.oracle import pair_hmm_single
from benchmark.reference.pairhmm import score_pairs

CFG = json.load(open(spec.HERE / "configs" / "dip30x-exact.json"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    traffic = dict(spec.traffic("str"), sites=3)
    out = make_dataset(str(d), CFG["sequencing"], traffic, 99)
    out["lines"] = open(out["windows"]).read().splitlines()
    return out


def _pairs(data, n):
    """n (hap, read, start) pairs of the first window, as the reference
    stages them."""
    from benchmark.reference.bam import BamReader
    from benchmark.reference.fasta import FastaFile
    from benchmark.reference.model import LibraryCollection
    from benchmark.reference.reads import ReadBuffer, get_reads
    from benchmark.reference.variants import parse_window_line
    p = caller.diploid_params({})
    cand = parse_window_line(data["lines"][0])
    p.tid = cand.tid
    buf = ReadBuffer()
    bam = BamReader(data["bam"])
    fa = FastaFile(data["fasta"])
    reads = get_reads([bam], p.tid, cand.left_pos, cand.right_pos, p,
                      LibraryCollection(), buf)
    _, haps, lp, _ = caller._haplotypes(fa, p, reads, cand.center_pos,
                                        cand.left_pos, cand.right_pos, cand)
    pairs = [(h, r, lp) for h in haps for r in reads]
    return pairs[::max(1, len(pairs) // n)][:n], p


def _fields(ml):
    return (ml.ll, ml.ll_off, ml.ll_on, ml.off_hap, ml.off_hap_hmq,
            ml.hpos, ml.align, ml.first_base, ml.last_base, ml.n_bqt,
            ml.m_log_bq, ml.n_mm_bqt, ml.num_mismatch, ml.num_indels,
            sorted((k, v.str) for k, v in ml.indels.items()),
            sorted((k, v.str) for k, v in ml.snps.items()),
            sorted(ml.hap_indel_covered.items()))


def test_vectorised_pairhmm_is_the_oracle(data):
    pairs, p = _pairs(data, 12)
    got = score_pairs(pairs, p.obs_params, "cpu", torch.float64,
                      block_pairs=5)
    for (h, r, s), ml in zip(pairs, got):
        assert _fields(ml) == _fields(pair_hmm_single(h, r, s, p.obs_params))


def test_params_are_the_clis():
    from dindel_tpu_torch import cli
    for name in ("dip30x-exact", "dip30x-batched"):
        cfg = json.load(open(spec.HERE / "configs" / f"{name}.json"))
        args = cli.build_parser().parse_args(
            cfg["cli"] + ["--bamFile", "x.bam", "--ref", "x.fa"])
        theirs = dataclasses.asdict(cli.params_from_args(args))
        ours = dataclasses.asdict(caller.diploid_params(cfg["dindel_flags"]))
        ours["ref_file_name"] = theirs["ref_file_name"]
        assert ours == theirs


def test_glf_rows_are_the_float64_engines(data, tmp_path):
    from dindel_tpu_torch import cli
    from dindel_tpu_torch.engine.window import WindowEngine
    from benchmark import check
    args = cli.build_parser().parse_args(
        CFG["cli"] + ["--bamFile", data["bam"], "--ref", data["fasta"]])
    eng = WindowEngine([data["bam"]], data["fasta"],
                       cli.params_from_args(args), hmm_backend="jax",
                       device="cpu")
    glf = tmp_path / "prog.glf.txt"
    try:
        eng.detect_indels(data["windows"], str(glf))
    finally:
        eng.close()
    prog = check.read_glf(glf)
    ref = caller.glf_rows(data["fasta"], [data["bam"]],
                          {i + 1: x for i, x in enumerate(data["lines"])},
                          {})
    assert sum(map(len, ref.values())) > 0
    # a row's tie note (check.split_note) is the reference's remark, not
    # GLF text
    assert {i: [check.split_note(x)[0] for x in r]
            for i, r in ref.items() if r} == prog
