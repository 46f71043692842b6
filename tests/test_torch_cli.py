"""The port's host verbs against the JAX package's, byte for byte.

Each of the eight verbs other than ``indels`` runs through
``python -m dindel_tpu`` and through ``python -m dindel_tpu_torch`` on the
same inputs (a small sim, its candidates, windows and GLFs), each in a
directory of its own; every file the verb writes must be byte-equal."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dindel_tpu.config import Parameters
from dindel_tpu.engine.batched import BatchedWindowEngine
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.pipeline.merge_diploid import merge_output_diploid
from dindel_tpu.pipeline.merge_pooled import merge_output_pooled
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A sim with its candidates, windows, diploid and pooled GLFs and
    their VCFs, all made by the JAX package (the verbs' inputs)."""
    d = tmp_path_factory.mktemp("cli_inputs")
    fa, bam = simulate(str(d / "sim"),
                       [PlantedVariant(pos=500, var="-AC", genotype=1),
                        PlantedVariant(pos=1300, var="+TG", genotype=2),
                        PlantedVariant(pos=2100, var="-G", genotype=1)],
                       SimConfig(ref_len=2600, coverage=12, read_len=50),
                       seed=4)
    var_file, _ = get_candidates(bam, str(d / "cand"), fa)
    win = make_windows(var_file, str(d / "win"))[0]
    glfs = {}
    for kind, attrs in (("dip", dict(do_diploid=True)),
                        ("pool", dict(estimate_hap_freqs=True))):
        params = Parameters()
        for k, v in attrs.items():
            setattr(params, k, v)
        params.file_name = str(d / kind)
        eng = BatchedWindowEngine([bam], fa, params, dp_impl="xla",
                                  dtype=np.float32)
        eng.detect_indels(win, str(d / f"{kind}.glf.txt"))
        eng.close()
        glfs[kind] = d / f"{kind}_glfs.txt"
        glfs[kind].write_text(str(d / f"{kind}.glf.txt") + "\n")
    merge_output_diploid([str(d / "dip.glf.txt")], str(d / "calls.vcf"), fa)
    merge_output_pooled([str(d / "pool.glf.txt")], str(d / "pooled.vcf"), fa,
                        num_samples=1, num_bam_files=1)
    (d / "bams.txt").write_text(bam + "\n")
    return dict(fa=fa, bam=bam, cand=var_file, dip_glfs=glfs["dip"],
                pool_glfs=glfs["pool"], calls=d / "calls.vcf",
                pooled=d / "pooled.vcf", bams=d / "bams.txt")


VERBS = {
    "getCIGARindels": lambda i: ["--bamFile", i["bam"], "--ref", i["fa"],
                                 "--outputFile", "out"],
    "realignCandidates": lambda i: ["--varFile", i["cand"], "--ref", i["fa"],
                                    "--outputFile", "out"],
    "makeWindows": lambda i: ["--inputVarFile", i["cand"],
                              "--windowFilePrefix", "out",
                              "--numWindowsPerFile", "2"],
    "selectCandidates": lambda i: ["--inputVarFile", i["cand"],
                                   "--outputFile", "out", "--minCount", "2"],
    "mergeOutputDiploid": lambda i: ["--inputFiles", i["dip_glfs"], "--ref",
                                     i["fa"], "--outputFile", "out.vcf"],
    "convertVCFToDindel": lambda i: ["--inputVarFile", i["calls"], "--ref",
                                     i["fa"], "--outputFile", "out"],
    "makeGenotypeLikelihoodFilePooled": lambda i: [
        "--inputFiles", i["pool_glfs"], "--bamFiles", i["bams"],
        "--varFile", i["pooled"], "--outputFile", "out"],
    "mergeOutputPooled": lambda i: ["--inputFiles", i["pool_glfs"], "--ref",
                                    i["fa"], "--outputFile", "out.vcf",
                                    "--numSamples", "1", "--numBAMFiles",
                                    "1"],
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_verb_output_byte_equal(inputs, tmp_path, verb):
    outs = {}
    for pkg in ("dindel_tpu", "dindel_tpu_torch"):
        cwd = tmp_path / pkg
        cwd.mkdir()
        argv = [sys.executable, "-m", pkg, "--analysis", verb,
                *[str(a) for a in VERBS[verb](inputs)]]
        res = subprocess.run(argv, cwd=cwd, capture_output=True, text=True,
                             timeout=300,
                             env=dict(os.environ, PYTHONPATH=str(REPO),
                                      JAX_PLATFORMS="cpu"))
        assert res.returncode == 0, res.stdout + res.stderr
        outs[pkg] = {p.name: p.read_bytes() for p in sorted(cwd.iterdir())}
    jax_out, port_out = outs["dindel_tpu"], outs["dindel_tpu_torch"]
    assert jax_out, f"{verb} wrote nothing"
    assert sorted(port_out) == sorted(jax_out)
    for name in jax_out:
        assert port_out[name] == jax_out[name], name
