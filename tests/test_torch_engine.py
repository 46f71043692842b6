"""dindel_tpu_torch engine and CLI on the CPU vs the JAX package.

GLF text must be byte-identical to the JAX batched engine: float32 with
fast ties (the shipped configuration) against the JAX XLA float32
engine, and float64 with exact ties against the JAX float64 engine, both
with host folds.  The device folds must give the same VCF.  The CLI
makes the golden call and refuses --mesh and --stageProcs outside the
batched engine; --doPooled, --outputRealignedBAM and --opl run end to
end on the CPU (the streaming engine, --faster and --insertPrior:
tests/test_torch_streaming.py, tests/test_torch_faster.py,
tests/test_torch_dense.py; --mesh and --stageProcs:
tests/test_torch_parallel.py, tests/test_torch_hostshard.py)."""

import numpy as np
import pytest
import torch

from dindel_tpu.config import Parameters
from dindel_tpu.engine.batched import BatchedWindowEngine as JaxEngine
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.io.bam import BamReader
from dindel_tpu.pipeline.merge_diploid import merge_output_diploid
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate
from dindel_tpu_torch import cli
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from test_device_call import _sim

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_slab_rescues(monkeypatch):
    """Every engine of the port a test closes must have rescued no slab:
    a rescue re-scores through the per-window backend and would hide a
    broken slab program.  The other port test modules that run engines
    import this fixture."""
    from dindel_tpu_torch.engine import window

    close = window.WindowEngine.close

    def checked(eng):
        close(eng)
        assert eng.stats.counts.get("slab.rescues", 0) == 0, (
            "an engine rescued a slab")
    monkeypatch.setattr(window.WindowEngine, "close", checked)


@pytest.fixture(scope="module")
def shipped_sim(tmp_path_factory):
    """The sim of tests/test_shipped_config.py."""
    tmp = tmp_path_factory.mktemp("shipped")
    variants = [PlantedVariant(pos=600, var="-ACG", genotype=1),
                PlantedVariant(pos=1400, var="+TT", genotype=2)]
    cfg = SimConfig(ref_len=2000, coverage=12, read_len=50)
    fa, bam = simulate(str(tmp / "sim"), variants, cfg, seed=9)
    var_file, _ = get_candidates(bam, str(tmp / "cand"), fa)
    return tmp, fa, bam, make_windows(var_file, str(tmp / "win"))


def _run(engine, tmp, win_files, tag):
    glf = str(tmp / f"{tag}.glf.txt")
    rows = []
    for wf in win_files:
        rows.extend(engine.detect_indels(wf, glf))
    engine.close()
    return rows, open(glf).read()


def _params(tmp, tag):
    p = Parameters()
    p.do_diploid = True
    p.file_name = str(tmp / tag)
    return p


def _torch_engine(tmp, fa, bam, tag, **kw):
    return BatchedWindowEngine([bam], fa, _params(tmp, tag), device="cpu",
                               **kw)


def test_engine_f32_fast_matches_jax_xla(shipped_sim):
    tmp, fa, bam, wfs = shipped_sim
    jax_eng = JaxEngine([bam], fa, _params(tmp, "jx"), batch_windows=8,
                        dp_impl="xla", dtype=np.float32)
    rows_j, glf_j = _run(jax_eng, tmp, wfs[:1], "jx")
    assert jax_eng.stats.stage_seconds.get("slab_rescues", 0) == 0
    eng = _torch_engine(tmp, fa, bam, "tx", batch_windows=8,
                        dtype=np.float32, device_folds=False)
    rows_t, glf_t = _run(eng, tmp, wfs[:1], "tx")
    assert eng.stats.windows_ok >= 2, eng.stats.error_messages
    assert "dip.map" in glf_t
    assert glf_t == glf_j
    assert rows_t == rows_j


def test_engine_f64_exact_matches_jax_f64(tmp_path):
    fa, bam, wfs = _sim(tmp_path, 3)
    jax_eng = JaxEngine([bam], fa, _params(tmp_path, "j64"),
                        dtype=np.float64, max_pairs_per_slab=4096)
    rows_j, glf_j = _run(jax_eng, tmp_path, wfs, "j64")
    assert jax_eng.stats.stage_seconds.get("slab_rescues", 0) == 0
    eng = _torch_engine(tmp_path, fa, bam, "t64", dtype=np.float64,
                        exact_ties=True, max_pairs_per_slab=4096)
    assert eng.device_folds is False  # float64 folds on the host
    rows_t, glf_t = _run(eng, tmp_path, wfs, "t64")
    assert eng.stats.windows_ok >= 4, eng.stats.error_messages
    assert glf_t == glf_j
    assert rows_t == rows_j


def test_engine_device_folds_same_vcf(shipped_sim):
    tmp, fa, bam, wfs = shipped_sim
    vcfs = []
    for folds in (True, False):
        tag = f"folds{int(folds)}"
        eng = _torch_engine(tmp, fa, bam, tag, batch_windows=2,
                            dtype=np.float32, device_folds=folds)
        assert eng.device_folds is folds
        _run(eng, tmp, wfs, tag)
        vcf = str(tmp / f"{tag}.vcf")
        merge_output_diploid([str(tmp / f"{tag}.glf.txt")], vcf, fa)
        vcfs.append([line for line in open(vcf)
                     if not line.startswith("##")])
    assert len(vcfs[0]) > 1
    assert vcfs[0] == vcfs[1]


@pytest.fixture(scope="module")
def golden_sim(tmp_path_factory):
    """The sim of tests/test_shipped_config.py:60-62, through the port's
    CLI verbs (which delegate to the JAX package's host code)."""
    tmp = tmp_path_factory.mktemp("golden")
    fa, bam = simulate(str(tmp / "sim"),
                       [PlantedVariant(pos=700, var="-ACG", genotype=1)],
                       SimConfig(ref_len=2100, coverage=25, read_len=75),
                       seed=11)
    assert cli.main(["--analysis", "getCIGARindels", "--bamFile", bam,
                     "--ref", fa, "--outputFile", str(tmp / "cand"),
                     "--device", "cpu"]) == 0
    assert cli.main(["--analysis", "makeWindows", "--inputVarFile",
                     str(tmp / "cand.variants.txt"), "--windowFilePrefix",
                     str(tmp / "win")]) == 0
    return tmp, fa, bam, str(tmp / "win.1.txt")


def _indels(fa, bam, wf, out, *extra, caller="--doDiploid"):
    return ["--analysis", "indels", caller, "--engine", "batched",
            "--bamFile", bam, "--ref", fa, "--varFile", wf,
            "--outputFile", out, *extra]


def test_cli_golden_call_cpu(golden_sim):
    tmp, fa, bam, wf = golden_sim
    out = str(tmp / "out")
    assert cli.main(_indels(fa, bam, wf, out, "--hmmBackend", "pallas",
                            "--device", "cpu")) == 0
    (tmp / "glfs.txt").write_text(out + ".glf.txt\n")
    assert cli.main(["--analysis", "mergeOutputDiploid", "--inputFiles",
                     str(tmp / "glfs.txt"), "--ref", fa, "--outputFile",
                     str(tmp / "calls.vcf")]) == 0
    recs = [line.split("\t") for line in open(tmp / "calls.vcf")
            if not line.startswith("#")]
    dels = [r for r in recs if len(r[3]) > len(r[4])]
    assert dels and (int(dels[0][1]), dels[0][3], dels[0][4],
                     dels[0][9].split(":")[0]) == (3128, "AGGG", "A", "0/1")


def test_cli_device_cuda_without_cuda_raises(golden_sim):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, fa, bam, wf = golden_sim
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_indels(fa, bam, wf, str(tmp / "nocuda"), "--device",
                         "cuda"))


def test_cli_pooled_cpu(tmp_path):
    """--doPooled alone on the three-indel sim of
    tests/test_pooled.py::test_pooled_end_to_end (one window fails the
    depth filter, so the sim needs several), then mergeOutputPooled: the
    VCF passes all three planted indels."""
    fa, bam = simulate(str(tmp_path / "sim"),
                       [PlantedVariant(pos=650, var="-CT", genotype=1),
                        PlantedVariant(pos=1500, var="-GAT", genotype=1),
                        PlantedVariant(pos=2400, var="+AC", genotype=1)],
                       SimConfig(ref_len=3100, coverage=25, read_len=70),
                       seed=21)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    wf = make_windows(var_file, str(tmp_path / "win"))[0]
    out = str(tmp_path / "pooled")
    assert cli.main(_indels(fa, bam, wf, out, "--hmmBackend", "pallas",
                            "--device", "cpu", caller="--doPooled")) == 0
    glf = open(out + ".glf.txt").read()
    assert "singlevariant" in glf and "dip.map" not in glf
    (tmp_path / "glfs.txt").write_text(out + ".glf.txt\n")
    assert cli.main(["--analysis", "mergeOutputPooled", "--inputFiles",
                     str(tmp_path / "glfs.txt"), "--ref", fa, "--outputFile",
                     str(tmp_path / "pooled.vcf"), "--numSamples", "1",
                     "--numBAMFiles", "1"]) == 0
    recs = [line.split("\t") for line in open(tmp_path / "pooled.vcf")
            if not line.startswith("#")]
    assert [(int(r[1]), r[3], r[4], r[6]) for r in recs] == [
        (3082, "TCC", "T", "PASS"), (3932, "AGGG", "A", "PASS"),
        (4832, "G", "GAC", "PASS")]


def test_cli_realigned_bam_cpu(golden_sim):
    """--outputRealignedBAM: one BAM per window, holding reads."""
    tmp, fa, bam, wf = golden_sim
    (tmp / "ra").mkdir()
    out = str(tmp / "ra" / "out")
    assert cli.main(_indels(fa, bam, wf, out, "--outputRealignedBAM",
                            "--device", "cpu")) == 0
    assert "dip.map" in open(out + ".glf.txt").read()
    bams = sorted((tmp / "ra").glob("out.ra.*.bam"))
    assert bams
    assert any(rec.cigar for b in bams for rec in BamReader(str(b)))


def test_cli_opl_cpu(golden_sim):
    """--opl with both callers: the pooled dumps and the diploid check
    table are written."""
    tmp, fa, bam, wf = golden_sim
    (tmp / "opl").mkdir()
    out = str(tmp / "opl" / "out")
    assert cli.main(_indels(fa, bam, wf, out, "--doPooled", "--opl",
                            "--device", "cpu")) == 0
    glf = open(out + ".glf.txt").read()
    assert "singlevariant" in glf and "dip.map" in glf
    for pat in ("out.*.liks", "out.*.hapvars", "out.*.hapfreqs",
                "out.check.txt"):
        assert list((tmp / "opl").glob(pat)), pat


@pytest.mark.parametrize("extra", [["--mesh", "2x1"], ["--stageProcs", "2"]])
def test_cli_unsupported_raises(golden_sim, extra):
    """--mesh and --stageProcs serve the batched engine only: with the
    streaming engine, or with each other, they raise."""
    tmp, fa, bam, wf = golden_sim
    streaming = ["--analysis", "indels", "--doDiploid", "--bamFile", bam,
                 "--ref", fa, "--varFile", wf, "--outputFile",
                 str(tmp / "refused"), "--device", "cpu"]
    with pytest.raises(ValueError, match="need --engine batched"):
        cli.main(streaming + extra)
    other = ["--stageProcs", "2"] if extra[0] == "--mesh" else ["--mesh",
                                                                 "2x1"]
    with pytest.raises(ValueError, match="exclusive"):
        cli.main(_indels(fa, bam, wf, str(tmp / "refused"), "--device",
                         "cpu", *extra, *other))

