"""dindel_tpu_torch's streaming engine and shard driver vs the JAX
package, on the CPU.

- BatchedPairHMM (the per-window backend) against the JAX one,
  MLAlignments field by field: the 'jax' backend in float64 with exact
  ties against the XLA DP; the 'pallas' backend (float32, fast ties) on
  a tiny window against the JAX Pallas kernel in interpret mode;
- WindowEngine(hmm_backend="jax", device="cpu") against the JAX
  WindowEngine(hmm_backend="jax") (float64 with x64, tests/conftest.py)
  on the sims of tests/test_batched_engine.py: GLF bytes, realigned
  BAMs, error rows and the pooled caller equal; and the port's
  streaming engine against the port's batched engine in float64;
- the CLI's default indels run (no --engine) GLF byte-equal to
  ``python -m dindel_tpu``'s;
- run_and_merge_diploid's shard GLFs and merged VCF byte-equal to the
  JAX driver's.
Every comparison is exact."""

import dataclasses
import glob

import numpy as np
import pytest
import torch

import dindel_tpu.hmm.batch as jbatch
import dindel_tpu.hmm.pallas_kernel as pallas_kernel
import dindel_tpu_torch.hmm.batch as tbatch
from dindel_tpu import cli as jax_cli
from dindel_tpu.config import ObservationModelParameters as JaxObsParams
from dindel_tpu.config import Parameters as JaxParameters
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.engine.window import WindowEngine as JaxWindowEngine
from dindel_tpu.io.bam import BamReader
from dindel_tpu.parallel.mesh import synth_windows as jax_synth
from dindel_tpu.pipeline.run_parallel import (
    run_and_merge_diploid as jax_run_and_merge)
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate
from dindel_tpu_torch import cli
from dindel_tpu_torch.config import ObservationModelParameters, Parameters
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.window import WindowEngine
from dindel_tpu_torch.hmm.batch import BatchedPairHMM
from dindel_tpu_torch.parallel.mesh import synth_windows
from dindel_tpu_torch.pipeline.run_parallel import run_and_merge_diploid
from test_torch_engine import no_slab_rescues  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _sim(tmp, variants, cfg, seed, **kw):
    fa, bam = simulate(str(tmp / "sim"), variants, cfg, seed=seed)
    var_file, _ = get_candidates(bam, str(tmp / "cand"), fa)
    return fa, bam, make_windows(var_file, str(tmp / "win"), **kw)


def _params(cls, tmp, tag, **kw):
    p = cls()
    p.file_name = str(tmp / tag)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _glf(eng, wf, params):
    glf = params.file_name + ".glf.txt"
    rows = eng.detect_indels(str(wf), glf)
    eng.close()
    return rows, open(glf).read()


def _streaming_pair(tmp, fa, bam, wf, **attrs):
    """The JAX and the port's WindowEngine(hmm_backend="jax") on one
    window file: ((rows, GLF) JAX, (rows, GLF) port)."""
    jp = _params(JaxParameters, tmp, "jax", **attrs)
    tp = _params(Parameters, tmp, "port", **attrs)
    return (_glf(JaxWindowEngine([bam], fa, jp, hmm_backend="jax"), wf, jp),
            _glf(WindowEngine([bam], fa, tp, hmm_backend="jax",
                              device="cpu"), wf, tp))


def _fields(mls):
    return [[dataclasses.asdict(m) for m in row] for row in mls]


# ---------------------------------------------------------------------------
# the per-window backend


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_batched_pair_hmm_matches_jax(backend):
    if backend == "jax":
        shape = dict(nh=4, nr=30, H=90, L=50, seed=5)
        jhmm = jbatch.BatchedPairHMM(JaxObsParams())
    else:  # Pallas interpret mode: a tiny window
        shape = dict(nh=2, nr=6, H=40, L=30, seed=9)
        jhmm = jbatch.BatchedPairHMM(JaxObsParams(), dtype=np.float32,
                                     dp_impl="pallas")
    dtype, exact = tbatch.BACKENDS[backend]
    hmm = BatchedPairHMM(ObservationModelParameters(), dtype,
                         exact_ties=exact, device="cpu")
    (haps, reads, hs), = synth_windows(1, **shape)
    (jhaps, jreads, jhs), = jax_synth(1, **shape)
    for r, jr, mq in zip(reads, jreads, [0.5, 0.99, 1 - 1e-16] * 20):
        r.map_qual = jr.map_qual = mq
    old = pallas_kernel.FORCE_INTERPRET
    pallas_kernel.FORCE_INTERPRET = True
    try:
        want = jhmm.compute(jhaps, jreads, jhs)
    finally:
        pallas_kernel.FORCE_INTERPRET = old
    got = hmm.compute(haps, reads, hs)
    for k in ("ll2d", "off_hap2d", "off_hap_hmq2d"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert _fields(got.materialize()) == _fields(want.materialize())
    assert hmm.compute([], reads, hs) == [[]]


def test_window_engine_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fa, bam = simulate(str(tmp_path / "sim"),
                       [PlantedVariant(pos=600, var="-AC", genotype=1)],
                       SimConfig(ref_len=1300, coverage=6, read_len=50),
                       seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WindowEngine([bam], fa, Parameters())  # hmm_backend jax, cuda
    # the oracle backend runs on the host and takes no device
    WindowEngine([bam], fa, Parameters(), hmm_backend="oracle").close()


# ---------------------------------------------------------------------------
# the streaming engine


@pytest.fixture(scope="module")
def sim13(tmp_path_factory):
    """The seed-13 sim of tests/test_batched_engine.py:18."""
    tmp = tmp_path_factory.mktemp("sim13")
    fa, bam, wfs = _sim(tmp, [PlantedVariant(pos=700, var="-ACG", genotype=1),
                              PlantedVariant(pos=1500, var="+TT", genotype=2),
                              PlantedVariant(pos=2300, var="-T", genotype=1)],
                        SimConfig(ref_len=3000, coverage=18, read_len=70), 13)
    return tmp, fa, bam, wfs[0]


@pytest.fixture(scope="module")
def streaming13(sim13):
    """The port's and the JAX streaming engines on the seed-13 sim:
    ((rows, GLF) JAX, (rows, GLF) port)."""
    tmp, fa, bam, wf = sim13
    return _streaming_pair(tmp, fa, bam, wf, do_diploid=True)


def test_window_engine_matches_jax(streaming13):
    (jrows, jglf), (trows, tglf) = streaming13
    assert tglf.count("dip.map") >= 2
    assert tglf == jglf
    assert trows == jrows


def test_streaming_equals_batched_f64(sim13, streaming13):
    """The port's two engines agree in float64 with exact ties (host
    folds): what tests/test_batched_engine.py:18 holds in JAX."""
    tmp, fa, bam, wf = sim13
    p = _params(Parameters, tmp, "batched", do_diploid=True)
    eng = BatchedWindowEngine([bam], fa, p, device="cpu", batch_windows=8,
                              dtype=np.float64, exact_ties=True)
    _, glf = _glf(eng, wf, p)
    assert eng.stats.counts.get("slab.rescues", 0) == 0
    assert "dip.map" in glf
    assert glf == streaming13[1][1]


def test_window_engine_realigned_bam_matches_jax(tmp_path):
    """tests/test_batched_engine.py:50's sim: GLF and the per-window
    realigned BAM records equal."""
    fa, bam, wfs = _sim(tmp_path,
                        [PlantedVariant(pos=600, var="-TGCA", genotype=2)],
                        SimConfig(ref_len=1300, coverage=15, read_len=70), 5)
    (_, jglf), (_, tglf) = _streaming_pair(tmp_path, fa, bam, wfs[0],
                                           do_diploid=True,
                                           output_realigned_bam=True)
    assert tglf == jglf
    recs = {}
    for tag in ("jax", "port"):
        paths = sorted(glob.glob(str(tmp_path / f"{tag}.ra.*.bam")))
        recs[tag] = [(p.split(".ra.", 1)[1],
                      [(r.qname, r.pos, r.cigar, r.flag)
                       for r in BamReader(p)]) for p in paths]
    assert recs["port"] and recs["port"] == recs["jax"]


def test_window_engine_error_rows_match_jax(tmp_path):
    """tests/test_batched_engine.py:89: a window with no reads becomes
    an error_* row and the next window is still called."""
    fa, bam, wfs = _sim(tmp_path,
                        [PlantedVariant(pos=900, var="-ACG", genotype=1)],
                        SimConfig(ref_len=1800, coverage=18, read_len=70), 13)
    wf = tmp_path / "win_err.txt"
    wf.write_text("1 1 30 15,-A\n" + open(wfs[0]).read())
    (_, jglf), (_, tglf) = _streaming_pair(tmp_path, fa, bam, wf,
                                           do_diploid=True)
    assert "error_" in tglf and "dip.map" in tglf
    assert tglf == jglf


def test_window_engine_pooled_matches_jax(tmp_path):
    """tests/test_batched_engine.py:164: the pooled caller (VB-EM on the
    host) through the streaming engine."""
    fa, bam, wfs = _sim(tmp_path,
                        [PlantedVariant(pos=650, var="-CT", genotype=1),
                         PlantedVariant(pos=1500, var="+AC", genotype=1)],
                        SimConfig(ref_len=2200, coverage=18, read_len=70), 21)
    (_, jglf), (_, tglf) = _streaming_pair(
        tmp_path, fa, bam, wfs[0], estimate_hap_freqs=True,
        bayes_type="singlevariant")
    assert "singlevariant" in tglf
    assert tglf == jglf


def test_cli_default_streaming_matches_jax(tmp_path):
    """`indels` with no --engine runs the streaming engine (K1 in float64,
    exact ties): the GLF is byte-equal to `python -m dindel_tpu`'s with
    x64 on (the golden sim of tests/test_shipped_config.py:60)."""
    fa, bam = simulate(str(tmp_path / "sim"),
                       [PlantedVariant(pos=700, var="-ACG", genotype=1)],
                       SimConfig(ref_len=2100, coverage=25, read_len=75),
                       seed=11)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    wf = make_windows(var_file, str(tmp_path / "win"))[0]
    argv = ["--analysis", "indels", "--doDiploid", "--bamFile", bam,
            "--ref", fa, "--varFile", wf, "--outputFile"]
    assert jax_cli.main(argv + [str(tmp_path / "jax")]) == 0
    assert cli.main(argv + [str(tmp_path / "port"), "--device", "cpu"]) == 0
    glf = open(tmp_path / "port.glf.txt").read()
    assert "dip.map" in glf
    assert glf == open(tmp_path / "jax.glf.txt").read()


# ---------------------------------------------------------------------------
# the shard driver


def test_run_and_merge_diploid_matches_jax(tmp_path):
    """tests/test_run_parallel.py:16's sim, one window per file: the
    shard GLFs and the merged VCF byte-equal to the JAX driver's
    (backend xla: float64, exact ties)."""
    fa, bam, wfs = _sim(tmp_path,
                        [PlantedVariant(pos=700, var="-ACG", genotype=1),
                         PlantedVariant(pos=1700, var="-TT", genotype=2)],
                        SimConfig(ref_len=2400, coverage=18, read_len=70), 4,
                        variants_per_file=-1)
    assert len(wfs) >= 2
    out = {}
    for tag, fn, params, kw in (
            ("jax", jax_run_and_merge, JaxParameters(), {}),
            ("port", run_and_merge_diploid, Parameters(),
             dict(device="cpu"))):
        vcf = str(tmp_path / f"{tag}.vcf")
        glfs, stats = fn(wfs, [bam], fa, params, str(tmp_path / tag), vcf,
                         num_workers=1, **kw)
        assert len(glfs) == len(wfs)
        out[tag] = ([open(g).read() for g in glfs], open(vcf).read(),
                    [s["windows_ok"] for s in stats])
    assert sum(out["port"][2]) >= 2
    assert len([x for x in out["port"][1].splitlines()
                if not x.startswith("#")]) >= 2
    assert out["port"] == out["jax"]
