"""dindel_tpu_torch's dense per-pair path and slab rescue vs the JAX
package, on the CPU.

- pack_pairs byte-equal to the JAX pack_pairs in float32 and float64,
  the unmapped-mate insert-size prior rows included (the case of
  tests/test_pack_vectorized.py:52); compute_obs_mid and
  expand_compact_host equal;
- run_packed against the JAX run_packed: float64 exact ties against the
  XLA program, bit-equal (map_state inside each read: past read_len it
  is not defined and every consumer masks it); float32 fast ties against
  the Pallas kernel in interpret mode, equal after decode (MLAlignments
  field by field: the JAX Pallas path pads S_half to a multiple of 128,
  so its raw map_state codes differ);
- the batched engine with --insertPrior, where every slab is packed
  dense, with a libraries file and with the default library: GLF
  byte-equal to the JAX batched engine in float64 (XLA), unmapped reads
  realigned, no slab rescued;
- slab rescue (as tests/test_batched_engine.py:128 holds it in JAX):
  slabs made to fail at dispatch or at fetch are re-scored window by
  window through the DP on the engine's device, the GLF unchanged, one
  rescue counted per failed slab; a window's WindowError becomes its
  error row, any other error ends the run.
Every comparison is exact."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import dindel_tpu.hmm.batch as jbatch
import dindel_tpu.hmm.pallas_kernel as pallas_kernel
import dindel_tpu_torch.engine.batched as tbatched
import dindel_tpu_torch.hmm.slab as tslab
from dindel_tpu.config import ObservationModelParameters as JaxObsParams
from dindel_tpu.config import Parameters as JaxParameters
from dindel_tpu.engine.batched import BatchedWindowEngine as JaxEngine
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.model import Library as JaxLibrary
from dindel_tpu.model import LibraryCollection as JaxLibraries
from dindel_tpu.parallel.mesh import synth_windows as jax_synth
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate
from dindel_tpu_torch.config import ObservationModelParameters, Parameters
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.reads import WindowError
from dindel_tpu_torch.hmm.liks import decode_liks_view
from dindel_tpu_torch.hmm.pack import (compute_obs_mid, expand_compact_host,
                                       pack_pairs, pack_pairs_compact)
from dindel_tpu_torch.hmm.slab import run_packed
from dindel_tpu_torch.model import Library, LibraryCollection
from dindel_tpu_torch.parallel.mesh import synth_windows

torch.set_num_threads(1)


def _window(pkg, nh, nr, H, L, seed, mates=False):
    """One synthetic window built by `pkg`'s own classes (the two
    synth_windows are the same generator), with the read perturbations
    of tests/test_pack_vectorized.py: mixed mapping qualities, shifted
    positions, some unmapped reads; with `mates`, every other read has a
    mapped mate on the same contig and a library (the insert-size
    prior's input)."""
    synth, lib_cls = ((synth_windows, Library) if pkg == "torch"
                      else (jax_synth, JaxLibrary))
    (haps, reads, hs), = synth(1, nh=nh, nr=nr, H=H, L=L, seed=seed)
    rng = random.Random(2)
    for r in reads:
        r.map_qual = rng.choice([0.5, 0.99, 1.0 - 1e-16])
        r.pos_stat_first += rng.randrange(-200, 200)
        if rng.random() < 0.1:
            r.is_unmapped = True
    if mates:
        counts = np.random.RandomState(0).poisson(5, 600).astype(
            np.float64) + 1
        lib = lib_cls(counts)
        prng = random.Random(3)
        for i, r in enumerate(reads):
            if i % 2 == 0:
                r.is_paired = True
                r.mate_is_unmapped = False
                r.mate_len = 75
                r.mate_pos = int(r.pos_stat_first) + prng.randrange(100, 300)
                r.same_tid_as_mate = True
                r.mate_is_reverse = i % 4 == 0
                r.library = lib
    return haps, reads, hs


def _params(pkg, mates=False):
    p = ObservationModelParameters() if pkg == "torch" else JaxObsParams()
    p.map_unmapped_reads = mates
    return p


def _assert_pk_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def _both(nh, nr, H, L, seed, mates=False, **kw):
    """pack_pairs of the same window by both packages."""
    out = []
    for pkg, fn in (("torch", pack_pairs), ("jax", jbatch.pack_pairs)):
        haps, reads, hs = _window(pkg, nh, nr, H, L, seed, mates)
        out.append(fn(haps, reads, hs, _params(pkg, mates), **kw))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_pairs_matches_jax(dtype):
    got, want = _both(4, 40, 90, 50, 5, dtype=dtype)
    _assert_pk_equal(got, want)
    # a caller-given layout (the JAX Pallas padding)
    got, want = _both(3, 17, 100, 60, 8, dtype=dtype, H_pad=126, L_pad=64)
    _assert_pk_equal(got, want)


def test_pack_pairs_unmapped_mates_matches_jax():
    """The insert-size positional prior rows (pinsert from each read's
    library) are byte-equal, and they change the prior."""
    got, want = _both(2, 20, 80, 40, 6, mates=True, dtype=np.float64)
    _assert_pk_equal(got, want)
    plain, _ = _both(2, 20, 80, 40, 6, mates=False, dtype=np.float64)
    assert not np.array_equal(got["prior_rmq"], plain["prior_rmq"])
    # the compact packer refuses this window: it needs per-pair tables
    haps, reads, hs = _window("torch", 2, 20, 80, 40, 6, mates=True)
    assert pack_pairs_compact(haps, reads, hs, _params("torch", True)) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_obs_mid_and_expand_compact_host_match_jax(dtype):
    haps, reads, hs = _window("torch", 4, 30, 90, 50, 5)
    jhaps, jreads, jhs = _window("jax", 4, 30, 90, 50, 5)
    pk = pack_pairs_compact(haps, reads, hs, _params("torch"), dtype)
    jpk = jbatch.pack_pairs_compact(jhaps, jreads, jhs, _params("jax"),
                                    dtype)
    got, want = expand_compact_host(pk), jbatch.expand_compact_host(jpk)
    _assert_pk_equal(got, want)
    dense = pack_pairs(haps, reads, hs, _params("torch"), dtype)
    for k in want:  # the compact form expands to the dense one
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(dense[k], got[k]), k
    obs = compute_obs_mid(dense)
    assert obs.dtype == np.dtype(dtype)
    assert np.array_equal(obs, jbatch.compute_obs_mid(dense))


def test_run_packed_matches_xla_f64():
    """float64 exact ties, the insert-prior rows in the pk: bit-equal to
    the JAX XLA program."""
    pk, jpk = _both(3, 16, 60, 40, 6, mates=True, dtype=np.float64)
    want = [np.asarray(a) for a in jbatch.run_packed(jpk, "xla")]
    got = [t.numpy() for t in run_packed(pk, True, "cpu")]
    for nm, w, g in zip(("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on"),
                        want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w), nm
    assert got[5].dtype == want[5].dtype == np.int16
    valid = np.arange(pk["L_pad"])[None, :] < pk["read_len"][:, None]
    assert np.array_equal(got[5][valid], want[5][valid])


def _fields(mls):
    return [[dataclasses.asdict(m) for m in row] for row in mls]


def test_run_packed_matches_pallas_interpret_f32_after_decode():
    """float32 fast ties on a tiny window against the JAX Pallas kernel
    (interpret mode) in its own layout (S_half and L_pad multiples of
    128): ll planes bit-equal, decoded MLAlignments equal."""
    haps, reads, hs = _window("torch", 2, 6, 40, 30, 9, mates=True)
    jhaps, jreads, jhs = _window("jax", 2, 6, 40, 30, 9, mates=True)
    p, jp = _params("torch", True), _params("jax", True)
    pk = pack_pairs(haps, reads, hs, p, np.float32)
    jpk = jbatch.pack_pairs(jhaps, jreads, jhs, jp, np.float32, H_pad=126,
                            L_pad=128)
    old = pallas_kernel.FORCE_INTERPRET
    pallas_kernel.FORCE_INTERPRET = True
    try:
        want = [np.asarray(a) for a in jbatch.run_packed(jpk, "pallas")]
    finally:
        pallas_kernel.FORCE_INTERPRET = old
    got = [t.numpy() for t in run_packed(pk, False, "cpu")]
    for nm, w, g in zip(("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on"),
                        want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w), nm
    tv = decode_liks_view(haps, reads, pk, *got, p)
    jv = jbatch.decode_liks_view(jhaps, jreads, jpk, *want, jp)
    assert _fields(tv.materialize()) == _fields(jv.materialize())


# ---------------------------------------------------------------------------
# the batched engine's dense route


@pytest.fixture(scope="module")
def unmapped_sim(tmp_path_factory):
    """The seed-17 sim of tests/test_unmapped_realign.py:18: short
    inserts, 70% of the mates of mapped reads unmapped."""
    tmp = tmp_path_factory.mktemp("unmapped")
    cfg = SimConfig(ref_len=1500, coverage=30, read_len=60, insert_mean=130,
                    insert_sd=8, unmapped_frac=0.7)
    fa, bam = simulate(str(tmp / "sim"),
                       [PlantedVariant(pos=700, var="-ACGT", genotype=2)],
                       cfg, seed=17)
    var_file, lib_file = get_candidates(bam, str(tmp / "cand"), fa)
    return tmp, fa, bam, make_windows(var_file, str(tmp / "win")), lib_file


@pytest.mark.parametrize("with_lib", [True, False],
                         ids=["libFile", "default_library"])
def test_engine_insert_prior_matches_jax(unmapped_sim, monkeypatch,
                                         with_lib):
    """--insertPrior with --libFile, and with --mapUnmapped alone (the
    default single_end library): every slab takes the dense route."""
    tmp, fa, bam, wfs, lib_file = unmapped_sim
    calls = dict(run_packed=0, run_slab_decode=0, run_slab_stats=0)
    for name in calls:
        real = getattr(tbatched, name)

        def spy(*a, _n=name, _real=real, **k):
            calls[_n] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tbatched, name, spy)
    glfs, rows = [], []
    for tag, params_cls, libs_cls, eng_fn in (
            ("j", JaxParameters, JaxLibraries,
             lambda *a: JaxEngine(*a, dp_impl="xla", dtype=np.float64)),
            ("t", Parameters, LibraryCollection,
             lambda *a: BatchedWindowEngine(*a, device="cpu",
                                            dtype=np.float64,
                                            exact_ties=True))):
        params = params_cls()
        params.do_diploid = True
        params.map_unmapped_reads = True
        params.obs_params.map_unmapped_reads = True
        params.file_name = str(tmp / f"{tag}{int(with_lib)}")
        libraries = libs_cls()
        if with_lib:
            libraries.add_from_file(lib_file)
        eng = eng_fn([bam], fa, params, libraries)
        glf = params.file_name + ".glf.txt"
        rows.append(eng.detect_indels(wfs[0], glf))
        eng.close()
        # the JAX engine keeps its rescues in stage_seconds
        rescues = (eng.stats.counts.get("slab.rescues", 0) if tag == "t"
                   else eng.stats.stage_seconds.get("slab_rescues", 0))
        assert rescues == 0
        glfs.append(open(glf).read())
    assert calls["run_packed"] > 0
    assert calls["run_slab_decode"] == calls["run_slab_stats"] == 0
    assert glfs[1] == glfs[0]
    dip = [r for r in rows[1] if r.get("analysis_type") == "dip.map"]
    assert dip, glfs[1]
    assert any(int(r.get("num_unmapped_realigned", 0)) > 0 for r in dip)


# ---------------------------------------------------------------------------
# slab rescue


@pytest.fixture(scope="module")
def rescue_sim(tmp_path_factory):
    """The sim of tests/test_batched_engine.py:128, and the port's float64
    GLF on it without faults, per route (full decode when realigned)."""
    tmp = tmp_path_factory.mktemp("rescue")
    fa, bam = simulate(str(tmp / "sim"),
                       [PlantedVariant(pos=700, var="-ACG", genotype=1),
                        PlantedVariant(pos=1500, var="+TT", genotype=2)],
                       SimConfig(ref_len=2200, coverage=18, read_len=70),
                       seed=13)
    var_file, _ = get_candidates(bam, str(tmp / "cand"), fa)
    wf = make_windows(var_file, str(tmp / "win"))[0]
    clean = {}
    for realigned in (False, True):
        p, eng = _batched_f64(tmp, fa, bam, f"clean{int(realigned)}",
                              output_realigned_bam=realigned)
        clean[realigned] = _run(eng, wf, p)[1]
        assert eng.stats.counts.get("slab.rescues", 0) == 0
    return tmp, fa, bam, wf, clean


def _batched_f64(tmp, fa, bam, tag, **kw):
    p = Parameters()
    p.do_diploid = True
    p.file_name = str(tmp / tag)
    for k, v in kw.items():
        setattr(p, k, v)
    return p, BatchedWindowEngine([bam], fa, p, device="cpu",
                                  batch_windows=8, max_pairs_per_slab=2000,
                                  dtype=np.float64, exact_ties=True)


def _run(eng, wf, params):
    glf = params.file_name + ".glf.txt"
    try:
        rows = eng.detect_indels(wf, glf)
    finally:
        eng.close()
    return rows, open(glf).read()


class _Unfetchable:
    def cpu(self):
        raise RuntimeError("injected fetch fault")


@pytest.mark.parametrize("where,realigned", [("dispatch", False),
                                             ("fetch", True)],
                         ids=["dispatch-device_call", "fetch-decode"])
def test_slab_rescue_keeps_glf(rescue_sim, monkeypatch, where, realigned):
    """Every slab fails: its program raises at dispatch (device-call
    route), or its planes raise at fetch (full-decode route).  Each
    window is re-scored through the per-window backend, whose DP runs on
    the engine's device; one rescue per failed slab; the GLF is
    unchanged."""
    tmp, fa, bam, wf, clean = rescue_sim
    slabs = []

    def broken(*a, **k):
        slabs.append(a)
        if where == "dispatch":
            raise RuntimeError("injected slab fault")
        return (_Unfetchable(),) * 6
    for name in ("run_slab_stats", "run_slab_decode", "run_packed"):
        monkeypatch.setattr(tbatched, name, broken)
    devices = []
    real_dp = tslab.pair_hmm_dp

    def dp_spy(*a, **k):
        devices.append(a[8].device)  # eq
        return real_dp(*a, **k)
    monkeypatch.setattr(tslab, "pair_hmm_dp", dp_spy)
    p, eng = _batched_f64(tmp, fa, bam, f"rescued_{where}",
                          output_realigned_bam=realigned)
    _, glf = _run(eng, wf, p)
    assert len(slabs) >= 2
    assert eng.stats.counts["slab.rescues"] == len(slabs)
    assert eng.stats.windows_ok >= 2
    assert devices and set(devices) == {eng.device}
    assert glf == clean[realigned]


@pytest.mark.parametrize("exc", [WindowError, RuntimeError])
def test_slab_rescue_error_handling(rescue_sim, monkeypatch, exc):
    """Inside a rescue, a window's WindowError becomes its error row and
    the other windows are still called; any other exception (a sticky
    CUDA error) propagates out of the run."""
    tmp, fa, bam, wf, _ = rescue_sim

    def boom(*a, **k):
        raise RuntimeError("injected slab fault")
    monkeypatch.setattr(tbatched, "run_slab_stats", boom)
    p, eng = _batched_f64(tmp, fa, bam, f"err_{exc.__name__}")
    real = eng.compute_likelihoods
    seen = []

    def first_fails(haps, reads, left_pos):
        seen.append(left_pos)
        if len(seen) == 1:
            raise exc("injected rescue fault")
        return real(haps, reads, left_pos)
    monkeypatch.setattr(eng, "compute_likelihoods", first_fails)
    if exc is RuntimeError:
        with pytest.raises(RuntimeError, match="injected rescue fault"):
            _run(eng, wf, p)
        return
    _, glf = _run(eng, wf, p)
    assert "error_injected_rescue_fault" in glf
    assert "dip.map" in glf
    assert eng.stats.error_messages == {"error_injected_rescue_fault": 1}
