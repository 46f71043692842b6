"""dindel_tpu_torch full-decode route vs the JAX package, on the CPU.

- run_slab_decode against run_packed_compact: float64 exact ties against
  the XLA program, float32 fast ties against the Pallas program in
  interpret mode; the five scalar planes bit-equal, map_state equal
  inside each read (past read_len it is not defined, and every consumer
  masks it);
- LiksView (native and numpy decode) against the original on the same
  fetched planes: arrays on the consumed columns, MLAlignments field by
  field; the filter and diploid caller on those views: rows and GLF
  bytes equal;
- the engine against the JAX BatchedWindowEngine in float64 exact ties:
  realigned BAMs, --opl dumps, and slabs whose variant flanks reach the
  LO/RO sentinel codes (also float32 fast ties against XLA float32).
Every comparison is exact."""

import dataclasses
import glob
import io

import numpy as np
import pytest
import torch

import dindel_tpu.hmm.batch as jbatch
import dindel_tpu.hmm.pallas_kernel as pallas_kernel
import dindel_tpu_torch.engine.batched as tbatched
from dindel_tpu.config import Parameters
from dindel_tpu.engine.batched import BatchedWindowEngine as JaxEngine
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.infer.diploid import diploid_glf as jax_diploid_glf
from dindel_tpu.infer.filterhaps import filter_haplotypes as jax_filter
from dindel_tpu.io.bam import BamReader
from dindel_tpu.out.glf import make_glf_output
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.hmm.liks import LiksView
from dindel_tpu_torch.hmm.pack import (_round_up, merge_compact,
                                       pack_pairs_compact, pad_compact)
from dindel_tpu_torch.hmm.slab import run_slab_decode
from dindel_tpu_torch.infer.diploid import diploid_glf
from dindel_tpu_torch.infer.filterhaps import filter_haplotypes
from test_torch_slab import _merged
from test_torch_engine import no_slab_rescues  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _sim_windows(tmp, variants, cfg, seed):
    fa, bam = simulate(str(tmp / "sim"), variants, cfg, seed=seed)
    var_file, _ = get_candidates(bam, str(tmp / "cand"), fa)
    return fa, bam, make_windows(var_file, str(tmp / "win"))


def _params(tmp, tag, **kw):
    p = Parameters()
    p.do_diploid = True
    p.file_name = str(tmp / tag)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _run(eng, win_files, glf):
    rows = []
    for wf in win_files:
        rows.extend(eng.detect_indels(wf, glf))
    eng.close()
    return rows, open(glf).read()


def _consumed(read_len, L_pad):
    return np.arange(L_pad)[None, :] < np.asarray(read_len)[:, None]


# ---------------------------------------------------------------------------
# (a) the slab program


def _compare_decode(want, got, pk):
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    for nm, w, g in zip(("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on"),
                        want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w), nm
    assert got[5].dtype == want[5].dtype == np.int16
    valid = _consumed(pk["read_len"], pk["L_pad"])
    assert np.array_equal(got[5][valid], want[5][valid])


def test_run_slab_decode_matches_xla_f64():
    pk = _merged(np.float64, 78)
    want = jbatch.run_packed_compact(pk, "xla", exact_ties=True)
    _compare_decode(want, run_slab_decode(pk, True, "cpu"), pk)


def test_run_slab_decode_matches_pallas_interpret_f32():
    pk = _merged(np.float32, 126)
    old = pallas_kernel.FORCE_INTERPRET
    pallas_kernel.FORCE_INTERPRET = True
    try:
        want = jbatch.run_packed_compact(pk, "pallas")
    finally:
        pallas_kernel.FORCE_INTERPRET = old
    _compare_decode(want, run_slab_decode(pk, False, "cpu"), pk)


# ---------------------------------------------------------------------------
# (b), (c): LiksView and the callers on the same planes


def _staged_planes(bam, fa, wf, params):
    """The good windows of `wf`, staged by the port's engine and packed
    as one float64 slab; per window (entry, pk, dense pk, the JAX XLA
    program's planes with exact ties)."""
    eng = BatchedWindowEngine([bam], fa, params, device="cpu",
                              dtype=np.float64, exact_ties=True)
    entries = [e for e in eng.staged_windows(wf)
               if e["error"] is None and not e["skip"] and e["haps"]]
    eng.close()
    H_pad = _round_up(max(h.size() for e in entries for h in e["haps"]), 16)
    L_pad = _round_up(max(r.size() for e in entries for r in e["reads"]), 16)
    pks = [pack_pairs_compact(e["haps"], e["reads"], e["left_pos"],
                              params.obs_params, np.float64, H_pad=H_pad,
                              L_pad=L_pad) for e in entries]
    planes = [np.asarray(a) for a in jbatch.run_packed_compact(
        pad_compact(merge_compact(pks)), "xla", exact_ties=True)]
    out = []
    off = 0
    for e, pk in zip(entries, pks):
        B = pk["hap_len"].shape[0]
        dense = dict(H_pad=H_pad, L_pad=L_pad, hap_len=pk["hap_len"],
                     read_len=pk["read_len"],
                     hap_codes=pk["hap_codes_h"][pk["hap_idx"]],
                     read_codes=pk["read_codes_r"][pk["read_idx"]])
        out.append((e, pk, dense, [a[off:off + B] for a in planes]))
        off += B
    assert len(out) >= 2
    return out


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """The windows of the seed-13 sim (tests/test_liks_view.py) on the
    JAX XLA float64 program's planes."""
    tmp = tmp_path_factory.mktemp("decode")
    fa, bam, wfs = _sim_windows(
        tmp, [PlantedVariant(pos=700, var="-ACG", genotype=1),
              PlantedVariant(pos=1500, var="+TT", genotype=2),
              PlantedVariant(pos=2300, var="-T", genotype=1)],
        SimConfig(ref_len=3000, coverage=18, read_len=70), 13)
    params = _params(tmp, "x")
    return params, [(e, dense, planes) for e, _pk, dense, planes
                    in _staged_planes(bam, fa, wfs[0], params)]


def _views(params, e, dense, planes):
    args = (e["haps"], e["reads"], dense, *planes, params.obs_params)
    return jbatch.LiksView(*args), LiksView(*args)


_ARRAYS = ("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on", "fb", "lb",
           "n_bqt", "n_mm_bqt", "n_mm_left", "n_mm_right", "num_mm",
           "m_log_bq", "has_event", "any_mism", "ll2d", "off_hap2d",
           "off_hap_hmq2d")
_COLUMNS = ("xs", "hpos_all", "ins_all", "noins_on", "mism")


def _fields(mls):
    """Nested lists of MLAlignments as plain dicts (nested variants
    included)."""
    if isinstance(mls, list):
        return [_fields(m) for m in mls]
    return dataclasses.asdict(mls)


@pytest.mark.parametrize("decode", ["native", "numpy"])
def test_liks_view_matches_jax(decoded, monkeypatch, decode):
    from dindel_tpu.hmm.decode_native import native_lib
    if decode == "numpy":
        monkeypatch.setenv("DINDEL_DECODE", "py")
    else:
        monkeypatch.delenv("DINDEL_DECODE", raising=False)
        if native_lib() is None:
            pytest.skip("native decode unavailable (no g++)")
    params, out = decoded
    n_events = 0
    for e, dense, planes in out:
        jv, tv = _views(params, e, dense, planes)
        assert tv.nh == jv.nh and tv.nr == jv.nr and len(tv) == len(jv)
        for k in _ARRAYS:
            w, g = getattr(jv, k), getattr(tv, k)
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        valid = _consumed(dense["read_len"], dense["L_pad"])
        for k in _COLUMNS:
            assert np.array_equal(getattr(tv, k)[valid],
                                  getattr(jv, k)[valid]), k
        assert np.array_equal(tv.del_ev[valid[:, 1:]],
                              jv.del_ev[valid[:, 1:]])
        for h in range(tv.nh):
            assert np.array_equal(tv.n_indel_entries_row(h),
                                  jv.n_indel_entries_row(h))
            for r in range(tv.nr):
                assert tv.events(h, r) == jv.events(h, r)
                n_events += tv.events(h, r) is not None
        # the packages' MLAlignment classes differ: compare field by field
        assert _fields(tv.materialize()) == _fields(jv.materialize())
        assert ([_fields(list(row)) for row in tv]
                == [_fields(list(row)) for row in jv])
    assert n_events > 0  # the event decode is exercised


def test_filter_and_diploid_glf_match_jax(decoded):
    params, out = decoded
    n_rows = 0
    for e, dense, planes in out:
        jv, tv = _views(params, e, dense, planes)
        params.tid = e["tid"]
        res = []
        for view, filt, call in ((jv, jax_filter, jax_diploid_glf),
                                 (tv, filter_haplotypes, diploid_glf)):
            for do_filter in (False, True):
                filtered, var_cov = filt(e["haps"], e["reads"], view, params,
                                         do_filter)
                buf = io.StringIO()
                rows = call(e["haps"], e["reads"], view, e["pos"],
                            e["left_pos"], e["right_pos"],
                            make_glf_output(buf), e["index"],
                            e["candidates"], params, filtered, var_cov, "dip")
                res.append((filtered, var_cov, rows, buf.getvalue()))
        assert res[:2] == res[2:]
        n_rows += len(res[2][2])
    assert n_rows > 0


# ---------------------------------------------------------------------------
# (e), (f): the engine's realigned BAMs and --opl dumps


def _ra_records(prefix):
    paths = sorted(glob.glob(prefix + ".ra.*.bam"))
    return [(p[len(prefix):], [(r.qname, r.pos, r.cigar, r.flag)
                               for r in BamReader(p)]) for p in paths]


def test_engine_realigned_bam_matches_jax(tmp_path):
    """The sim of test_batched_realigned_bam_equals_streaming."""
    fa, bam, wfs = _sim_windows(
        tmp_path, [PlantedVariant(pos=600, var="-TGCA", genotype=2)],
        SimConfig(ref_len=1300, coverage=15, read_len=70), 5)
    jeng = JaxEngine([bam], fa,
                     _params(tmp_path, "a", output_realigned_bam=True),
                     batch_windows=8, dp_impl="xla", dtype=np.float64)
    rows_a, glf_a = _run(jeng, wfs[:1], str(tmp_path / "a.glf.txt"))
    assert jeng.stats.stage_seconds.get("slab_rescues", 0) == 0
    eng = BatchedWindowEngine(
        [bam], fa, _params(tmp_path, "b", output_realigned_bam=True),
        device="cpu", batch_windows=8, dtype=np.float64, exact_ties=True)
    rows_b, glf_b = _run(eng, wfs[:1], str(tmp_path / "b.glf.txt"))
    assert eng.stats.windows_ok >= 1, eng.stats.error_messages
    assert "dip.map" in glf_b
    assert glf_b == glf_a and rows_b == rows_a
    ra_a = _ra_records(str(tmp_path / "a"))
    ra_b = _ra_records(str(tmp_path / "b"))
    assert ra_a and any(recs for _, recs in ra_a)
    assert ra_b == ra_a


_OPL = (".*.liks", ".*.hapvars", ".*.hapfreqs", ".check.txt")


def test_engine_opl_dumps_match_jax(tmp_path):
    """--opl with both callers (the sim of tests/test_engine_misc.py):
    the GLF and every dump file byte-equal to the JAX engine's."""
    fa, bam, wfs = _sim_windows(
        tmp_path, [PlantedVariant(pos=600, var="-TG", genotype=1)],
        SimConfig(ref_len=1300, coverage=18, read_len=70), 9)
    kw = dict(estimate_hap_freqs=True, output_pooled_likelihoods=True)
    jeng = JaxEngine([bam], fa, _params(tmp_path / "j", "o", **kw),
                     batch_windows=8, dp_impl="xla", dtype=np.float64)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    _, glf_a = _run(jeng, wfs[:1], str(tmp_path / "j" / "o.glf.txt"))
    eng = BatchedWindowEngine([bam], fa, _params(tmp_path / "t", "o", **kw),
                              device="cpu", batch_windows=8,
                              dtype=np.float64, exact_ties=True)
    _, glf_b = _run(eng, wfs[:1], str(tmp_path / "t" / "o.glf.txt"))
    assert "singlevariant" in glf_b and "dip.map" in glf_b
    assert glf_b == glf_a
    for pat in _OPL:
        got = sorted(glob.glob(str(tmp_path / "t" / ("o" + pat))))
        want = sorted(glob.glob(str(tmp_path / "j" / ("o" + pat))))
        assert got, pat
        assert [p.split("/")[-1] for p in got] == \
            [p.split("/")[-1] for p in want]
        for pg, pw in zip(got, want):
            assert open(pg, "rb").read() == open(pw, "rb").read(), pg


# ---------------------------------------------------------------------------
# (g): sentinel-flank slabs


@pytest.fixture(scope="module")
def sentinel_sim(tmp_path_factory):
    """The seed-13 sim of test_batched_equals_streaming; with a 62-base
    flank two of its three windows reach the sentinel codes."""
    tmp = tmp_path_factory.mktemp("sentinel")
    fa, bam, wfs = _sim_windows(
        tmp, [PlantedVariant(pos=700, var="-ACG", genotype=1),
              PlantedVariant(pos=1500, var="+TT", genotype=2),
              PlantedVariant(pos=2300, var="-T", genotype=1)],
        SimConfig(ref_len=3000, coverage=18, read_len=70), 13)
    return tmp, fa, bam, wfs


def _flank_params(tmp, tag):
    p = _params(tmp, tag)
    p.obs_params.pad_cover = 62
    return p


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_engine_sentinel_slabs_match_jax(sentinel_sim, monkeypatch, dtype):
    """Each window its own slab (max_pairs_per_slab 1): both routes run
    in one pass.  float64 exact ties against the JAX float64 engine;
    float32 fast ties against the JAX XLA float32 engine."""
    tmp, fa, bam, wfs = sentinel_sim
    tag = np.dtype(dtype).name
    jeng = JaxEngine([bam], fa, _flank_params(tmp, "j" + tag),
                     batch_windows=8, dp_impl="xla", dtype=dtype,
                     max_pairs_per_slab=1)
    _, glf_a = _run(jeng, wfs[:1], str(tmp / f"j{tag}.glf.txt"))
    assert jeng.stats.stage_seconds.get("slab_rescues", 0) == 0
    routes = []
    for name in ("run_slab_stats", "run_slab_decode"):
        real = getattr(tbatched, name)

        def spy(*a, _real=real, _name=name, **k):
            routes.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(tbatched, name, spy)
    eng = BatchedWindowEngine([bam], fa, _flank_params(tmp, "t" + tag),
                              device="cpu", batch_windows=8, dtype=dtype,
                              exact_ties=dtype == np.float64,
                              device_folds=False, max_pairs_per_slab=1)
    _, glf_b = _run(eng, wfs[:1], str(tmp / f"t{tag}.glf.txt"))
    assert routes.count("run_slab_decode") >= 1, routes
    assert routes.count("run_slab_stats") >= 1, routes
    assert sum(ln.startswith("ok") for ln in glf_b.splitlines()) > 0
    assert glf_b == glf_a
