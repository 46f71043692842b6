"""dindel_tpu_torch pooled caller vs the JAX package, on the CPU.

- em_inputs and estimate_hap_freqs_bayes_em against the originals on
  the same liks (LiksView and LiksStats): arrays, rows and GLF bytes
  equal;
- the batched VB-EM (infer/device_em.py) against the JAX
  run_batched_em in float64 to 1e-6 relative, and against the host
  loop;
- the engine's pooled GLF against the JAX BatchedWindowEngine with the
  host EM in float64: byte-equal; with the device EM in float32 against
  JAX's device EM and against the port's own host EM, within the
  tolerance of tests/test_device_em.py (rtol 2e-3, abs 1e-2): the
  device EM uses another digamma and dense reductions."""

import io
import math

import numpy as np
import pytest
import torch

import dindel_tpu.engine.batched as jax_batched_mod
import dindel_tpu.hmm.batch as jbatch
import dindel_tpu.infer.pooled as jpooled
from dindel_tpu.engine.batched import BatchedWindowEngine as JaxEngine
from dindel_tpu.infer.device_em import run_batched_em as jax_run_batched_em
from dindel_tpu.out.glf import make_glf_output
from dindel_tpu.sim import PlantedVariant, SimConfig
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.hmm.liks import LiksStats, LiksView
from dindel_tpu_torch.infer import pooled
from dindel_tpu_torch.infer.device_em import run_batched_em
from test_device_em import _compare
from test_torch_decode import _params, _run, _sim_windows, _staged_planes
from test_torch_engine import no_slab_rescues  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pooled_sim(tmp_path_factory):
    """The sim of test_batched_equals_streaming_pooled."""
    tmp = tmp_path_factory.mktemp("pooled")
    fa, bam, wfs = _sim_windows(
        tmp, [PlantedVariant(pos=650, var="-CT", genotype=1),
              PlantedVariant(pos=1500, var="+AC", genotype=1)],
        SimConfig(ref_len=2200, coverage=18, read_len=70), 21)
    return tmp, fa, bam, wfs


def _pooled_params(tmp, tag, program, diploid=False):
    p = _params(tmp, tag, estimate_hap_freqs=True, bayes_type=program)
    p.do_diploid = diploid
    return p


# ---------------------------------------------------------------------------
# the callers on the same liks


@pytest.fixture(scope="module")
def liks_pairs(pooled_sim):
    """Per window: (entry, JAX LiksView, port LiksView, JAX LiksStats,
    port LiksStats), all over the JAX XLA float64 program's planes."""
    tmp, fa, bam, wfs = pooled_sim
    params = _pooled_params(tmp, "x", "singlevariant")
    out = []
    for e, pk, dense, planes in _staged_planes(bam, fa, wfs[0], params):
        args = (e["haps"], e["reads"], dense, *planes, params.obs_params)
        jv, tv = jbatch.LiksView(*args), LiksView(*args)
        fields = {k: getattr(tv, k) for k in (
            "ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on", "fb", "lb",
            "n_bqt", "n_mm_bqt", "m_log_bq", "n_mm_left", "n_mm_right",
            "num_mm", "has_event", "any_mism")}
        fields["n_ind"] = np.concatenate(
            [tv.n_indel_entries_row(h) for h in range(tv.nh)])
        fields["cov_ok"] = np.zeros((len(tv.ll), 1), bool)
        sargs = (e["haps"], e["reads"], params.obs_params, pk["read_len"],
                 pk["hap_len"], fields)
        out.append((e, jv, tv, jbatch.LiksStats(*sargs), LiksStats(*sargs)))
    return params, out


@pytest.mark.parametrize("kind", ["view", "stats"])
@pytest.mark.parametrize("program", ["singlevariant", "all", "priorpersite"])
def test_pooled_callers_match_jax(liks_pairs, program, kind):
    params, out = liks_pairs
    params.bayes_type = program
    n_rows = 0
    for e, jv, tv, js, ts in out:
        jl, tl = (jv, tv) if kind == "view" else (js, ts)
        params.tid = e["tid"]
        filtered = [0] * len(e["haps"])
        filtered[-1] = int(len(e["haps"]) > 2)
        var_cov = {}
        want = jpooled.em_inputs(e["haps"], e["reads"], jl, params,
                                 filtered, program)
        got = pooled.em_inputs(e["haps"], e["reads"], tl, params, filtered,
                               program)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        em = run_batched_em([got], params.bayes_a0, params.em_tol,
                            dtype=np.float64, device="cpu")[0]
        for em_results in (None, em):
            res = []
            for mod, liks in ((jpooled, jl), (pooled, tl)):
                buf = io.StringIO()
                freqs, post, rows = mod.estimate_hap_freqs_bayes_em(
                    e["haps"], e["reads"], liks, e["pos"], e["left_pos"],
                    e["right_pos"], make_glf_output(buf), e["index"],
                    e["candidates"], params, filtered, var_cov, 1, program,
                    em_results=em_results)
                res.append((freqs, [p[1:] for p in post], rows,
                            buf.getvalue()))
            assert res[1] == res[0]
            n_rows += len(res[1][2])
    assert n_rows > 0


# ---------------------------------------------------------------------------
# the batched VB-EM


def _instances(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        nr, nh = rng.randint(5, 90), rng.randint(2, 7)
        rlT = -np.abs(rng.randn(nr, nh)) * rng.uniform(1, 30)
        nav = rng.randint(1, 4)
        compat = rng.rand(nav, nh) < 0.7
        compat[0, 0] = True
        out.append((rlT, compat, compat.sum(axis=1).astype(np.float64)))
    return out


def test_device_em_matches_jax_f64():
    insts = _instances(3, 7)
    want = jax_run_batched_em(insts, 0.001, 1e-4, dtype=np.float64)
    got = run_batched_em(insts, 0.001, 1e-4, dtype=np.float64,
                         device="cpu")
    assert len(got) == len(want) == len(insts)
    for gw, ww, (_rl, cp, _na) in zip(got, want, insts):
        assert len(gw) == len(ww) == cp.shape[0]
        for (gl, gp), (wl, wp), c in zip(gw, ww, cp):
            assert math.isclose(gl, wl, rel_tol=1e-6)
            np.testing.assert_allclose(gp[c], wp[c], rtol=1e-6)
            assert np.array_equal(gp[~c], wp[~c])


def test_device_em_converges_like_host():
    """tests/test_device_em.py::test_device_em_kernel_converges_like_host
    on the port's EM: loglik/pi match the host loop in float64."""
    from dindel_tpu.infer.pooled import digamma

    rng = np.random.RandomState(0)
    nr, nh = 37, 5
    rlT = -np.abs(rng.randn(nr, nh)) * 8.0
    compat = np.array([[1, 1, 0, 1, 1], [1, 0, 0, 0, 1]], bool)
    numah = np.array([4.0, 2.0])
    res = run_batched_em([(rlT, compat, numah)], a0=0.001, tol=1e-4,
                         dtype=np.float64, device="cpu")[0]
    for a in range(2):
        lpi = np.where(compat[a], math.log(1.0 / numah[a]), -100.0)
        e_old = -math.inf
        it = 0
        while True:
            Z = lpi[None, :] + rlT
            lognorm = np.full(nr, -math.inf)
            for h in range(nh):
                lognorm = np.logaddexp(lognorm, Z[:, h])
            zz = np.exp(Z - lognorm[:, None])
            nk = zz.sum(axis=0)
            loglik = lognorm.sum()
            ak = np.where(compat[a], nk + 0.001, 0.0)
            ahat = ak.sum()
            lpi = np.where(compat[a],
                           [digamma(x) - digamma(ahat) if c else 0.0
                            for x, c in zip(ak, compat[a])], -100.0)
            with np.errstate(divide="ignore"):
                pi = np.where(compat[a],
                              np.log((0.001 + nk) / (numah[a] * 0.001 + nr)),
                              -100.0)
            e_new = (zz * (pi[None, :] + rlT)).sum()
            conv = abs(e_old - e_new) < 1e-4 or it > 25
            e_old = e_new
            it += 1
            if conv:
                break
        got_ll, got_pi = res[a]
        assert abs(got_ll - loglik) < 1e-6 * max(1.0, abs(loglik))
        np.testing.assert_allclose(got_pi[compat[a]], pi[compat[a]],
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("program,diploid", [("singlevariant", False),
                                             ("all", True)])
def test_engine_pooled_host_em_matches_jax_f64(pooled_sim, program, diploid):
    tmp, fa, bam, wfs = pooled_sim
    tag = f"{program}{int(diploid)}"
    jeng = JaxEngine([bam], fa, _pooled_params(tmp, "j" + tag, program,
                                               diploid),
                     batch_windows=8, dp_impl="xla", dtype=np.float64)
    rows_a, glf_a = _run(jeng, wfs[:1], str(tmp / f"j{tag}.glf.txt"))
    assert jeng.stats.stage_seconds.get("slab_rescues", 0) == 0
    eng = BatchedWindowEngine([bam], fa, _pooled_params(tmp, "t" + tag,
                                                        program, diploid),
                              device="cpu", batch_windows=8,
                              dtype=np.float64, exact_ties=True)
    assert eng.device_em is False  # float64: the host EM
    rows_b, glf_b = _run(eng, wfs[:1], str(tmp / f"t{tag}.glf.txt"))
    assert eng.stats.windows_ok >= 2, eng.stats.error_messages
    assert program in glf_b and ("dip.map" in glf_b) == diploid
    assert "device_em" not in eng.stats.stage_seconds
    assert glf_b == glf_a and rows_b == rows_a


def test_engine_pooled_device_em_f32(pooled_sim, monkeypatch):
    tmp, fa, bam, wfs = pooled_sim
    monkeypatch.setattr(jax_batched_mod, "FORCE_DEVICE_EM", True)
    jeng = JaxEngine([bam], fa, _pooled_params(tmp, "jdev", "singlevariant"),
                     batch_windows=8, dp_impl="xla", dtype=np.float32)
    _, glf_j = _run(jeng, wfs[:1], str(tmp / "jdev.glf.txt"))
    assert jeng.stats.stage_seconds.get("device_em", 0) > 0
    glfs = {}
    for dev_em in (True, False):
        eng = BatchedWindowEngine(
            [bam], fa, _pooled_params(tmp, f"t{dev_em}", "singlevariant"),
            device="cpu", batch_windows=8, dtype=np.float32,
            device_em=None if dev_em else False)
        assert eng.device_em is dev_em
        _, glfs[dev_em] = _run(eng, wfs[:1], str(tmp / f"t{dev_em}.glf.txt"))
        assert (eng.stats.stage_seconds.get("device_em", 0) > 0) == dev_em
    assert "singlevariant" in glfs[True]
    _compare(glf_j, glfs[True], rtol=2e-3)
    _compare(glfs[False], glfs[True], rtol=2e-3)
