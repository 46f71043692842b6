"""dindel_tpu_torch slab program vs the JAX package: expand, pair stats,
window folds and the whole run_slab_stats against run_slab_stats_fused.

Tolerances: every comparison is exact except the window folds' exp/log
(torch's and XLA's libm differ by ulps): 1e-6 relative in float32 and
1e-12 in float64."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dindel_tpu.hmm.pallas_kernel as pallas_kernel
from dindel_tpu.config import ObservationModelParameters
from dindel_tpu.hmm.batch import (_expand_compact, _pair_stats,
                                  merge_compact, pack_pairs_compact,
                                  pad_compact, run_packed_compact,
                                  run_slab_stats_fused)
from dindel_tpu.infer.device_call import _window_call, pair_enum
from dindel_tpu_torch.hmm.expand import expand_compact
from dindel_tpu_torch.hmm.pack import tables_to_device
from dindel_tpu_torch.hmm.slab import run_slab_stats
from dindel_tpu_torch.hmm.stats import pair_stats
from dindel_tpu_torch.infer.device_call import window_call
from dindel_tpu_torch.parallel.mesh import synth_windows

torch.set_num_threads(1)

MAX_MM = 2
V = 4


def _merged(dtype, H_pad, L_pad=32):
    windows = synth_windows(3, nh=3, nr=12, H=60, L=30, seed=2)
    params = ObservationModelParameters()
    pks = [pack_pairs_compact(haps, reads, hs, params, dtype, H_pad=H_pad,
                              L_pad=L_pad)
           for haps, reads, hs in windows]
    return pad_compact(merge_compact(pks))


def _vtab(merged, seed=5):
    """Variant flank slots with mixed widths, some reaching below 0 (the
    LO sentinel and negative-index wrap) and some invalid."""
    rng = np.random.RandomState(seed)
    n = merged["hap_codes_h"].shape[0]
    left = rng.randint(-4, 50, size=(n, V)).astype(np.int32)
    return dict(v_left_h=left,
                v_right_h=(left + rng.randint(0, 8, size=(n, V))
                           ).astype(np.int32),
                v_isdel_h=rng.rand(n, V) < 0.5,
                v_valid_h=rng.rand(n, V) < 0.8)


def _callmeta(dtype, seed=6):
    """Three windows of 3 haps x 12 reads, laid out as the engine does."""
    rng = np.random.RandomState(seed)
    W, NH, S, NR = 8, 4, 4, 64
    NP = len(pair_enum(NH)[0])
    index_map = np.zeros((W, NH, NR), np.int32)
    nr_w = np.zeros(W, np.int32)
    for w in range(3):
        index_map[w, :3, :12] = (w * 36 + np.arange(3)[:, None] * 12
                                 + np.arange(12)[None, :])
        nr_w[w] = 12
    pair_pr = (-rng.rand(W, S, NP) * 10).astype(dtype)
    return dict(W=W, NH=NH, S=S, NR=NR, index_map=index_map, nr_w=nr_w,
                pair_pr=pair_pr)


def test_expand_matches_jax():
    pk = _merged(np.float64, 78)
    dt = np.dtype(np.float64)
    want = _expand_compact(
        pk["H_pad"], pk["L_pad"], dt.str,
        *[jnp.asarray(pk[k]) for k in (
            "read_codes_r", "eq_r", "uq_r", "hap_codes_h", "lpe_h", "lpn_h",
            "lpeV_h", "lpnV_h", "hap_idx", "read_idx", "hap_len", "b_mid",
            "log_off_r", "log_on_r")],
        (pk["log_off_hmq"], pk["log_on_hmq"]), (pk["log_ins0"], pk["log_ins1"]))
    want = [np.asarray(w) for i, w in enumerate(want) if i not in (6, 7)]
    got = expand_compact(pk["H_pad"], pk["L_pad"], torch.float64,
                         tables_to_device(pk, "cpu"),
                         (pk["log_off_hmq"], pk["log_on_hmq"]),
                         (pk["log_ins0"], pk["log_ins1"]))
    names = ("read_codes", "eq", "uq", "hap_codes", "lpe", "lpn",
             "prior_rmq", "prior_hmq", "obs_mid")
    for nm, w, g in zip(names, want, got):
        assert np.array_equal(g.numpy(), w), nm


def test_pair_stats_matches_jax():
    pk = _merged(np.float64, 78)
    vtab = _vtab(pk)
    out = [np.array(o) for o in run_packed_compact(pk, "xla")]
    map_state, off_hap_hmq = out[5], out[2]
    jk = ("read_len", "hap_len", "read_idx", "hap_idx", "read_codes_r",
          "hap_codes_h", "bqt_r", "q95_r", "log10q_r")
    want = _pair_stats(pk["H_pad"], pk["L_pad"], V, jnp.asarray(map_state),
                       *[jnp.asarray(pk[k]) for k in jk],
                       *[jnp.asarray(vtab[k]) for k in (
                           "v_left_h", "v_right_h", "v_isdel_h",
                           "v_valid_h")],
                       jnp.asarray(off_hap_hmq), jnp.asarray(np.int32(MAX_MM)))
    t = tables_to_device(pk, "cpu")
    got = pair_stats(pk["H_pad"], pk["L_pad"], V, torch.from_numpy(map_state),
                     *[t[k] for k in jk],
                     *[torch.from_numpy(vtab[k]) for k in (
                         "v_left_h", "v_right_h", "v_isdel_h", "v_valid_h")],
                     torch.from_numpy(off_hap_hmq), MAX_MM)
    names = ("fb", "lb", "n_bqt", "n_mm_bqt", "m_log_bq", "n_mm_left",
             "n_mm_right", "num_mm", "has_event", "any_mism", "n_ind",
             "cov_ok")
    for nm, w, g in zip(names, want, got):
        assert np.array_equal(g.numpy(), np.asarray(w)), nm
    assert np.asarray(want[-1]).any()  # the coverage fold is exercised


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-12)])
def test_window_call_matches_jax(dtype, rtol):
    rng = np.random.RandomState(0)
    nh, nr, S = 4, 37, 3
    ll = -rng.gamma(2.0, 40.0, size=nh * nr).astype(np.float32)
    W, NH, NR = 8, nh, 64
    NP = len(pair_enum(NH)[0])
    index_map = np.zeros((W, NH, NR), np.int32)
    index_map[0, :nh, :nr] = (np.arange(nh)[:, None] * nr
                              + np.arange(nr)[None, :])
    nr_w = np.zeros(W, np.int32)
    nr_w[0] = nr
    pp = np.zeros((W, 4, NP), dtype)
    pp[0, :S] = -rng.rand(S, NP) * 10
    wb, ws = _window_call(W, NH, 4, NR, jnp.asarray(ll),
                          jnp.asarray(index_map), jnp.asarray(nr_w),
                          jnp.asarray(pp))
    gb, gs = window_call(W, NH, 4, NR, torch.from_numpy(ll),
                         torch.from_numpy(index_map), torch.from_numpy(nr_w),
                         torch.from_numpy(pp))
    assert gb.dtype == gs.dtype == torch.from_numpy(pp).dtype
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=rtol)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=rtol)


def _compare_planes(want, got, V_):
    f_w, m_w, i_w, b_w = [np.asarray(a) for a in want[:4]]
    f_g, m_g, i_g, b_g = [a.numpy() for a in got[:4]]
    assert np.array_equal(f_g, f_w)
    assert np.array_equal(m_g, m_w)
    assert np.array_equal(i_g, i_w.astype(np.int32))
    assert np.array_equal(b_g, np.unpackbits(b_w, axis=1, count=4 + V_)
                          .astype(bool))


@pytest.mark.parametrize("device_folds", [False, True])
def test_run_slab_stats_matches_fused_xla_f64(device_folds):
    """float64, exact ties: bit-equal to the XLA slab program; the
    window folds within the stated exp/log tolerance."""
    pk = _merged(np.float64, 78)
    vtab = _vtab(pk)
    cm = _callmeta(np.float64)
    want = run_slab_stats_fused(pk, "xla", vtab, cm, MAX_MM, exact_ties=True,
                                do_call=device_folds)
    got = run_slab_stats(pk, vtab, cm, MAX_MM, exact_ties=True,
                         device_folds=device_folds, device="cpu")
    _compare_planes(want, got, V)
    if device_folds:
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   rtol=1e-12)
        np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                                   rtol=1e-12)
    else:
        assert got[4].numel() == got[5].numel() == 0


def test_run_slab_stats_matches_fused_pallas_interpret_f32():
    """The shipped configuration (fast ties, argmax finish, float32):
    bit-equal to the Pallas slab program in interpret mode."""
    pk = _merged(np.float32, 126)
    vtab = _vtab(pk)
    cm = _callmeta(np.float64)
    old = pallas_kernel.FORCE_INTERPRET
    pallas_kernel.FORCE_INTERPRET = True
    try:
        want = run_slab_stats_fused(pk, "pallas", vtab, cm, MAX_MM,
                                    do_call=False)
    finally:
        pallas_kernel.FORCE_INTERPRET = old
    got = run_slab_stats(pk, vtab, cm, MAX_MM, exact_ties=False,
                         device_folds=False, device="cpu")
    _compare_planes(want, got, V)

