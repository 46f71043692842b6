"""The slab programs: expand -> DP -> finish, then either pair stats and
window folds (device-call route) or nothing more (full-decode route);
and the dense program: DP -> finish on per-pair arrays.

``run_slab_stats`` is the counterpart of
``dindel_tpu.hmm.batch.run_slab_stats_fused`` + ``_finish_stats_call``
(batch.py:766-887): one compact slab of many windows in, six small
result planes out.  ``run_slab_decode`` is the counterpart of
``run_packed_compact`` / ``_compact_core`` (batch.py:710-760): it
returns the finish outputs, map_state included, for the host decode
(hmm/liks.py LiksView).  ``run_packed`` is the counterpart of
``dindel_tpu.hmm.batch.run_packed`` (batch.py:413-443): one dense pk
(pack.pack_pairs: a streaming window, or a batched engine's insert-prior
slab) in, the same outputs as ``run_slab_decode`` out.  The (L_pad-1,
B, S_half) backpointer planes never leave any program; the results stay
on the device until the caller fetches them."""

from __future__ import annotations

import numpy as np
import torch

from .dp_kernel import pair_hmm_dp
from .dp_ref import dp_bounds
from .expand import expand_compact
from .finish import finish
from .pack import compute_obs_mid, tables_to_device
from .stats import pair_stats
from ..infer.device_call import window_call


def run_slab_stats(pk: dict, vtab: dict, callmeta: dict, max_mismatch: int,
                   exact_ties: bool, device_folds: bool, device):
    """Run one compact slab (pk from pack.pad_compact(merge_compact(..)))
    on `device`.

    vtab: per-hap variant flank tables aligned with the compact hap
    tables (v_left_h/v_right_h (rows, V) int32, v_isdel_h/v_valid_h
    (rows, V) bool).  callmeta: W, NH, S, NR and the index_map/nr_w/
    pair_pr arrays of the per-window folds; pair_pr's dtype is the
    folds' dtype.  Returns device tensors

      f_plane  (B, 3)    ll, ll_off, ll_on
      m_log_bq (B,)      float64
      i_plane  (B, 8)    int32: fb, lb, n_bqt, n_mm_bqt, n_mm_left,
                         n_mm_right, num_mm, n_ind
      b_plane  (B, 4+V)  bool: off_hap, off_hap_hmq, has_event,
                         any_mism, then cov_ok per variant slot
      base, site         the window folds (W, NP), (W, S, NP), or empty
                         when device_folds is False (host folds)."""
    H_pad, L_pad = pk["H_pad"], pk["L_pad"]
    t = tables_to_device(pk, device)
    ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state = _core(
        pk, t, exact_ties)
    vt = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in vtab.items()}
    V = vtab["v_left_h"].shape[1]
    (fb, lb, n_bqt, n_mm_bqt, m_log_bq, n_mm_left, n_mm_right, num_mm,
     has_event, any_mism, n_ind, cov_ok) = pair_stats(
        H_pad, L_pad, V, map_state, t["read_len"], t["hap_len"],
        t["read_idx"], t["hap_idx"], t["read_codes_r"], t["hap_codes_h"],
        t["bqt_r"], t["q95_r"], t["log10q_r"], vt["v_left_h"],
        vt["v_right_h"], vt["v_isdel_h"], vt["v_valid_h"], off_hap_hmq,
        max_mismatch)
    cm = callmeta
    if device_folds:
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        base, site = window_call(cm["W"], cm["NH"], cm["S"], cm["NR"], ll,
                                 to(cm["index_map"]), to(cm["nr_w"]),
                                 to(cm["pair_pr"]))
    else:
        base = site = torch.zeros(0, dtype=torch.float64, device=device)
    f_plane = torch.stack([ll, ll_off, ll_on], dim=1)
    i_plane = torch.stack([fb, lb, n_bqt, n_mm_bqt, n_mm_left, n_mm_right,
                           num_mm, n_ind], dim=1).to(torch.int32)
    b_plane = torch.cat([torch.stack([off_hap, off_hap_hmq, has_event,
                                      any_mism], dim=1), cov_ok], dim=1)
    return f_plane, m_log_bq, i_plane, b_plane, base, site


def run_slab_decode(pk: dict, exact_ties: bool, device):
    """Run one compact slab on `device` for the full-decode route.

    Returns device tensors (ll, off_hap, off_hap_hmq, ll_off, ll_on,
    map_state): map_state is (B, L_pad), int16 when every state code
    fits (2*(H_pad+2) < 2**15, as batch.py:737-738 casts it), else
    int32.  Columns at and past a pair's read_len are not defined
    (finish.py); every consumer masks them."""
    t = tables_to_device(pk, device)
    return _narrow_map_state(_core(pk, t, exact_ties), pk["H_pad"])


def run_packed(pk: dict, exact_ties: bool, device):
    """Run one dense pk on `device`: K1 on the per-pair arrays, then
    finish with the host's obs_mid (pack.compute_obs_mid) and the pk's
    prior rows.  Only what K1 and finish consume is uploaded (not the
    JAX package's lpeV/lpnV).  Returns device tensors as
    run_slab_decode."""
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]

    def up(a, dt=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dt if dt is not None else t.dtype)

    hap_len = up(pk["hap_len"], torch.int32)
    b_mid = up(pk["b_mid"], torch.int32)
    alpha_mid, beta_mid, btf, btb = pair_hmm_dp(
        H_pad, L_pad, numT, hap_len, up(pk["read_len"], torch.int32), b_mid,
        up(pk["read_codes"], torch.uint8), up(pk["hap_codes"], torch.uint8),
        up(pk["eq"]), up(pk["uq"]), up(pk["lpe"]), up(pk["lpn"]),
        pk["scalars"], exact_ties=exact_ties,
        bounds=dp_bounds(pk["read_len"], pk["b_mid"], L_pad))
    out = finish(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid, beta_mid,
                 up(compute_obs_mid(pk)), up(pk["prior_rmq"]),
                 up(pk["prior_hmq"]), btf, btb, exact_ties=exact_ties)
    return _narrow_map_state(out, H_pad)


def _narrow_map_state(out, H_pad):
    """map_state as int16 when every state code fits (batch.py:439-442)."""
    if 2 * (H_pad + 2) < 2 ** 15:
        out = out[:-1] + (out[-1].to(torch.int16),)
    return out


def _core(pk: dict, t: dict, exact_ties: bool):
    """expand -> K1 -> finish on the tables `t` (pack.tables_to_device)."""
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
    (read_codes, eq, uq, hap_codes, lpe, lpn, prior_rmq, prior_hmq,
     obs_mid) = expand_compact(
        H_pad, L_pad, t["eq_r"].dtype, t, (pk["log_off_hmq"], pk["log_on_hmq"]),
        (pk["log_ins0"], pk["log_ins1"]))
    alpha_mid, beta_mid, btf, btb = pair_hmm_dp(
        H_pad, L_pad, numT, t["hap_len"], t["read_len"], t["b_mid"],
        read_codes, hap_codes, eq, uq, lpe, lpn, pk["scalars"],
        exact_ties=exact_ties,
        bounds=dp_bounds(pk["read_len"], pk["b_mid"], L_pad))
    return finish(H_pad, L_pad, numT, t["b_mid"], t["hap_len"], alpha_mid,
                  beta_mid, obs_mid, prior_rmq, prior_hmq, btf, btb,
                  exact_ties=exact_ties)
