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
slab) in, the same outputs as ``run_slab_decode`` out.
``run_slab_decode_sharded`` is the counterpart of
``run_packed_compact_sharded`` (batch.py:932-1015): the compact program
with its pair axis split over the devices of a ``parallel.mesh.Mesh``;
``run_slab_stats(mesh=...)`` shards the same part and runs the stats and
folds on the gathered outputs.  The (L_pad-1, B, S_half) backpointer
planes never leave any program; the results stay on the device until the
caller fetches them."""

from __future__ import annotations

import numpy as np
import torch

from .dp_kernel import pair_hmm_dp
from .dp_ref import dp_bounds
from .epilogue_kernel import finish, pair_stats, window_call
from .expand import expand_compact
from .pack import _round_up, compute_obs_mid, tables_to_device


def run_slab_stats(pk: dict, vtab: dict, callmeta: dict, max_mismatch: int,
                   exact_ties: bool, device_folds: bool, device, mesh=None):
    """Run one compact slab (pk from pack.pad_compact(merge_compact(..)))
    on `device`; with a `mesh`, expand -> DP -> finish run sharded over
    it (run_slab_decode_sharded) and the stats and folds on `device`
    (the engine passes the mesh's first device).

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
    if mesh is None:
        out = _core(pk, t, exact_ties, _bounds(pk))
    else:
        out = [o.to(device)
               for o in run_slab_decode_sharded(pk, exact_ties, mesh)]
    ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state = out
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
    return _narrow_map_state(_core(pk, t, exact_ties, _bounds(pk)),
                             pk["H_pad"])


_PAIR_KEYS = ("hap_idx", "read_idx", "hap_len", "read_len", "b_mid")


def run_slab_decode_sharded(pk: dict, exact_ties: bool, mesh):
    """run_slab_decode with the slab's pair axis split over every device
    of `mesh` (dp-major): padded to a multiple of the device count with
    clones of the last real pair, cut into contiguous shards; the read
    and hap tables are replicated to every shard's device.  Each shard
    runs expand -> DP -> finish on its own device with the whole slab's
    DP bounds (so it computes exactly what the single-device program
    computes for its pairs); the outputs are moved to the mesh's first
    device, concatenated and sliced back to the slab's pairs."""
    devs = mesh.flat
    B = pk["hap_idx"].shape[0]
    per = _round_up(B, len(devs)) // len(devs)
    bounds = _bounds(pk)
    parts = []
    for s, dev in enumerate(devs):
        rows = np.minimum(np.arange(s * per, (s + 1) * per), B - 1)
        shard = dict(pk, **{k: np.asarray(pk[k])[rows] for k in _PAIR_KEYS})
        out = _narrow_map_state(
            _core(shard, tables_to_device(shard, dev), exact_ties, bounds),
            pk["H_pad"])
        parts.append([o.to(mesh.first) for o in out])
    return tuple(torch.cat(col)[:B] for col in zip(*parts))


# the dense pk arrays run_packed consumes (the JAX package's lpeV/lpnV
# serve only its XLA DP), besides H_pad, L_pad, numT and scalars
DENSE_KEYS = ("hap_len", "read_len", "b_mid", "read_codes", "hap_codes",
              "eq", "uq", "lpe", "lpn", "prior_rmq", "prior_hmq")


def run_packed(pk: dict, exact_ties: bool, device):
    """Run one dense pk on `device`: K1 on the per-pair arrays, then
    finish with the host's obs_mid (pack.compute_obs_mid) and the pk's
    prior rows.  Only DENSE_KEYS are uploaded.  Returns device tensors as
    run_slab_decode."""
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]

    def up(a, dt=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dt if dt is not None else t.dtype)

    hap_len = up(pk["hap_len"], torch.int32)
    read_len = up(pk["read_len"], torch.int32)
    b_mid = up(pk["b_mid"], torch.int32)
    alpha_mid, beta_mid, btf, btb = pair_hmm_dp(
        H_pad, L_pad, numT, hap_len, read_len, b_mid,
        up(pk["read_codes"], torch.uint8), up(pk["hap_codes"], torch.uint8),
        up(pk["eq"]), up(pk["uq"]), up(pk["lpe"]), up(pk["lpn"]),
        pk["scalars"], exact_ties=exact_ties,
        bounds=_bounds(pk))
    out = finish(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid, beta_mid,
                 up(compute_obs_mid(pk)), up(pk["prior_rmq"]),
                 up(pk["prior_hmq"]), btf, btb, exact_ties=exact_ties,
                 read_len=read_len)
    return _narrow_map_state(out, H_pad)


def _narrow_map_state(out, H_pad):
    """map_state as int16 when every state code fits (batch.py:439-442)."""
    if 2 * (H_pad + 2) < 2 ** 15:
        out = out[:-1] + (out[-1].to(torch.int16),)
    return out


def _bounds(pk: dict):
    return dp_bounds(pk["read_len"], pk["b_mid"], pk["L_pad"])


def _core(pk: dict, t: dict, exact_ties: bool, bounds):
    """expand -> K1 -> finish on the tables `t` (pack.tables_to_device),
    the DP over the anchor bounds `bounds` (dp_ref.dp_bounds)."""
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
    (read_codes, eq, uq, hap_codes, lpe, lpn, prior_rmq, prior_hmq,
     obs_mid) = expand_compact(
        H_pad, L_pad, t["eq_r"].dtype, t, (pk["log_off_hmq"], pk["log_on_hmq"]),
        (pk["log_ins0"], pk["log_ins1"]))
    alpha_mid, beta_mid, btf, btb = pair_hmm_dp(
        H_pad, L_pad, numT, t["hap_len"], t["read_len"], t["b_mid"],
        read_codes, hap_codes, eq, uq, lpe, lpn, pk["scalars"],
        exact_ties=exact_ties, bounds=bounds)
    return finish(H_pad, L_pad, numT, t["b_mid"], t["hap_len"], alpha_mid,
                  beta_mid, obs_mid, prior_rmq, prior_hmq, btf, btb,
                  exact_ties=exact_ties, read_len=t["read_len"])
