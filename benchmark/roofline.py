"""The least time an H100 could take for each kernel launch, from the
launch's shapes alone: the larger of its bytes over the memory rate and
its operations over the float rate of its type.

A frozen copy of the bound functions of the repository's smoke test
(dp_bound, finish_bound, stats_bound, window_bound, walked_steps and the
peaks): they count the work the algorithm needs for the shapes, the same
work whatever implements it, so they stay fixed while the kernels
change."""

from __future__ import annotations

import numpy as np

# one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s and the
# float32 and float64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def bound(nbytes, ops, itemsize):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float rate of the type."""
    rate = F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dp_bound(B, H_pad, L_pad, numT, bounds, itemsize=4):
    """The pair-HMM DP (K1) over B pairs: (bound_ms, bound_by,
    state_steps).  Bytes: every input read once, amid/bmid and the
    backpointer rows the call writes (MB forward and L_act-1-MN backward
    rows of B*S_half bytes) written once.  Operations: per state-step the
    two emission adds, the noins fold (numT candidates, two adds and a
    compare each at most) and the ins fold (two candidates): 3*numT + 5
    float adds and compares."""
    L_act, MB, MN = bounds
    SP = H_pad + 2
    steps = MB + (L_act - 1 - MN)
    state_steps = B * SP * steps
    read = B * (3 * 4 + L_pad + H_pad + 2 * L_pad * itemsize
                + 2 * SP * itemsize)
    written = 2 * B * 2 * SP * itemsize + state_steps
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    rate = F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S
    t_ops = state_steps * (3 * numT + 5) / rate * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", state_steps
    return t_ops, "operations", state_steps


def dp_pair_bound(hap_len, read_len, b_mid, L_pad, numT, itemsize=4):
    """K1 over one launch's pairs, each counted from its own lengths:
    (bound_ms, bound_by, state_steps).  Pair i has hap_len_i + 2 states
    and r_i = max(2, min(read_len_i, L_pad)) read bases; the forward
    pass runs its rows to the anchor a_i = min(b_mid_i, r_i - 1), the
    backward pass from the read's end down to it: a_i + (r_i - 1 - a_i)
    row steps.  Bytes and operations per state step as dp_bound's."""
    h = np.asarray(hap_len, np.int64)
    r = np.clip(np.asarray(read_len, np.int64), 2, max(2, L_pad))
    a = np.clip(np.asarray(b_mid, np.int64), 0, r - 1)
    sp = h + 2
    state_steps = int((sp * (a + (r - 1 - a))).sum())
    read = int((3 * 4 + r + h + 2 * r * itemsize + 2 * sp * itemsize).sum())
    written = int((2 * 2 * sp * itemsize).sum()) + state_steps
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    rate = F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S
    t_ops = state_steps * (3 * numT + 5) / rate * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", state_steps
    return t_ops, "operations", state_steps


def walked_steps(b_mid, read_len, L_pad):
    """Backpointer rows the finish kernel reads: the down walk from the
    anchor column and the up walk to the read's end."""
    a = np.clip(np.asarray(b_mid, np.int64), 0, L_pad - 1)
    last = np.minimum(L_pad - 2, np.asarray(read_len, np.int64) - 2)
    return int((a + np.maximum(0, last - a + 1)).sum())


def finish_bound(B, S, L_pad, steps, itemsize):
    """finish (K2).  Bytes: the five (B, S) rows, b_mid, hap_len and
    read_len read once, one backpointer byte per walked step, the outputs
    written once.  Operations: per state the four adds and four compares
    of the folds."""
    nbytes = (5 * B * S * itemsize + 3 * B * 4 + steps
              + 3 * B * itemsize + 2 * B + B * L_pad * 4)
    return bound(nbytes, 8 * B * S, itemsize)


def finish_pair_bound(hap_len, read_len, b_mid, L_pad, itemsize):
    """finish (K2) over one launch's pairs, each counted from its own
    lengths: finish_bound's bytes and operations with each pair's
    2 * (hap_len_i + 2) states and its read_len_i MAP-path entries in
    place of the launch's padded widths."""
    h = np.asarray(hap_len, np.int64)
    r = np.minimum(np.asarray(read_len, np.int64), L_pad)
    B = h.shape[0]
    S = 2 * (h + 2)
    steps = walked_steps(b_mid, read_len, L_pad)
    nbytes = (int((5 * S * itemsize).sum()) + 3 * B * 4 + steps
              + 3 * B * itemsize + 2 * B + int((r * 4).sum()))
    return bound(nbytes, int((8 * S).sum()), itemsize)


def stats_bound(B, L_pad, V, nr, nh, H_pad, cols):
    """pair_stats (K3).  Bytes: map_state, the per-pair vectors, the read
    and hap tables and the slot tables read once, the outputs written
    once.  Operations: the float64 m_log_bq adds over the `cols` read
    columns (the integer work is not counted)."""
    nbytes = (B * L_pad * 4 + B * (4 + 4 + 8 + 8 + 1)
              + nr * L_pad * (1 + 1 + 1 + 8) + nh * H_pad
              + nh * V * (4 + 4 + 1 + 1) + B * (8 * 4 + 8 + 2) + B * V)
    return bound(nbytes, cols, 8)


def window_bound(W, NH, S, NR, nreads, itemsize):
    """window_call (K4).  Bytes: the ll values the windows read,
    index_map, nr_w and pair_pr read once, base and site written once.
    Operations: per (window, pair, read) the eight of t (max, min, sub,
    exp, add, log, add, add; exp and log counted as one each) and the
    S+1 fold adds."""
    NP = NH * (NH + 1) // 2
    nbytes = (nreads * NH * itemsize + W * NH * NR * 4 + W * 4
              + W * S * NP * itemsize + W * (S + 1) * NP * itemsize)
    return bound(nbytes, nreads * NP * (8 + S + 1), itemsize)
