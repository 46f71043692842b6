"""Pooled VB-EM on the device, plain PyTorch: counterpart of
``dindel_tpu.infer.device_em`` (``_em_kernel`` :33, ``run_batched_em``
:87).  Every active set of every pooled window of a batch pads into one
(S, NR, NH) tensor and iterates the reference's VB-EM step
(DInDel.cpp:2431-2523) together.

The JAX kernel is an XLA while-loop that stops once every set has
converged or 27 iterations ran.  Here the loop always runs 27
iterations with no host sync between them: a set freezes at its own
convergence (the loop never moves a frozen set), and every set has
converged after iteration 26 (``it > 25``), so the results are the
same.  The host loop in ``pooled.estimate_hap_freqs_bayes_em`` stays the
byte-parity anchor: this version uses torch's digamma and dense
reductions in the engine's dtype."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..hmm.pack import _round_up

MAX_ITER = 27


def em_sets(rl, rmask, compat, numah, nr, a0: float, tol: float):
    """rl: (S, NR, NH) read-given-hap log-liks (pad rows arbitrary);
    rmask: (S, NR) valid-read mask; compat: (S, NH) bool; numah, nr: (S,)
    in rl's dtype.  Returns (loglik (S,), pi (S, NH)) on rl's device.

    lpi starts at log(1/numah) on compatible haps and -100 elsewhere;
    each iteration forms responsibilities, nk, the Dirichlet update
    (digamma) and pi = log((a0+nk)/(numah*a0+nr)); a set converges when
    |e_old - e_new| < tol or after its 27th iteration."""
    S, NR, NH = rl.shape
    dev, dt = rl.device, rl.dtype
    m100 = torch.tensor(-100.0, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    a0 = torch.tensor(a0, dtype=dt, device=dev)
    tol = torch.tensor(tol, dtype=dt, device=dev)
    rmask_f = rmask.to(dt)[..., None]
    lpi = torch.where(compat, -torch.log(numah)[:, None], m100)
    pi = torch.full((S, NH), -100.0, dtype=dt, device=dev)
    loglik = torch.zeros(S, dtype=dt, device=dev)
    e_old = torch.full((S,), -float("inf"), dtype=dt, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    for it in range(MAX_ITER):
        Z = lpi[:, None, :] + rl                              # (S, NR, NH)
        lognorm = torch.logsumexp(Z, dim=-1)                  # (S, NR)
        zz = torch.exp(Z - lognorm[..., None]) * rmask_f
        nk = zz.sum(dim=1)                                    # (S, NH)
        loglik_new = torch.where(rmask, lognorm, zero).sum(dim=1)
        ak = torch.where(compat, nk + a0, zero)
        ahat = ak.sum(dim=-1)
        dig_ak = torch.special.digamma(torch.where(compat, ak, one))
        lpi_new = torch.where(
            compat, dig_ak - torch.special.digamma(ahat)[:, None], m100)
        pi_new = torch.where(
            compat, torch.log((a0 + nk) / (numah * a0 + nr)[:, None]), m100)
        e_new = (zz * (pi_new[:, None, :] + rl)).sum(dim=(1, 2))
        conv = (torch.abs(e_old - e_new) < tol) | (it > 25)
        upd = ~done
        u2 = upd[:, None]
        lpi = torch.where(u2, lpi_new, lpi)
        pi = torch.where(u2, pi_new, pi)
        loglik = torch.where(upd, loglik_new, loglik)
        e_old = torch.where(upd, e_new, e_old)
        done = done | (conv & upd)
    return loglik, pi


def run_batched_em(instances: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   a0: float, tol: float, dtype=np.float32, *, device):
    """instances: per pooled window, (rlT (nr, nh), compat (nav, nh) bool,
    numah (nav,)) from pooled.em_inputs; `device` is where the VB-EM
    runs (no default: the caller names it).  Returns per window a list of
    (loglik, pi) per active set (numpy float64), as the original does;
    the padding is the original's."""
    if not instances:
        return []
    NR = _round_up(max(r.shape[0] for r, _, _ in instances), 64)
    NH = max(r.shape[1] for r, _, _ in instances)
    S = sum(c.shape[0] for _, c, _ in instances)
    Sp = max(8, 1 << (S - 1).bit_length())
    rl = np.zeros((Sp, NR, NH), dtype)
    rmask = np.zeros((Sp, NR), bool)
    compat = np.zeros((Sp, NH), bool)
    numah = np.ones(Sp, dtype)
    nrv = np.ones(Sp, dtype)
    s = 0
    spans = []
    for rlT, cp, na in instances:
        nr, nh = rlT.shape
        nav = cp.shape[0]
        for a in range(nav):
            rl[s, :nr, :nh] = rlT
            rmask[s, :nr] = True
            compat[s, :nh] = cp[a]
            numah[s] = max(float(na[a]), 1.0)
            nrv[s] = float(nr)
            s += 1
        spans.append((s - nav, s))
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    loglik, pi = em_sets(to(rl), to(rmask), to(compat), to(numah), to(nrv),
                         float(np.dtype(dtype).type(a0)),
                         float(np.dtype(dtype).type(tol)))
    loglik = loglik.cpu().numpy().astype(np.float64)
    pi = pi.cpu().numpy().astype(np.float64)
    out = []
    for (lo, hi), (rlT, cp, _na) in zip(spans, instances):
        nh = rlT.shape[1]
        out.append([(float(loglik[s]), pi[s, :nh].copy())
                    for s in range(lo, hi)])
    return out
