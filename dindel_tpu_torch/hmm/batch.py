"""Per-window pair-HMM driver of the streaming engine.

Counterpart of ``dindel_tpu.hmm.batch.BatchedPairHMM`` (batch.py:1320):
one window's (haps x reads) pairs packed dense on the host
(pack.pack_pairs), the pair-HMM DP kernel and finish on the device
(slab.run_packed), the outputs fetched and decoded on the host
(liks.decode_liks_view)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import ObservationModelParameters
from ..device import resolve_device
from ..model import Haplotype, MLAlignment, Read
from .liks import decode_liks_view
from .pack import pack_pairs
from .slab import DENSE_KEYS, run_packed

# --hmmBackend -> (dtype, exact_ties): 'jax' is the JAX package's float64
# XLA DP with the exact EPS/TIE fold (its oracle-parity configuration),
# 'pallas' its float32 kernel with the fast fold and the argmax finish
BACKENDS = {"jax": (np.float64, True), "pallas": (np.float32, False)}


class BatchedPairHMM:
    """Packs a window's pairs, runs them on `device` in one launch of the
    DP kernel, converts back to MLAlignments (a LiksView).  With `remote`
    (a parallel.hostshard.DeviceProxy) the packed pairs run as one dense
    program on the device server's device instead, and `device` is
    unused."""

    def __init__(self, params: ObservationModelParameters,
                 dtype=np.float64, exact_ties: bool = True, device="cuda",
                 remote=None):
        self.params = params
        self.dtype = dtype
        self.exact_ties = exact_ties
        self.device = resolve_device(device)
        self.remote = remote

    def compute(self, haps: List[Haplotype], reads: List[Read],
                hap_start: int) -> List[List[MLAlignment]]:
        p = self.params
        if not haps or not reads:
            return [[]]
        # bucket-16 padding for both backends: the JAX Pallas layout
        # (S_half and L_pad multiples of 128) serves only its TPU kernel
        pk = pack_pairs(haps, reads, hap_start, p, self.dtype)
        if self.remote is not None:
            merged = {k: pk[k] for k in DENSE_KEYS + (
                "H_pad", "L_pad", "numT", "scalars")}
            handle = self.remote.dispatch(
                "dense", dict(merged=merged, exact_ties=self.exact_ties))
            out = self.remote.fetch_pytrees([handle])[0]
        else:
            out = [t.cpu().numpy()
                   for t in run_packed(pk, self.exact_ties, self.device)]
        return decode_liks_view(haps, reads, pk, *out, p)
