"""Likelihood guards: JAX-free counterpart of
``dindel_tpu.engine.window.check_guards_and_on_hap`` (window.py:81) for
this package's LiksView and LiksStats (the original's isinstance test
imports the JAX package's classes)."""

from __future__ import annotations

import numpy as np

from dindel_tpu.engine.reads import WindowError

from ..hmm.liks import LiksStats, LiksView


def check_guards_and_on_hap(liks, nh: int, nr: int):
    """Positive-loglik abort + NaN guard + on_hap flags over the liks
    matrix (DInDel.cpp:1717-1735), array-level."""
    if not isinstance(liks, (LiksView, LiksStats)):
        raise TypeError("expected LiksView or LiksStats, got "
                        f"{type(liks).__name__}")
    ll = liks.ll2d
    bad = (ll > 0.1) | ~np.isfinite(ll)
    if bad.any():
        # first offending pair in the reference's h-major scan order
        h, r = divmod(int(np.argmax(bad.ravel())), nr)
        if ll[h, r] > 0.1:
            raise RuntimeError("Likelihood>0")
        raise WindowError("Nan detected")
    return (~liks.off_hap_hmq2d).any(axis=0).astype(int).tolist()
