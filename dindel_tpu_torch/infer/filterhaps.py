"""Haplotype filter on the full-decode route: JAX-free counterpart of
``dindel_tpu.infer.filterhaps.filter_haplotypes`` (filterhaps.py:24),
whose LiksView dispatch imports the JAX package (:33).  The array-level
body is the original's ``_filter_haplotypes_view`` (:124), which is
JAX-free.  Device-call windows use ``device_call.filter_haplotypes_dev``
instead."""

from __future__ import annotations

from dindel_tpu.infer.filterhaps import _filter_haplotypes_view

from ..hmm.liks import LiksView


def filter_haplotypes(haps, reads, liks, params, do_filter: bool):
    """Returns (filtered: List[int], var_coverage: {(pos, var) -> (nf,
    nr)}) over this package's LiksView."""
    if not isinstance(liks, LiksView):
        raise TypeError(f"expected LiksView, got {type(liks).__name__}")
    return _filter_haplotypes_view(haps, reads, liks, params, do_filter)
