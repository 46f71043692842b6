"""Command-line interface: ``python -m dindel_tpu_torch``.

The same options as ``python -m dindel_tpu`` (the parser is
``dindel_tpu.cli.build_parser``) plus ``--device`` (default ``cuda``).
``--analysis indels`` runs this package's batched engine; every other
verb (getCIGARindels, makeWindows, mergeOutputDiploid,
mergeOutputPooled, ...) is host-only and delegates to
``dindel_tpu.cli.main``.

``indels --engine batched`` supports ``--doDiploid`` and ``--doPooled``
(alone or together), ``--outputRealignedBAM`` and ``--opl``.
``--hmmBackend pallas`` selects the fast tie fold with the argmax finish
(the shipped configuration), the default ``--hmmBackend jax`` (and
``oracle``) the exact EPS/TIE fold with the exact sequential finish;
both run the same CUDA DP kernel.  Options this package does not have
yet raise NotImplementedError naming their ROADMAP item."""

from __future__ import annotations

import argparse
import sys

from dindel_tpu import cli as tpu_cli
from dindel_tpu.model import LibraryCollection


def build_parser() -> argparse.ArgumentParser:
    ap = tpu_cli.build_parser()
    ap.prog = "dindel_tpu_torch"
    ap.add_argument("--device", default="cuda",
                    help="torch device of the slab program, e.g. cuda, "
                         "cuda:1 or cpu (cpu runs the plain PyTorch "
                         "versions of the kernels)")
    return ap


def _strip_device(argv):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--device":
            skip = True
        elif not a.startswith("--device="):
            out.append(a)
    return out


def _unsupported(args) -> None:
    todo = [
        (args.engine != "batched",
         "--engine streaming (the per-window engine): ROADMAP Queue 1 "
         "item 9"),
        (args.faster,
         "--faster (the streaming sparse HMM): ROADMAP Queue 1 item 9"),
        (bool(args.mesh), "--mesh (multi-GPU): ROADMAP Queue 1 item 11"),
        (args.stageProcs > 0,
         "--stageProcs (multi-process host staging): ROADMAP Queue 1 "
         "item 12"),
    ]
    for hit, what in todo:
        if hit:
            raise NotImplementedError(f"not ported to dindel_tpu_torch "
                                      f"yet: {what}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.analysis != "indels":
        return tpu_cli.main(_strip_device(argv))

    import numpy as np
    from .engine.batched import BatchedWindowEngine

    _unsupported(args)
    params = tpu_cli.params_from_args(args)
    bam_paths = ([args.bamFile] if args.bamFile
                 else [line.split()[0] for line in open(args.bamFiles)])
    libraries = LibraryCollection()
    if args.libFile:
        params.map_unmapped_reads = True
        libraries.add_from_file(args.libFile)
    eng = BatchedWindowEngine(
        bam_paths, args.ref, params, libraries, device=args.device,
        batch_windows=args.batchWindows,
        max_pairs_per_slab=args.maxPairsPerSlab,
        exact_ties=args.hmmBackend != "pallas", dtype=np.float32)
    try:
        eng.detect_indels(args.varFile)
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
