"""dindel_tpu_torch — the Dindel indel caller on PyTorch and CUDA.

A port of ``dindel_tpu`` (the JAX/TPU package, kept beside it as the
reference) to one NVIDIA Hopper GPU: every ``--analysis`` verb; the
streaming engine (``--analysis indels``, the default: one window at a
time, ``--hmmBackend jax|pallas|oracle`` and ``--faster``); the batched
engine (``--engine batched``) with the diploid and pooled callers on the
device-call and full-decode routes, dense insert-prior slabs and slab
rescue; the window-file shard driver (``pipeline/run_parallel.py``);
the batched engine's slab programs sharded over a dp x rp mesh of
devices (``--mesh``, ``parallel/mesh.py``) and multi-process host
staging feeding one device (``--stageProcs``, ``parallel/hostshard.py``);
and the entry points of ``entry.py``.  The port is
self-contained: it carries its own copy of every host module it runs
(BAM/FASTA I/O, read fetch, haplotype generation, NW, the callers, GLF
output, the pipeline verbs), under the same sub-paths as in
``dindel_tpu``, and imports nothing of that package.  Its native helpers
build from the shared sources in ``native/`` into
``dindel_tpu_torch/build/``.  The slab program is plain PyTorch on an
explicit device except the pair-HMM DP, which is a hand-written CUDA
kernel (``csrc/pair_hmm_dp.cu``, wrapped by ``hmm/dp_kernel.py``); the
streaming engine launches it once per window.

Nothing in this package imports ``jax``.
"""

__version__ = "0.1.0"
