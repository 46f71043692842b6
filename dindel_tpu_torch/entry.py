"""Entry points of the port: the counterpart of the repository's
``__graft_entry__.py``.

entry(device="cuda") -> (fn, example_args): a forward step on the
flagship compute path, the pair-HMM DP and finish (the CUDA kernels on
a card, their plain versions on the CPU) over one realignment window's
(haplotypes x reads) pairs, with the example arguments as tensors on
`device`.

dryrun_multichip(n_devices, devices=None): builds an n-device dp x rp
mesh and runs the sharded slab program and the sharded window step
once on tiny shapes (parallel/mesh.py)."""

from __future__ import annotations

import numpy as np
import torch

from .parallel.mesh import dryrun_multichip  # noqa: F401  (re-exported)

# the window's dense arrays fn takes, and their device dtypes (None:
# the pack's float dtype)
_ARGS = {"hap_len": torch.int32, "read_len": torch.int32,
         "b_mid": torch.int32, "read_codes": torch.uint8,
         "hap_codes": torch.uint8, "eq": None, "uq": None, "lpe": None,
         "lpn": None, "prior_rmq": None, "prior_hmq": None, "obs_mid": None}


def entry(device="cuda"):
    from .config import ObservationModelParameters
    from .device import resolve_device
    from .hmm.dp_kernel import pair_hmm_dp
    from .hmm.dp_ref import dp_bounds
    from .hmm.epilogue_kernel import finish
    from .hmm.pack import compute_obs_mid, pack_pairs
    from .parallel.mesh import synth_windows

    dev = resolve_device(device)
    params = ObservationModelParameters()
    (haps, reads, hap_start), = synth_windows(1, nh=4, nr=8, H=64, L=48)
    pk = pack_pairs(haps, reads, hap_start, params, dtype=np.float32)
    pk["obs_mid"] = compute_obs_mid(pk)
    example_args = []
    for k, dt in _ARGS.items():
        t = torch.from_numpy(np.ascontiguousarray(pk[k]))
        example_args.append(t.to(device=dev, dtype=dt or t.dtype))
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
    scalars = pk["scalars"]
    bounds = dp_bounds(pk["read_len"], pk["b_mid"], L_pad)

    def fn(hap_len, read_len, b_mid, read_codes, hap_codes, eq, uq, lpe,
           lpn, prior_rmq, prior_hmq, obs_mid):
        amid, bmid, btf, btb = pair_hmm_dp(
            H_pad, L_pad, numT, hap_len, read_len, b_mid, read_codes,
            hap_codes, eq, uq, lpe, lpn, scalars, exact_ties=True,
            bounds=bounds)
        return finish(H_pad, L_pad, numT, b_mid, hap_len, amid, bmid,
                      obs_mid, prior_rmq, prior_hmq, btf, btb,
                      exact_ties=True, read_len=read_len)

    return fn, tuple(example_args)
