"""Multi-device execution: windows data-parallel ('dp') and reads
sharded ('rp') over a grid of torch devices.

Counterpart of ``dindel_tpu/parallel/mesh.py``.  The reference scales by
running one process per window file with zero communication
(makeWindows.py:46-54); the mesh shards a *batch of windows* instead:

- 'dp' axis: independent realignment windows (the natural data axis);
- 'rp' axis: the reads of each window are split across devices; per-pair
  log-likelihoods are computed locally and the diploid genotype
  log-likelihood matrix G[h1,h2] = sum_r log(.5 e^{ll[h1,r]}+.5 e^{ll[h2,r]})
  is completed by adding the rp partials in rp order on the dp row's
  first device.

One process drives every device of the mesh (single controller, as the
JAX package's ``--mesh`` is one process over its local devices): each
shard's work is enqueued on its own ``torch.device``, so shards on
distinct cards run concurrently.  A mesh may repeat one device (the
tests run one over ``[torch.device("cpu")] * 8``); ``hmm/slab.py``
``run_slab_decode_sharded`` is the batched engine's sharded slab
program."""

from __future__ import annotations

import math
import random
from typing import List

import numpy as np
import torch

from ..config import ObservationModelParameters
from ..device import resolve_device
from ..hmm.pack import (_round_up, compute_obs_mid, merge_compact,
                        pack_pairs, pack_pairs_compact, pad_compact)
from ..hmm.slab import (DENSE_KEYS, run_packed, run_slab_decode,
                        run_slab_decode_sharded)
from ..model import Haplotype, Read

PACK_KEYS = ["hap_len", "read_len", "b_mid", "read_codes", "hap_codes",
             "eq", "uq", "lpe", "lpn", "lpeV", "lpnV",
             "prior_rmq", "prior_hmq", "obs_mid"]


class Mesh:
    """An (n_dp, n_rp) grid of torch devices with the axis names
    ("dp", "rp").  ``devices[i][j]`` runs dp row i, rp column j; the
    flat order (dp-major) is the order pairs are sharded in, and
    ``first`` is where results are gathered."""

    axis_names = ("dp", "rp")

    def __init__(self, devices: List[List[torch.device]]):
        self.devices = [list(row) for row in devices]
        self.shape = (len(self.devices), len(self.devices[0]))

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(n_dp: int, n_rp: int, devices=None) -> Mesh:
    """The first n_dp * n_rp of `devices`, dp-major.  By default
    cuda:0 .. cuda:{n-1}; fewer cards than that raises, and nothing
    falls back to fewer cards or to the CPU."""
    n = n_dp * n_rp
    if n_dp < 1 or n_rp < 1:
        raise ValueError(f"mesh axes must be positive, got {n_dp}x{n_rp}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"need {n} CUDA devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices, have {len(devices)}")
    devs = [resolve_device(d) for d in devices[:n]]
    return Mesh([devs[i * n_rp:(i + 1) * n_rp] for i in range(n_dp)])


def sharded_window_step(mesh: Mesh, H_pad: int, L_pad: int, numT: int,
                        nh: int, exact_ties: bool = True):
    """Returns a function over a packed window batch (the arrays of
    ``pack_window_batch``: (W, B, ...) per key, the read mask, the
    scalars) -> (ll (W, nh, nr_pad), G (W, nh, nh)) on the mesh's first
    device.

    Shard (i, j) takes windows i*W/n_dp .. and pair columns j*B/n_rp ..
    and runs the dense DP and finish on them in one ``run_packed`` (one
    DP kernel launch: the shard's windows concatenated on the pair axis;
    pairs are independent, so this equals a loop over windows).  Its
    masked partial G is moved to the dp row's first device and the rp
    partials are added in rp order, the same code and order on the CPU
    and on the card."""
    n_dp, n_rp = mesh.shape

    def step(*args):
        arrays = dict(zip(PACK_KEYS + ["read_mask"], args[:-1]))
        scalars = args[-1]
        W, B = arrays["hap_len"].shape
        if W % n_dp or B % (n_rp * nh):
            raise ValueError(f"{W} windows x {B} pairs do not split over a "
                             f"{n_dp}x{n_rp} mesh with {nh} haps")
        W_loc, B_loc = W // n_dp, B // n_rp
        nr_loc = B_loc // nh
        lls, Gs = [], []
        for i in range(n_dp):
            ws = slice(i * W_loc, (i + 1) * W_loc)
            row_dev = mesh.devices[i][0]
            ll_row, G_row = [], None
            for j in range(n_rp):
                dev = mesh.devices[i][j]
                ps = slice(j * B_loc, (j + 1) * B_loc)

                def local(k):
                    a = arrays[k][ws, ps]
                    return a.reshape((W_loc * B_loc,) + a.shape[2:])
                pk = {k: local(k) for k in DENSE_KEYS}
                pk.update(H_pad=H_pad, L_pad=L_pad, numT=numT,
                          scalars=scalars)
                ll = run_packed(pk, exact_ties, dev)[0].reshape(
                    W_loc, nh, nr_loc)
                mask = torch.from_numpy(np.ascontiguousarray(
                    arrays["read_mask"][ws, ps])).to(dev).reshape(
                        W_loc, nh, nr_loc)
                # diploid pair posteriors: G[w,h1,h2] = sum_r log(.5 e^l1 +
                # .5 e^l2); pairs padded onto the rp axis contribute 0
                pair = (torch.logaddexp(ll[:, :, None, :], ll[:, None, :, :])
                        + math.log(0.5))
                pair = torch.where(mask[:, :, None, :], pair,
                                   torch.zeros((), dtype=pair.dtype,
                                               device=dev))
                G_part = pair.sum(dim=-1).to(row_dev)
                G_row = G_part if G_row is None else G_row + G_part
                ll_row.append(ll.to(mesh.first))
            lls.append(torch.cat(ll_row, dim=2))
            Gs.append(G_row.to(mesh.first))
        return torch.cat(lls), torch.cat(Gs)

    return step


def pack_window_batch(windows, params: ObservationModelParameters,
                      dtype=np.float32, H_pad=None, L_pad=None, n_rp: int = 1):
    """windows: list of (haps, reads, hap_start) with identical nh, nr.
    Returns stacked arrays (W, B, ...) + dims.  The pair axis is permuted
    from hap-major (h*nr+r) to (read-shard, hap, read) order so a
    contiguous 'rp' split keeps all haps with each read shard."""
    pks = []
    H_max = max(max(h.size() for h in w[0]) for w in windows)
    L_max = max(max(r.size() for r in w[1]) for w in windows)
    if H_pad is None:
        H_pad = ((H_max + 15) // 16) * 16
    if L_pad is None:
        L_pad = ((max(L_max, 2) + 15) // 16) * 16
    for haps, reads, hap_start in windows:
        pk = pack_pairs(haps, reads, hap_start, params, dtype,
                        H_pad=H_pad, L_pad=L_pad)
        pk["obs_mid"] = compute_obs_mid(pk)
        pks.append(pk)
    nh = pks[0]["nh"]
    nr = pks[0]["nr"]
    # pad the read axis up to a multiple of the rp shard count (clones of
    # the last read; masked out of the psum'd genotype matrix)
    nr_pad = _round_up(nr, n_rp)
    nr_loc = nr_pad // n_rp
    pair_of = np.arange(nr_pad)
    pair_of = np.where(pair_of < nr, pair_of, nr - 1)
    perm = np.array([h * nr + pair_of[s * nr_loc + r]
                     for s in range(n_rp)
                     for h in range(nh)
                     for r in range(nr_loc)], np.int64)
    real = np.array([(s * nr_loc + r) < nr
                     for s in range(n_rp)
                     for h in range(nh)
                     for r in range(nr_loc)], bool)
    stacked = [np.stack([pk[k][perm] for pk in pks]) for k in PACK_KEYS]
    stacked.append(np.broadcast_to(real, (len(pks), real.shape[0])).copy())
    stacked.append(pks[0]["scalars"])
    return stacked, pks[0]["H_pad"], pks[0]["L_pad"], pks[0]["numT"], nh


def synth_windows(n_windows: int, nh: int, nr: int, H: int, L: int, seed: int = 0):
    """Small synthetic windows for dry runs and benchmarks."""
    rng = random.Random(seed)
    out = []
    for w in range(n_windows):
        ref = "".join(rng.choice("ACGT") for _ in range(H))
        haps = [Haplotype(seq=ref)]
        for _ in range(nh - 1):
            k = rng.randrange(5, H - 8)
            if rng.random() < 0.5:
                haps.append(Haplotype(seq=ref[:k] + ref[k + rng.randint(1, 3):]))
            else:
                ins = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 3)))
                haps.append(Haplotype(seq=ref[:k] + ins + ref[k:]))
        reads = []
        for _ in range(nr):
            src = haps[rng.randrange(nh)].seq
            start = rng.randrange(0, max(1, len(src) - L))
            seq = src[start:start + L]
            if len(seq) < L:
                seq = seq + "".join(rng.choice("ACGT") for _ in range(L - len(seq)))
            reads.append(Read(seq=seq,
                              qual=np.full(L, 0.999),
                              map_qual=1 - 1e-5,
                              pos_stat_first=float(start)))
        out.append((haps, reads, 0))
    return out


def _consumed_equal(a: torch.Tensor, b: torch.Tensor, read_len) -> bool:
    """Equal, with map_state compared on each pair's read columns only
    (columns past read_len are not defined, hmm/finish.py)."""
    if a.dim() == 2:
        rl = torch.as_tensor(np.asarray(read_len), device=a.device).long()
        valid = torch.arange(a.shape[1], device=a.device)[None, :] < rl[:, None]
        a, b = a.masked_fill(~valid, -1), b.masked_fill(~valid, -1)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Build an n-device mesh (cuda:0 .. by default; `devices` may
    repeat one device) and run BOTH multi-device paths on tiny shapes:

    1. the slab program the batched engine dispatches
       (hmm/slab.py run_slab_decode_sharded: pairs sharded over the full
       dp x rp mesh), float32 with exact ties, asserted bit-equal to the
       single-device run;
    2. the dp x rp window step with the rp reduction
       (sharded_window_step), including an uneven read count that pads
       onto the rp axis;
    3. the shipped configuration (float32, fast ties) sharded against
       single: on CUDA devices, the DP kernel's path."""
    n_rp = 2 if n_devices % 2 == 0 else 1
    n_dp = n_devices // n_rp
    mesh = make_mesh(n_dp, n_rp, devices)

    nh = 3
    nr = 4 * n_rp + 1  # deliberately uneven over rp
    W = 2 * n_dp
    windows = synth_windows(W, nh, nr, H=48, L=32)
    params = ObservationModelParameters()

    # 1 and 3: the engine's slab program, sharded vs single device
    for exact, H_pad, L_pad in ((True, 62, 32), (False, 126, 128)):
        merged = pad_compact(merge_compact([
            pack_pairs_compact(haps, reads, hs, params, np.float32,
                               H_pad=H_pad, L_pad=L_pad)
            for haps, reads, hs in windows]))
        ref = run_slab_decode(merged, exact, mesh.first)
        got = run_slab_decode_sharded(merged, exact, mesh)
        for a, b in zip(ref, got):
            assert _consumed_equal(a, b, merged["read_len"]), \
                f"sharded slab step diverged from single-device " \
                f"(exact_ties={exact})"

    # 2. dp x rp window step with the rp reduction
    args, H_pad, L_pad, numT, nh_ = pack_window_batch(
        windows, params, dtype=np.float32, n_rp=n_rp)
    step = sharded_window_step(mesh, H_pad, L_pad, numT, nh_)
    ll, G = step(*args)
    nr_pad = _round_up(nr, n_rp)
    assert ll.shape == (W, nh, nr_pad)
    assert G.shape == (W, nh, nh)
    assert bool(torch.isfinite(G).all())
