"""dindel_tpu_torch's --faster path (the sparse k-mer-seeded HMM, host
numpy, hmm/faster.py) vs the JAX package, on the CPU.

- compute_likelihoods_faster against the original on random windows:
  every MLAlignment field by field and the on-hap flags equal;
- the CLI with --faster GLF byte-equal to ``python -m dindel_tpu
  --faster``; with --engine batched the CLI routes --faster to the
  streaming engine, as the JAX CLI does, and the batched engine itself
  refuses it.
Every comparison is exact."""

import dataclasses
import random

import numpy as np
import pytest

from dindel_tpu import cli as jax_cli
from dindel_tpu.config import ObservationModelParameters as JaxObsParams
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.hmm.faster import (
    compute_likelihoods_faster as jax_faster)
from dindel_tpu.model import Haplotype as JaxHaplotype
from dindel_tpu.model import Read as JaxRead
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate
from dindel_tpu_torch import cli
from dindel_tpu_torch.config import ObservationModelParameters, Parameters
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.hmm.faster import compute_likelihoods_faster
from dindel_tpu_torch.model import Haplotype, Read
from test_torch_engine import no_slab_rescues  # noqa: F401 (autouse)


def _window(seed, hap_cls, read_cls, nh=3, nr=12):
    """Haplotypes with small indels and mutated reads drawn from them
    (the case generator of tests/test_faster.py:48, per window)."""
    rng = random.Random(seed)
    ref = "".join(rng.choice("ACGT") for _ in range(rng.randrange(80, 150)))
    seqs = [ref]
    for _ in range(nh - 1):
        k = rng.randrange(10, len(ref) - 10)
        seqs.append(ref[:k] + ref[k + rng.randint(1, 3):] if rng.random()
                    < 0.5 else ref[:k] + "ACGT"[rng.randrange(4)] * 2
                    + ref[k:])
    haps = [hap_cls(seq=s) for s in seqs]
    reads = []
    for _ in range(nr):
        src = rng.choice(seqs)
        L = rng.randrange(25, 60)
        start = rng.randrange(0, len(src) - L)
        read = list(src[start:start + L])
        for _ in range(rng.randrange(0, 4)):
            read[rng.randrange(L)] = rng.choice("ACGT")
        qual = [rng.choice([0.99, 0.995, 0.999, 0.9999]) for _ in read]
        reads.append(read_cls(
            seq="".join(read), qual=np.asarray(qual),
            map_qual=rng.choice([0.9, 0.99, 0.999, 1.0 - 1e-16]),
            pos_stat_first=float(start + rng.randrange(-3, 4))))
    return haps, reads


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_compute_likelihoods_faster_matches_jax(seed):
    haps, reads = _window(seed, Haplotype, Read)
    jhaps, jreads = _window(seed, JaxHaplotype, JaxRead)
    liks, on_hap = compute_likelihoods_faster(
        haps, reads, 5, ObservationModelParameters())
    jliks, jon_hap = jax_faster(jhaps, jreads, 5, JaxObsParams())
    assert on_hap == jon_hap == [1] * len(reads)
    assert ([[dataclasses.asdict(m) for m in row] for row in liks]
            == [[dataclasses.asdict(m) for m in row] for row in jliks])


@pytest.fixture(scope="module")
def faster_sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faster")
    fa, bam = simulate(str(tmp / "sim"),
                       [PlantedVariant(pos=600, var="-TGCA", genotype=2)],
                       SimConfig(ref_len=1300, coverage=10, read_len=50),
                       seed=5)
    var_file, _ = get_candidates(bam, str(tmp / "cand"), fa)
    return tmp, fa, bam, make_windows(var_file, str(tmp / "win"))[0]


def test_cli_faster_matches_jax(faster_sim):
    """--faster through the port's CLI (streaming by default, and routed
    there from --engine batched) against `python -m dindel_tpu
    --faster`."""
    tmp, fa, bam, wf = faster_sim
    argv = ["--analysis", "indels", "--doDiploid", "--faster", "--bamFile",
            bam, "--ref", fa, "--varFile", wf, "--outputFile"]
    assert jax_cli.main(argv + [str(tmp / "jax")]) == 0
    want = open(tmp / "jax.glf.txt").read()
    assert "dip.map" in want
    for tag, extra in (("port", []), ("routed", ["--engine", "batched"])):
        assert cli.main(argv + [str(tmp / tag), "--device", "cpu",
                                *extra]) == 0
        assert open(tmp / f"{tag}.glf.txt").read() == want, tag


def test_batched_engine_refuses_faster(faster_sim):
    tmp, fa, bam, _ = faster_sim
    params = Parameters()
    params.slower = False
    with pytest.raises(ValueError, match="streaming engine"):
        BatchedWindowEngine([bam], fa, params, device="cpu")
