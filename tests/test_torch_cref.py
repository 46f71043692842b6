"""dindel_tpu_torch held to the compiled reference pair-HMM.

The tracked binary native/refshim/ref_hmm (ObservationModelFBMaxErr of
the reference C++, driven line by line: native/refshim/hmm_driver.cpp)
is called directly, on the 120 seeded cases of tests/test_hmm_oracle.py
(seed 1234; its case maker and line format are copied here) and on the
40 pairs of bench_torch.py's C++ baseline.  Held to it:

- the port's NumPy oracle, hmm/reference.py `pair_hmm_single`: ll within
  rel 1e-12 / abs 1e-10; offHap, offHapHMQ, first and last base, and the
  indel and SNP strings equal;
- the port's batched program, hmm/slab.py `run_packed` (K1's plain
  version, finish) on the CPU in float64 with exact ties: ll within the
  same tolerance, off_hap and off_hap_hmq equal.

Needs no sources of the reference and no JAX."""

import random
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dindel_tpu_torch.config import ObservationModelParameters  # noqa: E402
from dindel_tpu_torch.hmm.pack import pack_pairs  # noqa: E402
from dindel_tpu_torch.hmm.reference import pair_hmm_single  # noqa: E402
from dindel_tpu_torch.hmm.slab import run_packed  # noqa: E402
from dindel_tpu_torch.model import Haplotype, Read  # noqa: E402

REF_HMM = REPO / "native" / "refshim" / "ref_hmm"
BASES = "ACGT"
RTOL, ATOL = 1e-12, 1e-10
N_CASES, CHUNKS = 120, 4


# -- tests/test_hmm_oracle.py:20-81 (copied) --------------------------------

def mutate(seq: str, rng: random.Random, n_snp=0, n_ins=0, n_del=0):
    s = list(seq)
    for _ in range(n_snp):
        i = rng.randrange(len(s))
        s[i] = rng.choice(BASES)
    out = "".join(s)
    for _ in range(n_del):
        if len(out) > 8:
            i = rng.randrange(1, len(out) - 5)
            ln = rng.randint(1, 4)
            out = out[:i] + out[i + ln:]
    for _ in range(n_ins):
        i = rng.randrange(1, len(out) - 1)
        ins = "".join(rng.choice(BASES) for _ in range(rng.randint(1, 4)))
        out = out[:i] + ins + out[i:]
    return out


def make_case(rng: random.Random):
    H = rng.randint(20, 120)
    hap = "".join(rng.choice(BASES) for _ in range(H))
    # sprinkle homopolymers so the error model matters
    if rng.random() < 0.7:
        i = rng.randrange(2, H - 10)
        hap = hap[:i] + rng.choice(BASES) * rng.randint(3, 8) + hap[i + 6:]
    start = rng.randrange(0, max(1, len(hap) - 15))
    ln = rng.randint(10, len(hap) - start)
    read = hap[start:start + ln]
    read = mutate(read, rng, n_snp=rng.randint(0, 3),
                  n_ins=rng.randint(0, 1), n_del=rng.randint(0, 1))
    if len(read) < 5:
        read = hap[start:start + 10]
    quals = [min(1 - 1e-16, max(1e-16, 1.0 - 10 ** (-rng.uniform(1, 4))))
             for _ in read]
    map_qual = 1.0 - 10 ** (-rng.uniform(1, 15.9))
    pos_stat = float(start + rng.randint(-3, 3))
    hap_start = 0
    max_len_del = rng.choice([5, 10])
    if max_len_del > len(hap):
        max_len_del = 5
    p_error = rng.choice([5e-4, 1e-4])
    p_mut = rng.choice([1e-5, 1e-4])
    b_mid = -1 if rng.random() < 0.8 else rng.randrange(0, len(read))
    force = 0
    unmapped = 1 if rng.random() < 0.1 else 0
    return dict(hap=hap, read=read, quals=quals, map_qual=map_qual,
                pos_stat=pos_stat, hap_start=hap_start,
                max_len_del=max_len_del, p_error=p_error, p_mut=p_mut,
                b_mid=b_mid, force=force, unmapped=unmapped)


def case_to_line(c):
    q = ",".join(repr(x) for x in c["quals"])
    return (f"{c['hap']} {c['read']} {c['map_qual']!r} {c['pos_stat']!r} "
            f"{c['hap_start']} {c['p_error']!r} {c['p_mut']!r} "
            f"{c['max_len_del']} 0.01 {c['b_mid']} {c['force']} "
            f"{c['unmapped']} {q}")

# ---------------------------------------------------------------------------


def line_to_case(line: str):
    """The case of one ref_hmm input line (hmm_driver.cpp:3-5)."""
    (hap, read, map_qual, pos_stat, hap_start, p_error, p_mut, max_len_del,
     p_first, b_mid, force, unmapped, quals) = line.split()
    assert float(p_first) == 0.01
    return dict(hap=hap, read=read,
                quals=[float(q) for q in quals.split(",")],
                map_qual=float(map_qual), pos_stat=float(pos_stat),
                hap_start=int(hap_start), max_len_del=int(max_len_del),
                p_error=float(p_error), p_mut=float(p_mut),
                b_mid=int(b_mid), force=int(force), unmapped=int(unmapped))


def run_ref(lines):
    """ref_hmm's output line per input line, parsed (hmm_driver.cpp:68-78):
    (ll, offHap, offHapHMQ, firstBase, lastBase, indels, snps)."""
    res = subprocess.run([str(REF_HMM)], input="\n".join(lines) + "\n",
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-500:]
    out = []
    for line in res.stdout.strip().split("\n"):
        head, _, indels, snps = [p.strip() for p in line.split("|")]
        t = head.split()
        out.append((float(t[0]), int(t[1]), int(t[2]), int(t[5]), int(t[6]),
                    indels, snps))
    assert len(out) == len(lines)
    return out


def params_of(c):
    return ObservationModelParameters(
        p_error=c["p_error"], p_mut=c["p_mut"],
        max_length_del=c["max_len_del"], max_length_indel=c["max_len_del"],
        b_mid=c["b_mid"], force_read_on_haplotype=bool(c["force"]))


def read_of(c):
    return Read(seq=c["read"], qual=np.array(c["quals"]),
                map_qual=c["map_qual"], pos_stat_first=c["pos_stat"],
                is_unmapped=bool(c["unmapped"]))


@pytest.fixture(scope="module")
def seeded():
    rng = random.Random(1234)
    cases = [make_case(rng) for _ in range(N_CASES)]
    return cases, run_ref([case_to_line(c) for c in cases])


@pytest.fixture(scope="module")
def bench_cases():
    import bench_torch

    lines = bench_torch.baseline_lines()
    return [line_to_case(x) for x in lines], run_ref(lines)


def chunk(cases_ref, k):
    cases, ref = cases_ref
    per = -(-len(cases) // CHUNKS)
    return list(zip(cases, ref))[k * per:(k + 1) * per]


def check_oracle(pairs):
    for i, (c, (ll, off, off_hmq, first, last, indels, snps)) in enumerate(
            pairs):
        ml = pair_hmm_single(Haplotype(seq=c["hap"]), read_of(c),
                             c["hap_start"], params_of(c))
        assert ml.ll == pytest.approx(ll, rel=RTOL, abs=ATOL), f"case {i}"
        assert (int(ml.off_hap), int(ml.off_hap_hmq)) == (off, off_hmq), i
        assert (ml.first_base, ml.last_base) == (first, last), f"case {i}"
        assert " ".join(f"{p}:{v.str}" for p, v in
                        sorted(ml.indels.items())) == indels, f"case {i}"
        assert " ".join(f"{p}:{v.str}" for p, v in
                        sorted(ml.snps.items())) == snps, f"case {i}"


def check_run_packed(pairs):
    """The cases grouped by their parameters and hap start, each group one
    float64 exact-ties program over its haps x reads; the (case hap, case
    read) pairs are read off the diagonal."""
    groups = defaultdict(list)
    for c, ref in pairs:
        groups[(c["p_error"], c["p_mut"], c["max_len_del"], c["b_mid"],
                c["force"], c["hap_start"])].append((c, ref))
    n = 0
    for members in groups.values():
        c0 = members[0][0]
        pk = pack_pairs([Haplotype(seq=c["hap"]) for c, _ in members],
                        [read_of(c) for c, _ in members], c0["hap_start"],
                        params_of(c0), np.float64)
        ll, off, off_hmq = (t.numpy() for t in
                            run_packed(pk, True, torch.device("cpu"))[:3])
        nr = len(members)
        for i, (c, ref) in enumerate(members):
            k = i * nr + i
            assert ll[k] == pytest.approx(ref[0], rel=RTOL, abs=ATOL), c
            assert (int(off[k]), int(off_hmq[k])) == ref[1:3], c
            n += 1
    assert n == len(pairs)


@pytest.mark.parametrize("k", range(CHUNKS))
def test_oracle_matches_ref_hmm(seeded, k):
    check_oracle(chunk(seeded, k))


@pytest.mark.parametrize("k", range(CHUNKS))
def test_run_packed_f64_matches_ref_hmm(seeded, k):
    check_run_packed(chunk(seeded, k))


def test_oracle_matches_ref_hmm_on_baseline_cases(bench_cases):
    check_oracle(list(zip(*bench_cases)))


def test_run_packed_f64_matches_ref_hmm_on_baseline_cases(bench_cases):
    check_run_packed(list(zip(*bench_cases)))
