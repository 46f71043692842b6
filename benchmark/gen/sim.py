"""The benchmark's data: diploid genomes and their reads, made from a seed.

make_genome(seq, traffic, seed) plants one variant site every `spacing`
bases of a random contig and returns the reference, sample 0's two
haplotypes and the planted sites.  sample_sites(sites, traffic,
n_samples, seed) gives every sample of a design its genotypes at those
sites: sample 0's as planted and each other sample's drawn alike, or,
with the traffic's `pool_allele_counts`, each site's count of alternate
copies among the pool's 2N haplotypes and the haplotypes that carry
them.  make_reads(genome, seq, seed, sample) samples paired reads from a
sample's two haplotypes at the sequencing design's coverage, with
substitution errors and each read's true alignment.  All are vectorised
with numpy, so a 1000-site genome at 30x takes seconds.

Random streams (_rng's second word): 1 the contig, the sites and sample
0's genotypes; 2 sample 0's reads; 3 is check.py's; 4 a pool's allele
counts and carriers; 16 + 2k sample k's genotypes and 17 + 2k its reads
(k >= 1).  So one sample without `pool_allele_counts` draws what a
design of one sample always drew.

Every planted indel is left-normalised (the base before it differs from
its last base), so the CIGAR position of each read's indel is the
position that getCIGARindels reports after its left alignment.
Coordinates are 0-based; an insertion at `pos` goes before reference
base `pos`, a deletion at `pos` removes `pos .. pos+len-1`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def _rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per purpose, from any non-negative seed."""
    return np.random.Generator(np.random.PCG64([int(seed) & (2**64 - 1),
                                                stream]))


def random_contig(rng: np.random.Generator, n: int, hp_rate: float
                  ) -> np.ndarray:
    """n bases (ASCII codes): single random bases, and with probability
    hp_rate a homopolymer run of 3-9 bases (the simulator's model)."""
    n_seg = int(n * 1.3) + 64
    run = rng.random(n_seg) < hp_rate
    lens = np.where(run, rng.integers(3, 10, n_seg), 1)
    while lens.sum() < n:
        lens = np.concatenate([lens, lens])
        run = np.concatenate([run, run])
    base = BASES[rng.integers(0, 4, lens.shape[0])]
    return np.repeat(base, lens)[:n].copy()


@dataclass
class Site:
    pos: int            # 0-based position of the event on the reference
    alleles: Tuple[str, str]   # hap A's and hap B's event ("" = reference)
    alts: Tuple[str, ...] = ()  # the alternate alleles planted here


def _other(rng, avoid: bytes) -> int:
    """A base not in `avoid`."""
    pool = [b for b in b"ACGT" if b not in avoid]
    return pool[int(rng.integers(0, len(pool)))]


def _plant(ref: np.ndarray, pos: int, kind: dict, rng) -> Tuple[int, List[str]]:
    """Rewrite the reference around `pos` for one site of `kind` and
    return (event position, alternate alleles: one, or two for a
    compound site), each '+SEQ' or '-SEQ', left-normalised."""
    k = kind["kind"]
    if k == "hp_del":
        n = int(rng.integers(kind["len"][0], kind["len"][1] + 1))
        run = n + int(rng.integers(kind["extra"][0], kind["extra"][1] + 1))
        b = int(BASES[rng.integers(0, 4)])
        ref[pos:pos + run] = b
        ref[pos - 1] = _other(rng, bytes([b]))
        ref[pos + run] = _other(rng, bytes([b]))
        return pos, ["-" + chr(b) * n]
    if k == "ins":
        n = int(rng.integers(kind["len"][0], kind["len"][1] + 1))
        seq = bytes(BASES[rng.integers(0, 4, n)])
        ref[pos - 1] = _other(rng, seq[-1:])
        return pos, ["+" + seq.decode()]
    if k == "del_seq":
        seq = kind["seq"].encode()
        ref[pos:pos + len(seq)] = np.frombuffer(seq, np.uint8)
        ref[pos - 1] = _other(rng, seq[-1:])
        return pos, ["-" + kind["seq"]]
    if k == "str":
        ulen = int(kind["unit_len"])
        unit = bytes(BASES[rng.integers(0, 4, ulen)])
        while len(set(unit)) < ulen:
            unit = bytes(BASES[rng.integers(0, 4, ulen)])
        units = int(rng.integers(kind["units"][0], kind["units"][1] + 1))
        tract = np.frombuffer(unit * units, np.uint8)
        ref[pos:pos + tract.shape[0]] = tract
        ref[pos - 1] = _other(rng, unit)
        ref[pos + tract.shape[0]] = _other(rng, unit)
        lo, hi = kind["change"]
        changes = [c for c in range(-hi, hi + 1) if abs(c) >= lo]
        picks = rng.permutation(len(changes))[:2]
        out = []
        for c in (changes[int(i)] for i in picks):
            out.append(("+" if c > 0 else "-") + (unit * abs(c)).decode())
        return pos, out
    raise ValueError(f"unknown site kind {k!r}")


def _shares(weights, n: int, rng) -> np.ndarray:
    """n labels 0..k-1 in proportion to `weights` (largest remainders),
    shuffled by rng."""
    w = np.asarray(weights, float)
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(int)
    counts[np.argsort(-(exact - counts), kind="stable")[:n - counts.sum()]] += 1
    return rng.permutation(np.repeat(np.arange(len(w)), counts))


def _genotype_draws(traffic: dict, n_sites: int, rng):
    """(compound, het, side) of each site: every draw gives the same
    multiset (the traffic's shares, rounded), in its own order."""
    compound = _shares([traffic["compound_share"],
                        1 - traffic["compound_share"]], n_sites, rng) == 0
    het = _shares([traffic["het_share"], 1 - traffic["het_share"]],
                  n_sites, rng) == 0
    side = _shares([1, 1], n_sites, rng)
    return compound, het, side


def _alleles(alts, compound: bool, het: bool, side: int) -> Tuple[str, str]:
    if len(alts) > 1 and compound:
        return alts[0], alts[1]
    if het:
        return (alts[0], "") if side == 0 else ("", alts[0])
    return alts[0], alts[0]


def make_genome(seq: dict, traffic: dict, seed: int):
    """(reference, hap A, hap B, sites) as uint8 arrays of ASCII bases and
    a list of Site.  `traffic` gives the sites (count, spacing), the mix
    of site kinds (weights), the heterozygous share and the share of
    compound heterozygous sites (two different alternate alleles)."""
    rng = _rng(seed, 1)
    n_sites = int(traffic["sites"])
    spacing = int(traffic["spacing"])
    pad = int(seq["start_pad"])
    length = pad + (n_sites + 1) * spacing
    ref = random_contig(rng, length, float(seq["hp_rate"]))
    mix = traffic["mix"]
    # every seed plants the same multiset of site kinds, genotypes and
    # haplotype sides (the mix's shares, rounded), in its own order
    kinds = _shares([m["weight"] for m in mix], n_sites, rng)
    compound, het, side = _genotype_draws(traffic, n_sites, rng)
    sites = []
    for i in range(n_sites):
        pos, alts = _plant(ref, pad + (i + 1) * spacing, mix[kinds[i]], rng)
        sites.append(Site(pos, _alleles(alts, compound[i], het[i], side[i]),
                          tuple(alts)))
    return genome_of(ref, sites)


def genome_of(ref: np.ndarray, sites: List[Site]):
    """(reference, hap A, hap B, sites) of one sample's sites."""
    return ref, _haplotype(ref, sites, 0), _haplotype(ref, sites, 1), sites


def sample_sites(sites: List[Site], traffic: dict, n_samples: int,
                 seed: int) -> List[List[Site]]:
    """Each sample's sites with its own genotypes.  Without the traffic's
    `pool_allele_counts`, sample 0 keeps `sites` and sample k >= 1 draws
    its genotypes as make_genome drew sample 0's (stream 16 + 2k).  With
    it (weights over 1 .. 2N alternate copies among the N samples' 2N
    haplotypes), each site's count is drawn, every seed the same
    multiset (stream 4), then which haplotypes carry the site's first
    alternate allele."""
    weights = traffic.get("pool_allele_counts")
    n = len(sites)
    if weights is None:
        out = [sites]
        for k in range(1, n_samples):
            draws = _genotype_draws(traffic, n, _rng(seed, 16 + 2 * k))
            out.append([Site(s.pos, _alleles(s.alts, *(d[i] for d in draws)),
                             s.alts) for i, s in enumerate(sites)])
        return out
    n_haps = 2 * n_samples
    if len(weights) != n_haps:
        raise ValueError(f"pool_allele_counts has {len(weights)} weights; "
                         f"a pool of {n_samples} samples has {n_haps} "
                         f"haplotypes")
    rng = _rng(seed, 4)
    count = _shares(weights, n, rng) + 1
    rank = np.argsort(np.argsort(rng.random((n, n_haps)), axis=1), axis=1)
    carry = rank < count[:, None]
    return [[Site(s.pos, tuple(s.alts[0] if carry[i, 2 * k + j] else ""
                               for j in (0, 1)), s.alts)
             for i, s in enumerate(sites)] for k in range(n_samples)]


@dataclass
class Haplotype:
    seq: np.ndarray       # uint8 ASCII bases
    col_ref: np.ndarray   # reference position of each column (an inserted
    col_ins: np.ndarray   # column carries its event's position)
    ins_start: np.ndarray  # first column of each insertion run, sorted
    ins_end: np.ndarray
    del_col: np.ndarray   # column before which a deletion lies, sorted
    del_len: np.ndarray


def _haplotype(ref: np.ndarray, sites: List[Site], which: int) -> Haplotype:
    pieces, cref, cins = [], [], []
    ins_s, ins_e, del_c, del_l = [], [], [], []
    cur = 0
    col = 0
    for s in sites:
        a = s.alleles[which]
        if not a:
            continue
        pieces.append(ref[cur:s.pos])
        cref.append(np.arange(cur, s.pos))
        cins.append(np.zeros(s.pos - cur, bool))
        col += s.pos - cur
        n = len(a) - 1
        if a[0] == "+":
            pieces.append(np.frombuffer(a[1:].encode(), np.uint8))
            cref.append(np.full(n, s.pos))
            cins.append(np.ones(n, bool))
            ins_s.append(col)
            ins_e.append(col + n)
            col += n
            cur = s.pos
        else:
            del_c.append(col)
            del_l.append(n)
            cur = s.pos + n
    pieces.append(ref[cur:])
    cref.append(np.arange(cur, ref.shape[0]))
    cins.append(np.zeros(ref.shape[0] - cur, bool))
    as_i = lambda x: np.asarray(x, np.int64)  # noqa: E731
    return Haplotype(np.concatenate(pieces), np.concatenate(cref),
                     np.concatenate(cins), as_i(ins_s), as_i(ins_e),
                     as_i(del_c), as_i(del_l))


@dataclass
class Reads:
    """Paired reads, mate 1 then mate 2 of each pair, unsorted.  A read
    holds at most one event (sites lie farther apart than a read is
    long): `ev_op` is 0 for none, 1 an insertion, 2 a deletion, 4 an
    insertion the read's start or end cuts (soft-clipped); it starts
    after `ev_at` read bases and is `ev_len` long."""
    pos: np.ndarray        # 0-based reference position of the first base
    seq: np.ndarray        # (n, read_len) uint8 ASCII bases
    ev_op: np.ndarray
    ev_at: np.ndarray
    ev_len: np.ndarray
    flag: np.ndarray
    mpos: np.ndarray
    isize: np.ndarray
    pair: np.ndarray       # pair number (the read name is r<pair>)

    def cigar(self, r: int) -> List[Tuple[int, int]]:
        """Read r's CIGAR as (op, length): M 0, I 1, D 2, S 4."""
        L = self.seq.shape[1]
        op, at, n = int(self.ev_op[r]), int(self.ev_at[r]), int(
            self.ev_len[r])
        if op == 0:
            return [(0, L)]
        rest = L - at if op == 2 else L - at - n
        return [(o, k) for o, k in ((0, at), (op, n), (0, rest)) if k > 0]


def make_reads(genome, seq: dict, seed: int, sample: int = 0,
               first_pair: int = 0) -> Reads:
    """Pairs of reads of `seq`'s read length at its coverage (read bases
    over reference length), each pair from hap A or B with probability
    one half, insert sizes from a normal of the design's mean and sd (at
    least two read lengths + 2), mate 2 reverse; substitution errors at
    the design's rate (a random base, which may equal the true one).
    `sample` picks the random stream; pairs are numbered from
    `first_pair`, so that no two samples' reads share a name."""
    ref, hap_a, hap_b, _ = genome
    rng = _rng(seed, 2 if sample == 0 else 17 + 2 * sample)
    L = int(seq["read_len"])
    n_pairs = int(seq["coverage"]) * ref.shape[0] // (2 * L)
    which = rng.random(n_pairs) < 0.5
    isize = np.maximum(2 * L + 2, np.round(rng.normal(
        seq["insert_mean"], seq["insert_sd"], n_pairs)).astype(np.int64))
    u = rng.random(n_pairs)
    seqs = np.empty((n_pairs, 2, L), np.uint8)
    pos = np.empty((n_pairs, 2), np.int64)
    ev = np.zeros((3, n_pairs, 2), np.int64)
    for hi, hap in ((0, hap_a), (1, hap_b)):
        idx = np.nonzero(which == (hi == 0))[0]
        span = np.maximum(1, hap.seq.shape[0] - isize[idx])
        s1 = np.floor(u[idx] * span).astype(np.int64)
        s2 = s1 + isize[idx] - L
        for m, s in ((0, s1), (1, s2)):
            seqs[idx, m] = np.lib.stride_tricks.sliding_window_view(
                hap.seq, L)[s]
            p, e = _align(hap, s, L)
            pos[idx, m] = p
            ev[:, idx, m] = e
    # each base an error with the design's probability: a binomial count
    # of positions, drawn uniformly (one drawn twice is one error)
    flat = seqs.reshape(-1)
    n_err = int(rng.binomial(flat.shape[0], float(seq["error_rate"])))
    flat[rng.integers(0, flat.shape[0], n_err)] = BASES[
        rng.integers(0, 4, n_err)]
    flag1 = 0x1 | 0x2 | 0x40 | 0x20
    flag2 = 0x1 | 0x2 | 0x80 | 0x10
    end2 = pos[:, 1] + L
    tlen = end2 - pos[:, 0]
    return Reads(pos=pos.reshape(-1), seq=seqs.reshape(-1, L),
                 ev_op=ev[0].reshape(-1), ev_at=ev[1].reshape(-1),
                 ev_len=ev[2].reshape(-1),
                 flag=np.tile(np.array([flag1, flag2]), n_pairs),
                 mpos=pos[:, ::-1].reshape(-1),
                 isize=np.stack([tlen, -tlen], 1).reshape(-1),
                 pair=np.repeat(first_pair + np.arange(n_pairs), 2))


def _align(hap: Haplotype, s: np.ndarray, L: int):
    """Reference start and true event (op, at, len; see Reads) of reads
    at hap columns s..s+L-1: an insertion run, or a deletion strictly
    inside the read.  An insertion that the read's start or end cuts is
    soft-clipped, as an aligner clips it."""
    e = s + L
    pos = hap.col_ref[s]
    ev = np.zeros((3, s.shape[0]), np.int64)
    if hap.ins_start.shape[0]:
        k = np.searchsorted(hap.ins_end, s, side="right")
        k = np.minimum(k, hap.ins_start.shape[0] - 1)
        a = np.maximum(hap.ins_start[k], s)
        b = np.minimum(hap.ins_end[k], e)
        r = b > a
        ev[0, r] = np.where((s < a) & (b < e), 1, 4)[r]
        ev[1, r] = (a - s)[r]
        ev[2, r] = (b - a)[r]
    if hap.del_col.shape[0]:
        k = np.searchsorted(hap.del_col, s, side="right")
        k = np.minimum(k, hap.del_col.shape[0] - 1)
        d = hap.del_col[k]
        r = (d > s) & (d < e)
        ev[0, r] = 2
        ev[1, r] = (d - s)[r]
        ev[2, r] = hap.del_len[k][r]
    return pos, ev
