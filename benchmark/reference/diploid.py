"""Diploid genotype-likelihood caller, a port of DetInDel::diploidGLF
(DInDel.cpp:2933-3662) with getPairPrior/getHaplotypePrior
(DInDel.cpp:1835-1927).

All math is float64 on the (reads x haps) log-likelihood matrix computed by
the pair-HMM backend; per-window cost is O(nh^2 * nr) and negligible next
to the HMM, so it runs on host for bit-stable calls."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

from .config import Parameters
from .model import Haplotype, MLAlignment, Read
from .glf import OutputData
from .utils import add_logs
from .variants import AlignedCandidates, AlignedVariant, DEL, INS, SNP

NEG = -math.inf
VARSNP = 1
VARINDEL = 2
# A read whose likelihoods on the two haplotypes of the called pair lie
# within TIE * max(1, |ll|) of each other is a tie in exact arithmetic:
# which of the two the caller takes (`use1`) is decided by rounding (the
# compiled C++'s own decides it by one ulp), so a program that rounds
# otherwise may count it the other way.  A "dip" row whose counts such
# reads could move carries each count's range ("tied" below).  TIE lies
# between the largest gap the program's float32 rounding moves a read's
# (4.2e-8) and the smallest gap of a read whose choice moves a count
# beyond the exact ties (2.1e-5): PERF.md gives the readings
# (benchmark/ties.py).
TIE = 1e-6


def _is_real_variant(av: AlignedVariant) -> bool:
    """The recurring guard: not *REF and not an R=>D marker
    (DInDel.cpp:3010 and friends)."""
    return not av.is_ref and not (av.is_snp and len(av.str) > 3 and av.str[3] == "D")


def get_pair_prior(av1: AlignedVariant, av2: AlignedVariant, left_pos: int,
                   candidates: AlignedCandidates, params: Parameters) -> float:
    """DetInDel::getPairPrior (DInDel.cpp:1835-1855)."""
    vars_: List[AlignedVariant] = []
    for av in (av1, av2):
        if not any(v.start_hap == av.start_hap and v.str == av.str for v in vars_):
            vars_.append(av)
    ll = 0.0
    for avar in vars_:
        lnf = 0.0
        if avar.type == SNP:
            lnf = math.log(params.prior_snp)
        elif avar.type in (DEL, INS):
            lnf = math.log(params.prior_indel)
        av = candidates.find_variant(avar.start_hap + left_pos, avar.type, avar.str)
        if av is None:
            ll += lnf
        else:
            ll += lnf if av.freq < 0.0 else math.log(av.freq)
    return ll


def get_haplotype_prior(h1: Haplotype, h2: Haplotype, left_pos: int,
                        candidates: AlignedCandidates, params: Parameters) -> float:
    """DetInDel::getHaplotypePrior (DInDel.cpp:1857-1927)."""
    indels: Set[Tuple[int, str]] = set()
    snps: Set[Tuple[int, str]] = set()
    av_of: Dict[Tuple[int, str], AlignedVariant] = {}
    for h in (h1, h2):
        for av in h.indels.values():
            if "*REF" not in av.str and "=>" not in av.str:
                key = (av.start_hap, av.str)
                indels.add(key)
                av_of[key] = av
        for av in h.snps.values():
            if "*REF" not in av.str and "=>D" not in av.str:
                key = (av.start_hap, av.str)
                snps.add(key)
                av_of[key] = av
    ll = 0.0
    for key in sorted(indels) + sorted(snps):
        avar = av_of[key]
        av = candidates.find_variant(avar.start_hap + left_pos, avar.type, avar.str)
        if av is None:
            ll += math.log(params.prior_indel)
        else:
            ll += math.log(params.prior_indel) if av.freq < 0.0 else math.log(av.freq)
    return ll


def diploid_glf(haps: List[Haplotype], reads: List[Read],
                liks: List[List[MLAlignment]], cand_pos: int, left_pos: int,
                right_pos: int, glf_data: Optional[OutputData], index: int,
                candidates: AlignedCandidates, params: Parameters,
                filtered: List[int],
                var_coverage: Dict[Tuple[int, str], Tuple[int, int]],
                program: str = "all") -> List[dict]:
    """Returns the list of emitted GLF rows as dicts (also written to
    glf_data when provided). filtered/var_coverage come from
    filter_haplotypes."""
    import numpy as np
    from .arrays import LiksArrays, add_logs_arr, seq_sum

    nh = len(haps)
    nr = len(reads)
    rows: List[dict] = []

    A = LiksArrays(liks, haps, reads, params)
    ll2d = A.ll  # (nh, nr); the reference's rl[r*nh+h] transposed

    # all variants across haplotypes (DInDel.cpp:2969-3017)
    all_variants: List[Tuple[int, AlignedVariant]] = []
    seen: Set[Tuple[int, str]] = set()
    hap_num_indels = [h.count_indels() for h in haps]
    hap_num_snps = [h.count_snps() for h in haps]
    hap_num_candidate_indels = [0] * nh
    for th, hap in enumerate(haps):
        if hap_num_indels[th] != 0:
            nc = 0
            for av in hap.indels.values():
                if candidates.find_variant(av.start_hap + left_pos, av.type, av.str):
                    nc += 1
            hap_num_candidate_indels[th] = nc
        for p, av in hap.indels.items():
            if _is_real_variant(av) and (p, av.str) not in seen:
                seen.add((p, av.str))
                all_variants.append((p, av))
    all_variants.sort(key=lambda pa: (pa[0], pa[1].str))
    all_by_pos: Dict[int, List[Tuple[int, AlignedVariant]]] = {}
    for p, av in all_variants:
        all_by_pos.setdefault(p, []).append((p, av))

    var_positions = sorted(all_by_pos)
    pos_to_idx = {p: i for i, p in enumerate(var_positions)}
    num_var_pos = len(var_positions)
    nv = len(all_variants)

    hap_var = [[0] * num_var_pos for _ in range(nh)]
    var_type = [0] * (nv + 1)
    variants: List[Optional[Tuple[int, AlignedVariant]]] = [None] * (nv + 1)
    for idx, (p, av) in enumerate(all_variants, start=1):
        var_type[idx] = VARINDEL if av.is_indel else VARSNP
        pi = pos_to_idx[p]
        for h in range(nh):
            it = haps[h].indels.get(p)
            if it is not None and it.str == av.str:
                hap_var[h][pi] = idx
        variants[idx] = (p, av)

    # pair posteriors (DInDel.cpp:3070-3113), vectorized over unfiltered
    # pairs with the reference's exact accumulation order: per pair,
    # ll = fold over reads of log(0.5)+addLogs(rl[r][h1],rl[r][h2]),
    # then post = ll + prior
    log5 = math.log(0.5)
    pair_list = [(h1, h2) for h1 in range(nh) if not filtered[h1]
                 for h2 in range(h1, nh) if not filtered[h2]]
    prior = {}
    pairs_posterior = {}
    max_indel_pair = [-1, -1]
    max_noindel_pair = [-1, -1]
    max_ll_indel = NEG
    max_ll_noindel = NEG
    if pair_list:
        h1v = np.array([pq[0] for pq in pair_list])
        h2v = np.array([pq[1] for pq in pair_list])
        # T[k, r] = log(0.5) + addLogs(rl[r][h1_k], rl[r][h2_k])
        T = log5 + add_logs_arr(ll2d[h1v, :], ll2d[h2v, :])
        base_ll = (np.cumsum(T, axis=1)[:, -1] if nr
                   else np.zeros(len(pair_list)))
        prior_v = np.array([get_haplotype_prior(haps[h1], haps[h2],
                                                left_pos, candidates, params)
                            for h1, h2 in pair_list])
        posts = base_ll + prior_v
        cand_v = np.array(hap_num_candidate_indels)
        is_ind = (cand_v[h1v] > 0) | (cand_v[h2v] > 0)
        for k, pq in enumerate(pair_list):
            prior[pq] = float(prior_v[k])
            pairs_posterior[pq] = float(posts[k])
        # first strict maximum in pair order (matches the loop's >)
        ind_posts = np.where(is_ind, posts, NEG)
        if is_ind.any():
            k = int(np.argmax(ind_posts))
            max_ll_indel = float(ind_posts[k])
            max_indel_pair = list(pair_list[k])
        noind_posts = np.where(~is_ind, posts, NEG)
        if (~is_ind).any():
            k = int(np.argmax(noind_posts))
            max_ll_noindel = float(noind_posts[k])
            max_noindel_pair = list(pair_list[k])

    # MAP call block ("dip.map" rows, DInDel.cpp:3115-3307)
    qual = -10.0 * (max_ll_noindel - add_logs(max_ll_indel, max_ll_noindel)) / math.log(10.0)
    if max_indel_pair[0] == -1 or max_indel_pair[1] == -1:
        raise _WindowThrow("Could not find indel allele")
    hx1, hx2 = max_indel_pair
    unmapped_v = np.array([r.is_unmapped for r in reads], bool)
    num_unmapped_realigned = int(
        (unmapped_v & (~A.off[hx1] | ~A.off[hx2])).sum())

    indel_sites: Dict[int, List[AlignedVariant]] = {}
    for i in range(2):
        hap = haps[max_indel_pair[i]]
        for p, av in hap.indels.items():
            if (not av.is_ref) or (av.is_snp and len(av.str) > 3 and av.str[3] == "D"):
                lst = indel_sites.setdefault(p, [])
                if not any(x.str == av.str for x in lst):
                    lst.append(av)
    reverse_v = np.array([r.on_reverse_strand for r in reads], bool)
    mq2_v = np.array([(-10.0 * math.log10(1.0 - r.map_qual)) ** 2
                      for r in reads])
    for p in sorted(indel_sites):
        alleles = sorted(indel_sites[p], key=lambda a: a.str)
        numf = numr = n = 0
        msq_terms = []
        m = 1 if max_indel_pair[0] == max_indel_pair[1] else 2
        for i in range(m):
            h = max_indel_pair[i]
            it = haps[h].indels.get(p)
            if it is not None and it.is_indel:
                cov = A.indel_covered(h, p)
                numf += int((cov & ~reverse_v).sum())
                numr += int((cov & reverse_v).sum())
                n += int(cov.sum())
                msq_terms.append(mq2_v[cov])
        # single sequential fold across both pair members, matching the
        # reference's running msq += mq*mq
        msq = seq_sum(np.concatenate(msq_terms)) if msq_terms else 0.0
        msq = math.sqrt(msq / n) if n != 0 else 0.0

        was_candidate = 0
        vc_f = vc_r = 0
        av0 = alleles[0]
        if candidates.find_variant(av0.start_hap + left_pos, av0.type, av0.str):
            was_candidate = 1
        vc = var_coverage.get((p, av0.str), (0, 0))
        vc_f += vc[0]
        vc_r += vc[1]

        a1 = a2 = "*REF"
        a1_ref = a2_ref = True
        it1 = haps[hx1].indels.get(p)
        it2 = haps[hx2].indels.get(p)
        if it1 is not None and not it1.is_ref:
            a1 = it1.str
            a1_ref = False
        if it2 is not None and not it2.is_ref:
            a2 = it2.str
            a2_ref = False
        all_genotype = {a1, a2}
        if a1_ref and a2_ref:
            raise _WindowThrow("genotyping error")
        if a1 == a2:
            genotype = "1/1"
            nref_all = a1
        elif a1_ref:
            genotype = "0/1"
            nref_all = a2
        elif a2_ref:
            genotype = "0/1"
            nref_all = a1
        else:
            nref_all = a1 + "," + a2
            genotype = "1/2"
            av_last = alleles[-1]
            if candidates.find_variant(av_last.start_hap + left_pos, av_last.type, av_last.str):
                was_candidate = 1
            vc = var_coverage.get((p, av_last.str), (0, 0))
            vc_f += vc[0]
            vc_r += vc[1]

        # genotype quality vs best alternative genotype (DInDel.cpp:3238-3266)
        max_ll_altgeno = NEG
        for h1 in range(nh):
            if filtered[h1]:
                continue
            for h2 in range(h1, nh):
                if filtered[h2]:
                    continue
                if (h1 == hx1 and h2 == hx2) or (h2 == hx1 and h1 == hx2):
                    continue
                alt_geno = set()
                for hh in (h1, h2):
                    it = haps[hh].indels.get(p)
                    if it is None or it.is_ref:
                        alt_geno.add("*REF")
                    else:
                        alt_geno.add(it.str)
                if alt_geno != all_genotype and max_ll_altgeno < pairs_posterior[(h1, h2)]:
                    max_ll_altgeno = pairs_posterior[(h1, h2)]
        genoqual = -10.0 * (max_ll_altgeno - add_logs(max_ll_indel, max_ll_altgeno)) / math.log(10.0)

        row = dict(msg="ok", index=index, tid=params.tid,
                   analysis_type="dip.map", indidx=0, lpos=left_pos,
                   rpos=right_pos, center_position=cand_pos,
                   realigned_position=p + left_pos,
                   was_candidate_in_window=was_candidate, qual=qual,
                   nref_all=nref_all, num_reads=nr, msq=msq,
                   num_cover_forward=numf, num_cover_reverse=numr,
                   var_coverage_forward=vc_f, var_coverage_reverse=vc_r,
                   num_unmapped_realigned=num_unmapped_realigned,
                   glf=f"{genotype}:{_g(genoqual)}")
        rows.append(row)
        _emit(glf_data, row)

    # per-site genotype marginals ("dip" rows, DInDel.cpp:3310-3660).
    # The per-pair read fold is the same T as above but STARTS at the
    # per-(site, pair) prior — float association differs from base_ll+pr,
    # so each fold is replayed exactly: cumsum over [pr, t_0, ..., t_nr-1]
    for p in var_positions:
        has_variants_in_window = 0
        for (pp, av) in all_by_pos[p]:
            if candidates.find_variant(av.start_hap + left_pos, av.type, av.str):
                has_variants_in_window = 1
                break
        pos_idx = pos_to_idx[p]
        gen_liks: Dict[Tuple[int, int], float] = {}
        maxll = NEG
        ghx1 = ghx2 = 0
        pair_pr = np.empty(len(pair_list))
        pair_geno = []
        for k, (h1, h2) in enumerate(pair_list):
            v1 = hap_var[h1][pos_idx]
            v2 = hap_var[h2][pos_idx]
            pair_geno.append(tuple(sorted({v1, v2})))
            av1 = variants[v1][1] if v1 else AlignedVariant("*REF", start_hap=-1)
            av2 = variants[v2][1] if v2 else AlignedVariant("*REF", start_hap=-1)
            log_prior_pos = get_pair_prior(av1, av2, left_pos, candidates, params)
            pair_pr[k] = prior[(h1, h2)] - log_prior_pos
        lls = np.cumsum(np.concatenate([pair_pr[None, :], T.T], axis=0),
                        axis=0)[-1]
        for k, (h1, h2) in enumerate(pair_list):
            ll = float(lls[k])
            genotype = pair_geno[k]
            if genotype in gen_liks:
                gen_liks[genotype] = add_logs(gen_liks[genotype], ll)
            else:
                gen_liks[genotype] = ll
            if ll > maxll:
                maxll = ll
                ghx1, ghx2 = h1, h2

        num_unmapped_realigned2 = int(
            (unmapped_v & (~A.off[ghx1] | ~A.off[ghx2])).sum())

        if params.output_pooled_likelihoods:
            raise ValueError("the reference has no --opl dump")

        # per-read stats at the per-read ML haplotype of the (ghx1, ghx2)
        # pair (DInDel.cpp:3491-3561), gathered by mlidx
        use1, tied = read_choice(ll2d, ghx1, ghx2)
        ranges = {}

        def _count(col, v1, v2):
            n, lo, hi = count_range(v1, v2, use1, tied)
            if lo != hi:
                ranges[col] = (lo, hi)
            return n

        allmsq = seq_sum(mq2_v)

        def _pick(a2d):
            return np.where(use1, a2d[ghx1], a2d[ghx2])

        num_off_both = int((A.off[ghx1] & A.off[ghx2]).sum())
        num_mapped_indels = _count("num_indel", A.nind_entries_row(ghx1),
                                   A.nind_entries_row(ghx2))
        n_bqt = _count("nBQT", A.nbqt[ghx1], A.nbqt[ghx2])
        nmm_bqt = _count("nmmBQT", A.nmmbqt[ghx1], A.nmmbqt[ghx2])
        m_log_bq = seq_sum(_pick(A.mlogbq))
        n_mm_left = _count("nMMLeft", A.nmml[ghx1] >= 2, A.nmml[ghx2] >= 2)
        n_mm_right = _count("nMMRight", A.nmmr[ghx1] >= 2, A.nmmr[ghx2] >= 2)

        def _cov_at(h):
            hit = haps[h].indels.get(p)
            if hit is not None and hit.is_indel:
                return A.indel_covered(h, p)
            if hit is not None and hit.is_snp:
                return A.snp_covered(h, p)
            return np.zeros(nr, bool)

        cov1, cov2 = _cov_at(ghx1), _cov_at(ghx2)
        cov = np.where(use1, cov1, cov2)
        nf = _count("num_cover_forward", cov1 & ~reverse_v, cov2 & ~reverse_v)
        nr_count = _count("num_cover_reverse", cov1 & reverse_v,
                          cov2 & reverse_v)
        n = int(cov.sum())
        msq = seq_sum(mq2_v[cov])
        msq = math.sqrt(msq / n) if n != 0 else 0.0
        allmsq = math.sqrt(allmsq / nr) if nr != 0 else 0.0

        # allele recoding to VCF-ish indexes (DInDel.cpp:3564-3590)
        to_vcf_idx = {0: 0}
        nidx = 1
        o_alleles = []
        o_cov_f = []
        o_cov_r = []
        for h in range(nh):
            v = hap_var[h][pos_idx]
            if v != 0 and v not in to_vcf_idx:
                to_vcf_idx[v] = nidx
                nidx += 1
                pav = variants[v]
                o_alleles.append(pav[1].str)
                vc = var_coverage.get((pav[0], pav[1].str), (0, 0))
                o_cov_f.append(str(vc[0]))
                o_cov_r.append(str(vc[1]))

        glf_parts = []
        for genotype in sorted(gen_liks):
            v1, v2 = genotype[0], genotype[-1]
            a1 = to_vcf_idx[v1]
            a2 = to_vcf_idx[v2]
            glf_parts.append(f"{a1}/{a2}:{_g(gen_liks[genotype])}")

        row = dict(msg="ok", index=index, tid=params.tid,
                   analysis_type=program, indidx=0, lpos=left_pos,
                   rpos=right_pos, center_position=cand_pos,
                   realigned_position=p + left_pos,
                   was_candidate_in_window=has_variants_in_window,
                   logZ=maxll, nBQT=n_bqt, nmmBQT=nmm_bqt,
                   # nBQT==0 implies mLogBQ==0.0 (no bases passed the quality
                   # threshold), and the reference's 0.0/0.0 is the x86
                   # default QNaN with the SIGN BIT SET — printed "-nan"
                   # (DInDel.cpp:3635)
                   mLogBQ=(m_log_bq / n_bqt) if n_bqt else float("-nan"),
                   nMMLeft=n_mm_left, nMMRight=n_mm_right,
                   nref_all=",".join(o_alleles), num_reads=nr, msq=allmsq,
                   numOffAll=num_off_both, num_indel=num_mapped_indels,
                   num_cover_forward=nf, num_cover_reverse=nr_count,
                   var_coverage_forward=",".join(o_cov_f),
                   var_coverage_reverse=",".join(o_cov_r),
                   glf=",".join(glf_parts),
                   num_unmapped_realigned=num_unmapped_realigned2)
        if ranges:
            row["tied"] = ";".join(f"{c}={lo}-{hi}"
                                   for c, (lo, hi) in ranges.items())
        rows.append(row)
        if params.output_glf:
            _emit(glf_data, row)
    return rows


def read_choice(ll2d, h1: int, h2: int):
    """(use1, tied) of every read at the pair (h1, h2): whether the caller
    takes h1 (DInDel.cpp:3491-3561), and whether rounding decides it."""
    import numpy as np
    l1, l2 = ll2d[h1], ll2d[h2]
    return l1 >= l2, np.abs(l1 - l2) <= TIE * np.maximum(1.0, np.abs(l2))


def count_range(v1, v2, use1, tied):
    """(count, lo, hi): the count over reads of v1 (the pair's first
    haplotype) or v2 (its second) as use1 picks, and its range over the
    tied reads' two choices."""
    import numpy as np
    pick = np.where(use1, v1, v2)
    lo = int(np.where(tied, np.minimum(v1, v2), pick).sum())
    hi = int(np.where(tied, np.maximum(v1, v2), pick).sum())
    return int(pick.sum()), lo, hi


class _WindowThrow(Exception):
    pass


def _g(x: float) -> str:
    return "%g" % x


def _emit(glf_data: Optional[OutputData], row: dict) -> None:
    if glf_data is None:
        return
    line = glf_data.line()
    for k, v in row.items():
        if k == "tied":
            line.note = "tied:" + v
        else:
            line.set(k, v)
    glf_data.output(line)
