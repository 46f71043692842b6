"""Pooled GLF -> VCF merge: port of python/mergeOutputPooled.py
(processPooledGLFFiles :202-575, getPercentiles :8-32).

Aggregates 'singlevariant' GLF rows across the per-BAM blocks of each
variant, applies the posterior>0.2 candidate cut, then the q/fr0/ocr
(1-99% depth percentile)/s50/hp/mf filters and the tc closeness filter,
and writes a sites-only VCF4.0."""

from __future__ import annotations

import math
from typing import Dict, List

from ..io.fasta import FastaFile
from .merge_diploid import homopolymer_length, _var_fields


def get_percentiles(hist: Dict[int, int], pctiles=(1, 99)) -> List[int]:
    """mergeOutputPooled.getPercentiles (:8-32)."""
    vals = sorted(hist)
    cum = {}
    prevk = 0
    for idx, k in enumerate(vals):
        cum[k] = hist[k]
        if idx > 0:
            cum[k] += cum[prevk]
        prevk = k
    tot = cum[prevk] if vals else 0
    iles_k = [0] * len(pctiles)
    ilidx = 0
    for k in vals:
        if ilidx < len(pctiles) and cum[k] > pctiles[ilidx] / 100.0 * tot:
            iles_k[ilidx] = k
            ilidx += 1
    return iles_k


def merge_output_pooled(glf_files: List[str], vcf_path: str, ref_file: str,
                        num_samples: int, num_bam_files: int = 1,
                        max_hp_len: int = 10, min_forward_reverse: int = 1,
                        min_dist: int = 10, filter_qual: int = 20,
                        do_not_filter_on_fr: bool = True,
                        db_snp_window: int = 50) -> None:
    fa = FastaFile(ref_file)
    num_inds = num_samples
    min_freq = 1.0 / (2.0 * num_inds * 5) if num_inds else 0.0

    var_stat: Dict[str, Dict[int, Dict[str, dict]]] = {}
    rdhist: Dict[int, int] = {}

    from ..out.glf import GLFReader
    for gf in glf_files:
        rdr = GLFReader(gf)
        rows = iter(rdr)
        done = False
        while not done:
            pos = -1
            var = ""
            chrom = None
            num_ind_with_data = 0
            tot_coverage = 0
            tot_nf = tot_nr = 0
            tot_nf_old = tot_nr_old = 0
            skip = False
            dat = None
            for fidx in range(num_bam_files):
                dat = next(rows, None)
                if dat is None:
                    done = True
                    break
                if dat["realigned_position"] == "NA":
                    skip = True
                    break
                if dat["analysis_type"] != "singlevariant":
                    skip = True
                    break
                if dat["indidx"] != "NA" and int(dat["indidx"]) >= num_bam_files:
                    raise ValueError(
                        "Error. Is the number of BAM files correctly specified?")
                if pos == -1:
                    pos = int(dat["realigned_position"])
                    var = dat["nref_all"]
                    chrom = dat["tid"]
                else:
                    if int(dat["realigned_position"]) != pos:
                        raise ValueError(
                            "Inconsistent glf files! Is the number of BAM "
                            "files correctly specified?")
                tot_nf_old += int(dat["num_cover_forward"])
                tot_nr_old += int(dat["num_cover_reverse"])
                if fidx == 0:
                    tot_nf = int(dat["var_coverage_forward"])
                    tot_nr = int(dat["var_coverage_reverse"])
                numreads = int(dat["num_reads"])
                if numreads > 0:
                    num_ind_with_data += 1
                tot_coverage += numreads
            if skip:
                continue
            if done:
                break
            prob = float(dat["post_prob_variant"])
            freq = float(dat["est_freq"])
            rdhist[tot_coverage] = rdhist.get(tot_coverage, 0) + 1
            if prob > 0.20:
                # 1-based fa.get(chr, pos+1-25, 50) (mergeOutputPooled.py:370)
                seq = fa.get0(chrom, pos - 25, 50)
                hplen = homopolymer_length(seq, 25)
                var_stat.setdefault(chrom, {}).setdefault(pos, {})[var] = {
                    "QUAL": prob, "NF": tot_nf, "NR": tot_nr,
                    "NFS": tot_nf_old, "NRS": tot_nr_old,
                    "DP": tot_coverage, "NS": num_ind_with_data,
                    "AF": freq, "HP": hplen,
                }

    coverage_range = get_percentiles(rdhist, [1, 99])
    fqp = 1.0 - math.pow(10.0, -filter_qual / 10.0)
    fqp_str = f"q{filter_qual}"
    tc_filter = f"tc{min_dist}"

    pass_filters: Dict[str, Dict[int, List[str]]] = {}
    for chrom in var_stat:
        for pos in var_stat[chrom]:
            for varseq, v in var_stat[chrom][pos].items():
                filters = []
                if v["QUAL"] < fqp:
                    filters.append(fqp_str)
                if (v["NF"] < min_forward_reverse or v["NR"] < min_forward_reverse) \
                        and not do_not_filter_on_fr:
                    filters.append("fr0")
                if v["DP"] < coverage_range[0] or v["DP"] > coverage_range[1]:
                    filters.append("ocr")
                if v["NS"] < num_inds / 2:
                    filters.append("s50")
                if v["HP"] > max_hp_len:
                    filters.append(f"hp{max_hp_len}")
                if v["AF"] < min_freq:
                    filters.append("mf")
                if not filters:
                    pass_filters.setdefault(chrom, {}).setdefault(pos, []).append(varseq)
                v["filter"] = ";".join(filters)

    chromosomes = [str(c) for c in range(1, 23)] + ["X", "Y"]
    for c in var_stat:
        if c not in chromosomes:
            chromosomes.append(c)

    with open(vcf_path, "w") as fv:
        fv.write("##fileformat=VCFv4.0\n")
        fv.write("##source=Dindel\n")
        fv.write(f"##reference={ref_file}\n")
        fv.write('##INFO=<ID=NS,Number=1,Type=Integer,Description="Number of samples with data">\n')
        fv.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Total number of reads in haplotype window">\n')
        fv.write('##INFO=<ID=HP,Number=1,Type=Integer,Description="Reference homopolymer tract length">\n')
        fv.write('##INFO=<ID=NFS,Number=1,Type=Integer,Description="Number of reads covering non-ref variant site on forward strand">\n')
        fv.write('##INFO=<ID=NRS,Number=1,Type=Integer,Description="Number of reads covering non-ref variant site on reverse strand">\n')
        fv.write('##INFO=<ID=NF,Number=1,Type=Integer,Description="Number of reads covering non-ref variant on forward strand">\n')
        fv.write('##INFO=<ID=NR,Number=1,Type=Integer,Description="Number of reads covering non-ref variant on reverse strand">\n')
        fv.write('##INFO=<ID=AF,Number=-1,Type=Float,Description="Allele frequency">\n')
        fv.write(f'##INFO=<ID=DB,Number=0,Type=Flag,Description="dbSNP membership build 129 - type match and indel sequence length match within {db_snp_window} bp">\n')
        fv.write(f'##FILTER=<ID=q{filter_qual},Description="Quality below {filter_qual}">\n')
        fv.write('##FILTER=<ID=s50,Description="Less than 50% of samples have data">\n')
        fv.write(f'##FILTER=<ID=tc{min_dist},Description="Indel site was closer than {min_dist} base pairs from another site with higher posterior probability">\n')
        fv.write(f'##FILTER=<ID=hp{max_hp_len},Description="Reference homopolymer length was longer than {max_hp_len}">\n')
        if not do_not_filter_on_fr:
            fv.write('##FILTER=<ID=fr0,Description="Non-ref allele is not covered by at least one read on both strands">\n')
        fv.write(f'##FILTER=<ID=ocr,Description="Number of reads in haplotype window outside coverage range {coverage_range[0]} {coverage_range[1]}">\n')
        fv.write('##FILTER=<ID=mf,Description="Too low non-ref allele frequency">\n')
        fv.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")

        for chrom in chromosomes:
            if chrom not in pass_filters:
                continue
            # closeness clustering (tc filter), mergeOutputPooled.py:466-531
            positions = sorted(pass_filters[chrom])
            new_position = positions[:]
            done2 = False
            while not done2:
                done2 = True
                for p in range(1, len(positions)):
                    if (new_position[p] != new_position[p - 1]
                            and new_position[p] - positions[p - 1] <= min_dist):
                        new_position[p] = new_position[p - 1]
                        done2 = False
            new_sites: Dict[int, Dict[int, List[str]]] = {}
            for p, np_ in zip(positions, new_position):
                new_sites.setdefault(np_, {}).setdefault(p, [])
                for var in var_stat[chrom][p]:
                    new_sites[np_][p].append(var)
            for np_ in new_sites:
                old = list(new_sites[np_])
                pos_probs = []
                pos_pos = []
                for old_pos in old:
                    max_prob = -1.0
                    for var in new_sites[np_][old_pos]:
                        prob = var_stat[chrom][old_pos][var]["QUAL"]
                        if prob > max_prob:
                            max_prob = prob
                    pos_probs.append(max_prob)
                    pos_pos.append(old_pos)
                okpos = pos_pos[pos_probs.index(max(pos_probs))]
                for duppos in set(old) - {okpos}:
                    for var in var_stat[chrom][duppos]:
                        # (the reference's '==' on the empty-filter branch is
                        # a no-op bug kept for parity: only already-filtered
                        # sites accumulate the tc tag)
                        if var_stat[chrom][duppos][var]["filter"] != "":
                            var_stat[chrom][duppos][var]["filter"] += ";" + tc_filter

            for pos in sorted(var_stat[chrom]):
                for var, v in var_stat[chrom][pos].items():
                    report_pos = pos
                    qual = -int(10.0 * math.log10(max(1.0 - float(v["QUAL"]), 1e-10)))
                    info = ";".join(f"{t}={v[t]}" for t in
                                    ("AF", "NS", "DP", "HP", "NF", "NR", "NFS", "NRS"))
                    typ, seq, ln = _var_fields(var)
                    max_del_len = ln if typ == "del" else 0
                    # 1-based fa.get(chr, indel_report_pos, seqlen) (:556):
                    # REF starts at the anchor base, 0-based report_pos-1
                    refseq = fa.get0(chrom, report_pos - 1, 1 + max_del_len)
                    if typ == "del":
                        altseq = refseq[0] + refseq[1 + ln:]
                    elif typ == "ins":
                        altseq = refseq[0] + seq + refseq[1:]
                    elif typ == "snp":
                        report_pos += 1
                        # the reference does refseq[1] unguarded (:562) and
                        # would IndexError on a pure-SNP record (seqlen==1);
                        # the fallback fetches the base refseq[1] would have
                        # been: 0-based report_pos-1 = the SNP base
                        refseq = (refseq[1] if len(refseq) > 1
                                  else fa.get0(chrom, report_pos - 1, 1))
                        altseq = seq[0]
                    else:
                        continue
                    filt = v["filter"] or "PASS"
                    fv.write(f"{chrom}\t{report_pos}\t.\t{refseq}\t{altseq}\t"
                             f"{qual}\t{filt}\t{info}\n")
    fa.close()
