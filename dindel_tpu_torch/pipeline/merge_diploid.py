"""GLF -> VCF merge for diploid calls: port of python/mergeOutputDiploid.py
(row selection :176-238, allele recoding/VCF string :35-155, header and
position-ordered output :240-318)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..io.fasta import FastaFile
from ..out.glf import GLFReader


def homopolymer_length(seq: str, pos: int) -> int:
    """utils/AnalyzeSequence.py HomopolymerLength (note: the backward scan
    stops at index 1, a reference quirk kept for parity)."""
    hp = 1
    for i in range(pos + 1, len(seq)):
        if seq[i] == seq[i - 1]:
            hp += 1
        else:
            break
    for i in range(pos - 1, 0, -1):
        if seq[i] == seq[i + 1]:
            hp += 1
        else:
            break
    return hp


def _var_fields(var: str) -> Tuple[str, str, int]:
    """(type, seq, length) like utils/Variant.py."""
    if var.startswith("-"):
        return "del", var[1:], len(var) - 1
    if var.startswith("+"):
        return "ins", var[1:], len(var) - 1
    if len(var) == 4 and var[1:3] == "=>":
        return "snp", var[3], 1
    if var.startswith("*") or "REF" in var or "ref" in var:
        return "ref", "", 0
    raise ValueError(f"Unrecognized variant: {var}")


def get_vcf_string(glf: dict, fa: FastaFile, max_hp_len: int = 10,
                   filter_qual: int = 20) -> Tuple[str, int]:
    """mergeOutputDiploid.py getVCFString (:35-155)."""
    filters: List[str] = []
    pos = int(glf["pos"])
    chrom = glf["chr"]
    # fa.get(chr, pos+1-25, 50) in the reference is 1-based: 0-based pos-25,
    # so index 25 is the variant base itself (mergeOutputDiploid.py:46-47)
    seq = fa.get0(chrom, pos - 25, 50)
    hplen = homopolymer_length(seq, 25)

    report_pos = pos
    max_del_len = 0
    for gta in set(glf["nref_all"]):
        t, s, ln = _var_fields(gta)
        if t == "del" and ln > max_del_len:
            max_del_len = ln
    seqlen = 1 + max_del_len
    # 1-based fa.get(chr, report_pos, seqlen) (:62): the REF string starts at
    # the VCF anchor base, 0-based report_pos-1
    refseq = fa.get0(chrom, report_pos - 1, seqlen)

    altseqs: List[str] = []
    altseq_to_type: Dict[str, str] = {}
    for gta in glf["nref_all"]:
        t, s, ln = _var_fields(gta)
        g_code = -1
        if t == "del":
            g_altseq = refseq[0] + refseq[1 + ln:]
        elif t == "ins":
            g_altseq = refseq[0] + s + refseq[1:]
        elif t == "snp":
            g_altseq = refseq[0] + s[0] + refseq[2:]
        elif t == "ref":
            g_altseq = refseq
            g_code = 0
        else:
            raise ValueError("Unknown allele")
        if g_code == -1:
            if g_altseq not in altseqs:
                altseqs.append(g_altseq)
                altseq_to_type[g_altseq] = t

    gtd = glf["genotype"].split(":")
    rec_gt = f"{gtd[0]}:{int(float(gtd[1]))}"

    only_snps = all(altseq_to_type[a] == "snp" for a in altseqs)
    if only_snps:
        report_pos += 1
        refseq = fa.get0(chrom, report_pos - 1, 1)
        altseqs = [a[1:] for a in altseqs]

    if hplen > max_hp_len:
        filters.append(f"hp{max_hp_len}")
    if glf["qual"] < filter_qual:
        filters.append(f"q{filter_qual}")

    altseqs = ["<DEL>" if "D" in a else a for a in altseqs]
    filter_str = ";".join(filters) if filters else "PASS"
    info = (f"DP={int(glf['num_hap_reads'])};NF={int(glf['num_cover_forward'])};"
            f"NR={int(glf['num_cover_reverse'])};NRS={int(glf['num_cover_forward_old'])};"
            f"NFS={int(glf['num_cover_reverse_old'])};HP={hplen}")
    rstr = (f"{glf['chr']}\t{report_pos}\t.\t{refseq}\t{','.join(altseqs)}\t"
            f"{glf['qual']}\t{filter_str}\t{info}\tGT:GQ\t{rec_gt}")
    return rstr, report_pos


def process_diploid_glf(glf_file: str, variants: Dict[str, Dict[int, List[str]]],
                        fa: FastaFile, max_hp_len: int = 10,
                        filter_qual: int = 20) -> int:
    """processDiploidGLFFile (:158-238). Returns #skipped windows."""
    num_skipped = 0
    for dat in GLFReader(glf_file):
        if dat["msg"] != "ok":
            num_skipped += 1
            continue
        if dat["analysis_type"] != "dip.map":
            continue
        if dat["was_candidate_in_window"] != "1":
            continue
        glf = {
            "chr": dat["tid"],
            "pos": dat["realigned_position"],
            "qual": int(float(dat["qual"])),
        }
        if float(glf["qual"]) < 1.0:
            continue
        glf["nref_all"] = dat["nref_all"].split(",")
        if glf["nref_all"] == ["R=>D"]:
            continue
        nfa = dat["var_coverage_forward"].split(",")
        nra = dat["var_coverage_reverse"].split(",")
        glf["num_cover_forward"] = int(nfa[0])
        glf["num_cover_reverse"] = int(nra[0])
        glf["num_cover_forward_old"] = int(dat["num_cover_forward"])
        glf["num_cover_reverse_old"] = int(dat["num_cover_reverse"])
        glf["num_hap_reads"] = dat["num_reads"]
        glf["genotype"] = dat["glf"]
        vcf_str, report_pos = get_vcf_string(glf, fa, max_hp_len, filter_qual)
        variants.setdefault(glf["chr"], {}).setdefault(report_pos, []).append(vcf_str)
    return num_skipped


VCF_HEADER_LINES = [
    "##fileformat=VCFv4.0",
    "##source=Dindel",
]


def merge_output_diploid(glf_files: List[str], vcf_path: str, ref_file: str,
                         sample_id: str = "SAMPLE", max_hp_len: int = 10,
                         filter_qual: int = 20) -> None:
    """mergeOutput (:240-318)."""
    fa = FastaFile(ref_file)
    with open(vcf_path, "w") as fv:
        fv.write("##fileformat=VCFv4.0\n")
        fv.write("##source=Dindel\n")
        fv.write(f"##reference={ref_file}\n")
        fv.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Total number of reads in haplotype window">\n')
        fv.write('##INFO=<ID=HP,Number=1,Type=Integer,Description="Reference homopolymer tract length">\n')
        fv.write('##INFO=<ID=NF,Number=1,Type=Integer,Description="Number of reads covering non-ref variant on forward strand">\n')
        fv.write('##INFO=<ID=NR,Number=1,Type=Integer,Description="Number of reads covering non-ref variant on reverse strand">\n')
        fv.write('##INFO=<ID=NFS,Number=1,Type=Integer,Description="Number of reads covering non-ref variant site on forward strand">\n')
        fv.write('##INFO=<ID=NRS,Number=1,Type=Integer,Description="Number of reads covering non-ref variant site on reverse strand">\n')
        fv.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        fv.write('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">\n')
        fv.write('##ALT=<ID=DEL,Description="Deletion">\n')
        fv.write(f'##FILTER=<ID=q{filter_qual},Description="Quality below {filter_qual}">\n')
        fv.write(f'##FILTER=<ID=hp{max_hp_len},Description="Reference homopolymer length was longer than {max_hp_len}">\n')
        fv.write('##FILTER=<ID=fr0,Description="Non-ref allele is not covered by at least one read on both strands">\n')
        fv.write('##FILTER=<ID=wv,Description="Other indel in window had higher likelihood">\n')
        fv.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample_id}\n")

        variants: Dict[str, Dict[int, List[str]]] = {}
        for gf in glf_files:
            process_diploid_glf(gf, variants, fa, max_hp_len, filter_qual)

        chromosomes = [str(v) for v in range(1, 23)] + ["X", "Y"]
        for chrom in variants:
            if chrom not in chromosomes:
                chromosomes.append(chrom)
        for chrom in chromosomes:
            if chrom in variants:
                for pos in sorted(variants[chrom]):
                    for line in variants[chrom][pos]:
                        fv.write(line + "\n")
    fa.close()
