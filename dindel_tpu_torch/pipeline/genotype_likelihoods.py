"""Per-sample genotype-likelihood table for pooled calls + VCF->candidate
conversion.

Ports python/makeGenotypeLikelihoodFilePooled.py (join pooled GLF rows
with the call VCF into 'tid pos var 0/0 0/1 1/1 bam' lines) and
python/convertVCFToDindel.py with utils/Variant.py Variant4 (VCF ref/alt
-> dindel variant string + left-shifted offset)."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

from ..io.fasta import FastaFile
from ..out.glf import GLFReader


class Variant4:
    """utils/Variant.py Variant4 (:46-124): dindel-style variant from a
    VCF ref/alt pair, with the left-shift offset."""

    def __init__(self, ref: str, alt: str):
        dlen = len(ref) - len(alt)
        self.offset = 0
        if dlen == 0:
            nm = 0
            refnuc = altnuc = ""
            for idx, (a, b) in enumerate(zip(ref, alt)):
                if a != b:
                    nm += 1
                    self.offset = idx
                    refnuc, altnuc = a, b
            if nm == 0:
                self.type = "ref"
                self.length = 0
                self.seq = ""
                self.str = "REF"
            elif nm == 1:
                self.type = "snp"
                self.length = 1
                self.seq = altnuc
                self.str = f"{refnuc}=>{altnuc}"
            else:
                raise ValueError("MultiSNP")
        else:
            if dlen < 0:
                self.type = "ins"
                _alt, _ref = alt, ref
                self.str = "+"
            else:
                self.type = "del"
                _alt, _ref = ref, alt
                self.str = "-"
            numrb = len(_ref)
            left_match = 0
            right_match = 0
            for x in range(0, len(_ref) + 1):
                if _ref[:x] == _alt[:x]:
                    left_match = x
            for x in range(1, len(_ref) + 1):
                if _ref[-x:] == _alt[-x:]:
                    right_match = x
            if left_match == 0 or left_match + right_match < numrb:
                raise ValueError("Don't think this is a proper VCF4 insertion")
            left_end = 1
            if numrb - left_end > right_match:
                left_end = left_match
            right_start = numrb - left_end
            if right_start == 0:
                self.seq = _alt[left_end:]
            else:
                self.seq = _alt[left_end:-right_start]
            self.offset = left_end
            self.str += self.seq
            self.length = len(self.seq)


class _VCFRecordReader:
    """Replica of utils/VCFFile.py read-mode behavior as far as
    convertVCFToDindel exercises it (VCFFile.py:47-372): '##' header scan
    with VCF v3/v4 version detection (v3.3 headers tolerated, :103-110),
    '#C'-prefixed label line split on whitespace with every '#' stripped
    (:266-267), main-label presence check (:276-278), and parseline's
    quirks — an empty line ends the file ({} -> caller breaks, :286-287)
    and a line with fewer than max-column-index fields warns
    'Cannot parse this line' and ALSO ends the file (:291-292, because
    the partial dict is never populated and readline's {} breaks the
    caller's loop)."""

    _MAIN_LABELS = ("CHROM", "POS", "ID", "REF", "ALT", "QUAL")

    def __init__(self, fname: str):
        import gzip
        import os
        if os.path.splitext(fname)[-1] == ".gz":
            self.f = gzip.open(fname, "rt")
        else:
            self.f = open(fname)
        self.version = None
        self.lab_to_col: Dict[str, int] = {}
        while True:
            line = self.f.readline()
            if line == "":
                raise ValueError("No #CHROM header line in VCF file")
            line = line.rstrip("\n")
            if line[:2] == "##":
                if line.find("fileformat") != -1:
                    if line.find("VCF") == -1 and line.find("vcf") == -1:
                        raise ValueError("Cannot determine VCF version")
                    if line.find("v3") != -1:
                        self.version = 3
                    elif line.find("v4") != -1 or line.find("VCF4") != -1:
                        self.version = 4
                    else:
                        raise ValueError("Cannot determine VCF version")
            elif line[:1] == "#" and line[1:2] == "C":
                labels = line.replace("#", "").split()
                for i, lab in enumerate(labels):
                    self.lab_to_col[lab] = i
                break
        for lab in self._MAIN_LABELS:
            if lab not in self.lab_to_col:
                raise ValueError(
                    f"Could not find column {lab} in header of VCF file!")
        self.min_len = max(self.lab_to_col.values())

    def readline(self) -> Dict[str, str]:
        line = self.f.readline().rstrip("\n")
        if line == "":
            return {}
        col = line.split("\t")
        if len(col) < self.min_len:
            sys.stderr.write("Cannot parse this line:\n" + line + "\n")
            return {}
        return {lab: col[self.lab_to_col[lab]] for lab in self._MAIN_LABELS}

    def close(self):
        self.f.close()


def convert_vcf_to_dindel(vcf_path: str, output_path: str, ref_file: str,
                          min_qual: float = 1.0) -> int:
    """python/convertVCFToDindel.py (:9-46): VCF records -> candidate
    lines 'chrom newpos var'.

    Reference semantics kept exactly: `vcf_path` is a comma-separated
    list of VCF files (:17); a REF/FASTA mismatch only warns
    'REFSEQ inconsistency' on stderr, the record is still converted
    (:32-34); records pass when QUAL is '.' or >= min_qual (:36);
    multi-allelic ALT is split on ',' (:37); '<DEL>' alts and
    length-preserving alts (SNPs/MNPs) are skipped (:40); only ins/del
    Variant4 types are emitted, at pos+offset-1 (:41-43)."""
    fa = FastaFile(ref_file)
    n = 0
    with open(output_path, "w") as fout:
        for vcffile in vcf_path.split(","):
            vcf = _VCFRecordReader(vcffile)
            while True:
                dat = vcf.readline()
                if dat == {}:
                    break
                pos = int(dat["POS"])
                chrom = dat["CHROM"]
                ref = dat["REF"]
                try:
                    # Unknown chromosomes crash in the reference too
                    # (Fasta.py:38-40 raises); out-of-range positions
                    # only yield a garbage compare there, so map our
                    # clamp error to the warn path.
                    rseq = fa.get0(chrom, pos - 1, len(ref))
                except ValueError:
                    rseq = None
                if rseq != ref:
                    sys.stderr.write("REFSEQ inconsistency\n")
                if dat["QUAL"] == "." or float(dat["QUAL"]) >= min_qual:
                    for alt in dat["ALT"].split(","):
                        if alt != "<DEL>" and len(alt) != len(ref):
                            var = Variant4(ref=ref, alt=alt)
                            if var.type in ("ins", "del"):
                                fout.write(
                                    f"{chrom} {pos + var.offset - 1} {var.str}\n")
                                n += 1
            vcf.close()
    fa.close()
    return n


def _empty_buffer(index, buffer, calls, out, bamfiles):
    """makeGenotypeLikelihoodFilePooled.emptyBuffer (:49-107)."""
    num_bams = len(bamfiles)
    glfs = buffer[index]
    dat = glfs[0]
    if dat["nref_all"] == "NA":
        del buffer[index]
        return "na-error"
    varstring = (dat["tid"], dat["realigned_position"], dat["nref_all"])
    try:
        calls[dat["tid"]][int(dat["realigned_position"])][dat["nref_all"]]
    except KeyError:
        del buffer[index]
        return "notcalled"
    if len(glfs) != num_bams:
        sys.stderr.write(f"Skipping index {index}\n")
        del buffer[index]
        return "skipped"
    output = []
    for dat in glfs:
        tvs = (dat["tid"], dat["realigned_position"], dat["nref_all"])
        if tvs != varstring:
            return "skipped-inconsistent-glf-lines"
        idx = int(dat["indidx"])
        gen_to_lik = {}
        for lik in dat["glf"].split(";"):
            ld = lik.split(":")
            gen_to_lik[ld[0]] = ld[1]
        output.append(
            f"{dat['tid']} {int(dat['realigned_position'])} {dat['nref_all']} "
            f"{gen_to_lik['0/0']} {gen_to_lik['0/1']} {gen_to_lik['1/1']} "
            f"{bamfiles[idx]}\n")
    for line in output:
        out.write(line)
    del buffer[index]
    return "a-ok"


def get_calls(call_file: str) -> Dict[str, Dict[int, Dict[str, dict]]]:
    """makeGenotypeLikelihoodFilePooled.getCalls (:10-46)."""
    calls: Dict[str, Dict[int, Dict[str, dict]]] = {}
    with open(call_file) as f:
        header = None
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#"):
                header = line[1:].rstrip("\n").split("\t")
                continue
            toks = line.rstrip("\n").split("\t")
            dat = dict(zip(header, toks))
            if dat["FILTER"] == "PASS" or (dat["FILTER"] == "q20"
                                           and float(dat["QUAL"]) >= 10):
                chrom = dat["CHROM"]
                pos = int(dat["POS"])
                if "," in dat["ALT"]:
                    raise ValueError("Cannot deal with these entries")
                var = Variant4(ref=dat["REF"], alt=dat["ALT"])
                newpos = pos + var.offset - 1
                calls.setdefault(chrom, {}).setdefault(newpos, {})
                if var.str in calls[chrom][newpos]:
                    raise ValueError("Multiple same variants?")
                calls[chrom][newpos][var.str] = dat
    return calls


def make_genotype_likelihood_file(glf_files: List[str], output_file: str,
                                  call_file: str, bam_files: List[str]) -> int:
    """makeGenotypeLikelihoodFilePooled.makeGLF (:146-213)."""
    calls = get_calls(call_file)
    num_written = 0
    with open(output_file, "w") as fout:
        for glffile in glf_files:
            buffer: Dict[str, List[dict]] = {}
            curr_index = "-1"
            for dat in GLFReader(glffile):
                newindex = f"{dat['index']}.{dat['realigned_position']}.{dat['nref_all']}"
                buffer.setdefault(newindex, []).append(dat)
                if newindex != curr_index:
                    if curr_index != "-1" and curr_index in buffer:
                        if _empty_buffer(curr_index, buffer, calls, fout,
                                         bam_files) == "a-ok":
                            num_written += 1
                    curr_index = newindex
            if curr_index in buffer:
                if _empty_buffer(curr_index, buffer, calls, fout,
                                 bam_files) == "a-ok":
                    num_written += 1
    return num_written
