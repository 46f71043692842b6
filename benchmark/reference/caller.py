"""The plain reference of `--analysis indels --doDiploid`: the GLF rows of
chosen windows of a window file, worked out from the FASTA, the BAMs and
the window lines alone (the reads of every BAM, as one individual's).

Each window goes through the read-at-a-time read fetch (reads.py, a
fresh read buffer per window), the pure-Python haplotype generation
(hapgen.py) and Gotoh alignment (nw.py), the pair-HMM of oracle.py
vectorised over all pairs of all chosen windows (pairhmm.py), the
per-pair haplotype filter and the diploid caller (filterhaps.py,
diploid.py), and the GLF writer (glf.py): DetInDel::detectIndels and
empiricalDistributionMethod for the diploid caller, as the streaming
engine runs them."""

from __future__ import annotations

import io
import math
from typing import Dict, List

import torch

from .bam import BamReader
from .config import Parameters
from .diploid import _WindowThrow, diploid_glf
from .fasta import FastaFile
from .filterhaps import filter_haplotypes
from .glf import make_glf_output
from .hapgen import HapGenError, HaplotypeDistribution, HDIterator
from .model import HPOS_LO, HPOS_RO, LibraryCollection
from .nw import align_haplotype_to_ref
from .pairhmm import score_pairs
from .reads import ReadBuffer, WindowError, get_reads
from .variants import parse_window_line


def diploid_params(flags: Dict[str, object]) -> Parameters:
    """Parameters of `--analysis indels --doDiploid` with the CLI's
    defaults, then `flags` (Parameters field -> value)."""
    p = Parameters()
    p.quiet = False
    p.do_diploid = True
    for k, v in flags.items():
        if not hasattr(p, k):
            raise KeyError(f"no Dindel parameter {k!r}")
        setattr(p, k, v)
    return p


def _haplotypes(fasta, p, reads, pos, left_pos, right_pos, candidates):
    """DetInDel::getHaplotypes and alignHaplotypes (DInDel.cpp:1427-1645):
    (skip, haps, left_pos, right_pos)."""
    rs = left_pos - p.min_read_overlap if left_pos > p.min_read_overlap else 0
    re_ = right_pos + p.min_read_overlap
    ref_seq = fasta.get_sequence(p.tid, rs + 1, re_ + 1)
    try:
        hd = HaplotypeDistribution(pos, ref_seq, rs)
        for r in reads:
            hd.insert_read(r.bam)
        hd.set_frequencies()
        hdi = HDIterator(hd, p.max_hap, pos, left_pos, right_pos,
                         p.no_indel_window)
        if hdi.get_log_num_haps() > math.log(p.skip_max_hap):
            return True, [], left_pos, right_pos
        haps = hdi.generate_haps_with_aligned_variants(candidates,
                                                       p.change_ins_to_n)
        if (len(haps) > p.skip_max_hap
                or len(haps) * len(reads) > p.max_hap_read_prod):
            return True, haps, left_pos, right_pos
        left_pos, right_pos = hdi.start(), hdi.end()
        wref = fasta.get_sequence(p.tid, left_pos + 1, right_pos + 1)
        variants: Dict[int, list] = {}
        kept = []
        for hap in haps:
            ml = align_haplotype_to_ref(wref, hap.seq)
            hap.indels, hap.snps = dict(ml.indels), dict(ml.snps)
            hap.align, hap.ml = ml.align, ml
            edge = bool(ml.hpos) and (ml.hpos[0] == HPOS_LO or (
                len(ml.hpos) > 1 and ml.hpos[-1] == HPOS_RO))
            for d in (hap.indels, hap.snps):
                for q, av in d.items():
                    vs = variants.setdefault(q, [])
                    if not any(v.str == av.str for v in vs):
                        vs.append(av)
            if not edge:
                kept.append(hap)
        for q in variants:
            for hap in kept:
                hap.add_ref_variant(q)
        out, found_ref = [], False
        for hap in kept:
            if hap.count_indels() == 0 and hap.count_snps() == 0:
                if not found_ref:
                    out.append(hap)
                    found_ref = True
            else:
                out.append(hap)
    except HapGenError as e:
        if str(e) == "Blocks are not consecutive.":
            raise WindowError("hapblock")
        raise WindowError(str(e))
    return False, out, left_pos, right_pos


def glf_rows(fasta_path: str, bam_paths: List[str],
             window_lines: Dict[int, str], flags: Dict[str, object],
             device="cpu", dtype=torch.float64) -> Dict[int, List[str]]:
    """{window index: its GLF lines} for the given {index: window line}
    (1-based indices, as the program numbers them), with the CLI's
    defaults and `flags` (diploid_params).  A "dip" line whose counts
    reads tied between two haplotypes could move ends in a note
    ` #tied:<count>=<lo>-<hi>;...` (diploid.TIE; check.split_note)."""
    bams = [BamReader(b) for b in bam_paths]
    fasta = FastaFile(fasta_path)
    libs = LibraryCollection()
    p = diploid_params(flags)
    staged = []
    try:
        for index in sorted(window_lines):
            cand = parse_window_line(window_lines[index],
                                     p.var_file_is_one_based)
            p.tid = cand.tid
            w = dict(index=index, tid=cand.tid, cand=cand,
                     lpos=cand.left_pos, rpos=cand.right_pos, error=None)
            buf = ReadBuffer()
            buf.reset = True
            try:
                reads = get_reads(bams, p.tid, cand.left_pos, cand.right_pos,
                                  p, libs, buf)
                skip, haps, lp, rp = _haplotypes(
                    fasta, p, reads, cand.center_pos, cand.left_pos,
                    cand.right_pos, cand)
                if len(reads) * len(haps) > p.max_hap_read_prod:
                    raise WindowError(
                        f"skipped_numhap_times_numread>{p.max_hap_read_prod}")
                w.update(reads=reads, haps=[] if skip else haps, lp=lp,
                         rp=rp)
            except WindowError as e:
                w["error"] = "error_" + str(e).replace(" ", "_")
            staged.append(w)
    finally:
        for b in bams:
            b.close()
    pairs = [(h, r, w["lp"]) for w in staged if w["error"] is None
             for h in w["haps"] for r in w["reads"]]
    mls = iter(score_pairs(pairs, p.obs_params, device, dtype))
    out: Dict[int, List[str]] = {}
    try:
        for w in staged:
            buf = io.StringIO()
            glf = make_glf_output(buf)
            p.tid = w["tid"]
            if w["error"] is None and w["haps"]:
                haps, reads = w["haps"], w["reads"]
                liks = [[next(mls) for _ in reads] for _ in haps]
                try:
                    _guards(liks)
                    filt, cov = filter_haplotypes(haps, reads, liks, p,
                                                  p.filter_haplotypes)
                    diploid_glf(haps, reads, liks, w["cand"].center_pos,
                                w["lp"], w["rp"], glf, w["index"], w["cand"],
                                p, filt, cov, "dip")
                except (_WindowThrow, WindowError) as e:
                    # rows written before the throw stay, as in the engines
                    w["error"] = "error_" + str(e).replace(" ", "_")
            if w["error"] is not None:
                line = glf.line()
                line.set("msg", w["error"])
                line.set("index", w["index"])
                line.set("tid", w["tid"])
                line.set("lpos", w["lpos"])
                line.set("rpos", w["rpos"])
                glf.output(line)
            out[w["index"]] = buf.getvalue().splitlines()
    finally:
        fasta.close()
    return out


def _guards(liks) -> None:
    """The positive log-likelihood abort and the NaN guard of
    computeLikelihoods (DInDel.cpp:1717-1735), in its h-major order."""
    for row in liks:
        for ml in row:
            if ml.ll > 0.1:
                raise RuntimeError("Likelihood>0")
            if math.isnan(ml.ll) or math.isinf(ml.ll):
                raise WindowError("Nan detected")
