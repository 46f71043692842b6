"""Per-window realignment engine: haplotype generation, read-vs-haplotype
likelihoods, and dispatch to the diploid/pooled callers.

Ports DetInDel::detectIndels (DInDel.cpp:1265-1422),
empiricalDistributionMethod (:380-640), getHaplotypes (:1526-1645),
alignHaplotypes (:1427-1524) and computeLikelihoods (:1707-1739).

The pair-HMM backend is pluggable: 'oracle' (NumPy float64 reference
implementation), or 'jax' (float64, exact ties) and 'pallas' (float32,
fast ties), which run each window's pairs through the DP kernel on the
engine's torch device (hmm/batch.py).  With --faster the sparse
k-mer-seeded HMM (hmm/faster.py) runs on the host instead."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

from ..config import Parameters
from ..device import resolve_device
from ..model import Haplotype, LibraryCollection, MLAlignment, Read, HPOS_LO, HPOS_RO
from ..out.glf import OutputData, make_glf_output
from ..variants import AlignedCandidates, read_window_file
from ..io.fasta import FastaFile
from ..io.bam_native import open_bam
from ..align.nw import align_haplotype_to_ref
from ..hmm.batch import BACKENDS, BatchedPairHMM
from ..hmm.faster import compute_likelihoods_faster
from ..hmm.reference import pair_hmm_single
from ..infer.filterhaps import filter_haplotypes
from ..infer.diploid import diploid_glf, _WindowThrow
from ..infer.pooled import estimate_hap_freqs_bayes_em
from .hapgen import HapGenError, HaplotypeDistribution, HDIterator
from .reads import ReadBuffer, WindowError, get_reads
from .stats import RunStats


def _logadd(a: float, b: float) -> float:
    from ..utils import add_logs
    return add_logs(a, b)


def _show_reads(reads: List[Read]) -> None:
    """--showReads (DInDel.cpp:1250-1254; Read operator<< Read.hpp:408)."""
    for r, read in enumerate(reads):
        quals = " ".join(repr(float(q)) for q in read.qual)
        print(f"read[{r}]: pos: {read.pos} 1-mapping quality: "
              f"{1.0 - read.map_qual} {read.seq} {quals}")


def _show_cand_haps(haps: List[Haplotype]) -> None:
    """--showCandHap (DInDel.cpp:1629-1632)."""
    for i, h in enumerate(haps):
        vs = ";".join(v.str for v in list(h.indels.values())
                      + list(h.snps.values()))
        print(f"POSTFILTER hdi[{i}]:{h.seq} {vs}")


def _show_alignments_per_haplotype(haps: List[Haplotype], reads: List[Read],
                                   liks, offset: int = 50) -> None:
    """--showHapAlignments (showAlignmentsPerHaplotype,
    DInDel.cpp:234-263): assign each read to its max-likelihood haplotype
    and print the reads aligned under each haplotype."""
    max_hap = [set() for _ in haps]
    for r in range(len(reads)):
        idx, ml = 0, -math.inf
        for h in range(len(haps)):
            if liks[h][r].ll > ml:
                ml = liks[h][r].ll
                idx = h
        max_hap[idx].add(r)
    print("ALIGNMENTS")
    for h, hap in enumerate(haps):
        print("*******************************************")
        print(f"\nHAPLOTYPE {h}\n")
        print(" " * offset + hap.seq)
        for r in sorted(max_hap[h]):
            ml = liks[h][r]
            first = next((hp for hp in ml.hpos if hp >= 0), 0)
            rel = first - next((b for b, hp in enumerate(ml.hpos)
                                if hp >= 0), 0)
            pad = max(0, offset + rel)
            print(" " * pad + reads[r].seq
                  + f"  ll={ml.ll:.4f}")


def check_guards_and_on_hap(liks, nh: int, nr: int):
    """Positive-loglik abort + NaN guard + on_hap flags over the liks
    matrix (DInDel.cpp:1717-1735), array-level for LiksView so the guards
    do not force per-pair materialization."""
    from ..hmm.liks import LiksStats, LiksView
    if isinstance(liks, (LiksView, LiksStats)):
        import numpy as np
        ll = liks.ll2d
        bad = (ll > 0.1) | ~np.isfinite(ll)
        if bad.any():
            # first offending pair in the reference's h-major scan order
            h, r = divmod(int(np.argmax(bad.ravel())), nr)
            if ll[h, r] > 0.1:
                raise RuntimeError("Likelihood>0")
            raise WindowError("Nan detected")
        return (~liks.off_hap_hmq2d).any(axis=0).astype(int).tolist()
    on_hap = [0] * nr
    for h in range(nh):
        for r in range(nr):
            ml = liks[h][r]
            if not ml.off_hap_hmq:
                on_hap[r] = 1
            if ml.ll > 0.1:
                raise RuntimeError("Likelihood>0")
            if math.isnan(ml.ll) or math.isinf(ml.ll):
                raise WindowError("Nan detected")
    return on_hap


def _safe_cigar(hap, read, ml, ref_seq_pos):
    from .realign_bam import CigarError, get_cigar
    try:
        return get_cigar(hap, read, ml, ref_seq_pos)
    except CigarError:
        return None


def with_next(windows):
    """(window line, get_reads' next_window for the line after it, or
    None at the last) for each line: the window loops tell get_reads the
    next window, whose read intake it starts ahead."""
    it = iter(windows)
    cur = next(it, None)
    while cur is not None:
        nxt = next(it, None)
        yield cur, (None if nxt is None
                    else (nxt.tid, nxt.left_pos, nxt.right_pos))
        cur = nxt


class WindowEngine:
    def __init__(self, bam_paths: List[str], fasta_path: str,
                 params: Parameters, libraries: Optional[LibraryCollection] = None,
                 hmm_backend: str = "jax", device="cuda"):
        self.bams = [open_bam(p) for p in bam_paths]
        # captured once so the batched engine's finish worker never
        # touches the live reader objects while the main thread fetches
        self.bam_header = self.bams[0].header
        self.fasta = FastaFile(fasta_path)
        self.params = params
        self.libraries = libraries if libraries is not None else LibraryCollection()
        self.buf = ReadBuffer()
        self.stats = RunStats()
        self.hmm_backend = hmm_backend
        self._batch_hmm = None
        # the oracle backend runs on the host and needs no device
        self.device = None
        if hmm_backend in BACKENDS:
            self.device = resolve_device(device)
            dtype, exact_ties = BACKENDS[hmm_backend]
            self._batch_hmm = BatchedPairHMM(
                params.obs_params, dtype, exact_ties=exact_ties,
                device=self.device)

    # ------------------------------------------------------------------
    def get_ref_seq(self, lpos: int, rpos: int) -> str:
        """DetInDel::getRefSeq (DInDel.cpp:269-287): 1-based inclusive."""
        return self.fasta.get_sequence(self.params.tid, lpos, rpos)

    # ------------------------------------------------------------------
    def align_haplotypes(self, haps: List[Haplotype], pos: int, left_pos: int,
                         right_pos: int) -> Tuple[List[Haplotype], Dict[int, List]]:
        """DetInDel::alignHaplotypes (DInDel.cpp:1427-1524)."""
        variants: Dict[int, List] = {}
        ref_seq = self.get_ref_seq(left_pos + 1, right_pos + 1)
        kept: List[Haplotype] = []
        for hap in haps:
            ml = align_haplotype_to_ref(ref_seq, hap.seq)
            hap.indels = dict(ml.indels)
            hap.snps = dict(ml.snps)
            hap.align = ml.align
            hap.ml = ml
            has_start_end_indel = False
            if ml.hpos and ml.hpos[0] == HPOS_LO:
                has_start_end_indel = True
            if len(ml.hpos) > 1 and ml.hpos[-1] == HPOS_RO:
                has_start_end_indel = True
            for p, av in hap.indels.items():
                variants.setdefault(p, [])
                if not any(v.str == av.str for v in variants[p]):
                    variants[p].append(av)
            for p, av in hap.snps.items():
                variants.setdefault(p, [])
                if not any(v.str == av.str for v in variants[p]):
                    variants[p].append(av)
            if not has_start_end_indel:
                kept.append(hap)
        for p in variants:
            for hap in kept:
                hap.add_ref_variant(p)
        return kept, variants

    # ------------------------------------------------------------------
    def get_haplotypes(self, reads: List[Read], pos: int, left_pos: int,
                       right_pos: int, candidates: AlignedCandidates
                       ) -> Tuple[bool, List[Haplotype], int, int]:
        """DetInDel::getHaplotypes (DInDel.cpp:1526-1645).
        Returns (skip, haps, new_left_pos, new_right_pos)."""
        p = self.params
        rs = left_pos - p.min_read_overlap if left_pos > p.min_read_overlap else 0
        re = right_pos + p.min_read_overlap
        ref_seq = self.get_ref_seq(rs + 1, re + 1)

        # the whole span below mirrors the reference's per-window
        # catch(string) (DInDel.cpp:1369-1374): any HapGenError — including
        # ones thrown from insertRead, e.g. "Mag niet." — becomes an
        # error_* GLF row for this window, not a run abort
        try:
            from .hapgen_native import make_hapdist
            with self.stats.stage("hapgen.hapdist"):
                hd = make_hapdist(pos, ref_seq, rs)
                if hasattr(hd, "insert_reads"):
                    hd.insert_reads([r.bam for r in reads])
                else:
                    for r in reads:
                        hd.insert_read(r.bam)
                hd.set_frequencies()

            with self.stats.stage("hapgen.generate"):
                hdi = HDIterator(hd, p.max_hap, pos, left_pos, right_pos,
                                 p.no_indel_window)
                if hdi.get_log_num_haps() > math.log(p.skip_max_hap):
                    return True, [], left_pos, right_pos
                if p.show_hap_dist:
                    # --showEmpirical (DInDel.cpp:1586-1589)
                    print("\nEmpirical distribution: ")
                    print(hdi)
                haps = hdi.generate_haps_with_aligned_variants(
                    candidates, p.change_ins_to_n)
            self.stats.count("hapgen.haps_generated", len(haps))
            if len(haps) > p.skip_max_hap or len(haps) * len(reads) > p.max_hap_read_prod:
                # the late skip returns with haps FILLED
                # (DInDel.cpp:1582-1585), so the caller's
                # maxHapReadProd check still fires and emits the
                # skipped_numhap_times_numread error row
                # (DInDel.cpp:395-399) — only the early logNumHaps skip
                # leaves haps empty
                return True, haps, left_pos, right_pos
            left_pos = hdi.start()
            right_pos = hdi.end()
            with self.stats.stage("hapgen.align"):
                haps, _variants = self.align_haplotypes(haps, pos, left_pos,
                                                        right_pos)
                # remove duplicate reference-haplotypes
                # (DInDel.cpp:1600-1616)
                tmp: List[Haplotype] = []
                found_ref = False
                for hap in haps:
                    if hap.count_indels() == 0 and hap.count_snps() == 0:
                        if not found_ref:
                            tmp.append(hap)
                            found_ref = True
                    else:
                        tmp.append(hap)
                haps = tmp
            self.stats.count("hapgen.haps_kept", len(haps))
            if p.show_cand_hap:
                _show_cand_haps(haps)
        except HapGenError as e:
            if str(e) == "Blocks are not consecutive.":
                raise WindowError("hapblock")
            raise WindowError(str(e))
        return False, haps, left_pos, right_pos

    # ------------------------------------------------------------------
    def compute_likelihoods(self, haps: List[Haplotype], reads: List[Read],
                            left_pos: int) -> Tuple[List[List[MLAlignment]], List[int]]:
        """DetInDel::computeLikelihoods (DInDel.cpp:1707-1739): liks[h][r].

        With --faster (params.slower False) this is
        computeLikelihoodsFaster (DInDel.cpp:1793-1833): the sparse
        k-mer-seeded HMM, no positive-ll/NaN guards, every read counted
        on-hap."""
        with self.stats.stage("window_hmm"):
            if not self.params.slower:
                return compute_likelihoods_faster(haps, reads, left_pos,
                                                  self.params.obs_params)
            if self._batch_hmm is not None:
                liks = self._batch_hmm.compute(haps, reads, left_pos)
            else:
                liks = [[pair_hmm_single(hap, r, left_pos,
                                         self.params.obs_params)
                         for r in reads] for hap in haps]
        on_hap = check_guards_and_on_hap(liks, len(haps), len(reads))
        return liks, on_hap

    # ------------------------------------------------------------------
    def empirical_distribution_method(self, index: int, reads: List[Read],
                                      pos: int, left_pos: int, right_pos: int,
                                      candidates: AlignedCandidates,
                                      glf_data: Optional[OutputData]) -> List[dict]:
        """DetInDel::empiricalDistributionMethod (DInDel.cpp:380-640)."""
        p = self.params
        with self.stats.stage("hapgen"):
            skip, haps, left_pos, right_pos = self.get_haplotypes(
                reads, pos, left_pos, right_pos, candidates)
        if len(reads) * len(haps) > p.max_hap_read_prod:
            raise WindowError(f"skipped_numhap_times_numread>{p.max_hap_read_prod}")
        rows: List[dict] = []
        if skip:
            return rows

        self.stats.pairs_scored += len(haps) * len(reads)
        if p.estimate_hap_freqs:  # --doPooled
            liks, on_hap = self.compute_likelihoods(haps, reads, left_pos)
            filtered, var_coverage = filter_haplotypes(
                haps, reads, liks, p, p.filter_haplotypes)
            _freqs, _post, emrows = estimate_hap_freqs_bayes_em(
                haps, reads, liks, pos, left_pos, right_pos, glf_data, index,
                candidates, p, filtered, var_coverage, len(self.bams),
                p.bayes_type)
            rows.extend(emrows)
        if p.do_diploid:
            liks, on_hap = self.compute_likelihoods(haps, reads, left_pos)
            if p.show_hap_alignments:
                _show_alignments_per_haplotype(haps, reads, liks)
            filtered, var_coverage = filter_haplotypes(
                haps, reads, liks, p, p.filter_haplotypes)
            try:
                rows.extend(diploid_glf(haps, reads, liks, pos, left_pos,
                                        right_pos, glf_data, index, candidates,
                                        p, filtered, var_coverage, "dip"))
            except _WindowThrow as e:
                raise WindowError(str(e))
            if p.output_realigned_bam and p.slower:
                self._write_realigned_bam(index, haps, reads, liks, on_hap,
                                          left_pos, right_pos, candidates,
                                          diploid=True)
        if p.estimate_hap_freqs and p.output_realigned_bam and p.slower:
            liks, on_hap = self.compute_likelihoods(haps, reads, left_pos)
            self._write_realigned_bam(index, haps, reads, liks, on_hap,
                                      left_pos, right_pos, candidates,
                                      diploid=False)
        return rows

    # ------------------------------------------------------------------
    def _write_realigned_bam(self, index, haps, reads, liks, on_hap,
                             left_pos, right_pos, candidates, diploid,
                             params=None):
        """Realigned-BAM output (DInDel.cpp:498-534, 589-633): MAP
        haplotype per read -> composed CIGAR -> per-window BAM (+ optional
        post-process hook)."""
        import math as _math
        import subprocess
        from .realign_bam import get_cigar, write_realigned_bam
        from ..infer.diploid import get_haplotype_prior
        p = self.params if params is None else params
        nh = len(haps)
        nr = len(reads)
        ref_seq_pos = left_pos
        cigars = [None] * nr
        if diploid:
            # MAP pair with priors (computePairLikelihoods + getMaxHap)
            best = None
            for h1 in range(nh):
                for h2 in range(h1, nh):
                    ll = get_haplotype_prior(haps[h1], haps[h2], left_pos,
                                             candidates, p)
                    for r in range(nr):
                        ll += _math.log(0.5) + _logadd(liks[h1][r].ll,
                                                      liks[h2][r].ll)
                    if best is None or ll > best[0]:
                        best = (ll, h1, h2)
            _, hp1, hp2 = best
            for r in range(nr):
                if abs(liks[hp1][r].ll - liks[hp2][r].ll) < 1e-8:
                    hmax = hp1 if haps[hp1].count_indels() < haps[hp2].count_indels() else hp2
                else:
                    hmax = hp1 if liks[hp1][r].ll > liks[hp2][r].ll else hp2
                cigars[r] = _safe_cigar(haps[hmax], reads[r], liks[hmax][r],
                                        ref_seq_pos)
        else:
            for r in range(nr):
                if on_hap[r]:
                    llmax = None
                    hidx = 0
                    for h in range(nh):
                        if llmax is None or liks[h][r].ll > llmax:
                            llmax = liks[h][r].ll
                            hidx = h
                    cigars[r] = _safe_cigar(haps[hidx], reads[r],
                                            liks[hidx][r], ref_seq_pos)
        left_ok = left_pos + p.min_read_overlap
        right_ok = right_pos - p.min_read_overlap
        name = (f"{p.file_name}.ra.{index}_{p.tid}_{left_ok}_{right_ok}.bam")
        write_realigned_bam(name, cigars, reads, on_hap,
                            self.bam_header)
        if p.process_realigned_bam != "no":
            cmd = [p.process_realigned_bam, name,
                   p.file_name + "_realigned", p.tid,
                   str(left_ok), str(right_ok)]
            subprocess.run(cmd, check=False)

    # ------------------------------------------------------------------
    def detect_indels(self, var_file: str, glf_path: Optional[str] = None):
        """DetInDel::detectIndels (DInDel.cpp:1265-1422): loop over window
        lines with per-window fault isolation (error_* rows)."""
        p = self.params
        if glf_path is None:
            glf_path = p.file_name + ".glf.txt"
        out = open(glf_path, "w")
        glf_data = make_glf_output(out)
        glf_data.write_header()

        index = 0
        old_tid = "-1"
        self.buf = ReadBuffer()
        self.buf.reset = True
        all_rows = []
        try:
            for candidates, nxt in with_next(
                    read_window_file(var_file, p.var_file_is_one_based)):
                index += 1
                left_pos = candidates.left_pos
                right_pos = candidates.right_pos
                pos = candidates.center_pos
                p.tid = candidates.tid
                if p.tid != old_tid:
                    self.buf.reset = True
                    old_tid = p.tid
                    self.buf.old_left_pos = 0
                if left_pos < self.buf.old_left_pos:
                    raise RuntimeError(
                        "Candidate variant files must be sorted on left "
                        "position of window!")
                message = "ok"
                skipped = False
                self.stats.windows_total += 1
                try:
                    with self.stats.stage("get_reads"):
                        reads = get_reads(
                            self.bams, p.tid, left_pos, right_pos, p,
                            self.libraries, self.buf, stats=self.stats,
                            next_window=nxt)
                    self.buf.reset = False
                    if p.show_reads:
                        _show_reads(reads)
                    # the reference dispatches on inferenceMethod and
                    # silently does NOTHING for any value other than
                    # "empirical" (DInDel.cpp:1365) — mirrored here, quirk
                    # and all
                    rows = []
                    if p.inference_method == "empirical":
                        rows = self.empirical_distribution_method(
                            index, reads, pos, left_pos, right_pos,
                            candidates, glf_data)
                    all_rows.extend(rows)
                    self.stats.windows_ok += 1
                    self.stats.reads_processed += len(reads)
                except WindowError as e:
                    message = "error_" + str(e).replace(" ", "_")
                    self.stats.record_error(message)
                    skipped = True
                except MemoryError:
                    message = "error_bad_alloc"
                    self.stats.record_error(message)
                    skipped = True
                if skipped:
                    line = glf_data.line()
                    line.set("msg", message)
                    line.set("index", index)
                    line.set("tid", p.tid)
                    line.set("lpos", left_pos)
                    line.set("rpos", right_pos)
                    glf_data.output(line)
                    self.buf.reset = True
                else:
                    self.buf.reset = False
                self.buf.old_left_pos = left_pos
        finally:
            self.buf.close()
            out.close()
        return all_rows

    def close(self):
        self.buf.close()
        for b in self.bams:
            b.close()
        self.fasta.close()
