"""Candidate-haplotype generation from the empirical read-alignment
distribution, a behavioral port of HaplotypeDistribution/HapBlock/HDIterator2
(HaplotypeDistribution.cpp:29-486, HaplotypeDistribution.hpp:82-496,
HapBlock.{hpp,cpp}).

The window reference is laid down in 4bp Ref blocks; every read CIGAR
inserts its per-op subsequences, splitting blocks on the fly; deletions are
coded as a single char chr(35+len); candidate variants are injected
combinatorially into the enumerated block cross-product."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .model import Haplotype
from .variants import AlignedCandidates, DEL, INS, SNP

# haplotype type bits (Haplotype.hpp:47-50)
T_REF = 1
T_NORMAL = 2
T_IN = 4
T_DEL = 8

B_NORMAL = 0
B_INSERT = 1


class HapGenError(Exception):
    """Raised where the reference throws a string; message preserved so the
    window engine can emit the same error_* GLF row."""


@dataclass
class BlockHap:
    """A haplotype within a block: key identity is seq only (Haplotype
    operator< compares seq, HapBlock keys on it)."""
    seq: str
    type: int = T_NORMAL
    count: int = 0
    freq: float = 0.0


class HapBlock:
    def __init__(self, seq: str, typ: int, start: int, length: Optional[int] = None):
        self.pos0 = start
        self.pos1 = start + (len(seq) if length is None else length) - 1
        self.type = B_NORMAL
        self.haps: Dict[str, BlockHap] = {}
        self.insert_hap(seq, typ)

    @classmethod
    def sub_block(cls, hb: "HapBlock", start: int, length: int) -> "HapBlock":
        """HapBlock::HapBlock(const HapBlock&, start, len) — substring copy
        with count merging (HapBlock.cpp:20-46)."""
        self = cls.__new__(cls)
        self.pos0 = start
        self.pos1 = start + length - 1
        self.type = B_NORMAL
        self.haps = {}
        off = start - hb.pos0
        for h in hb.haps.values():
            sub = h.seq[off:off + length]
            ex = self.haps.get(sub)
            if ex is None:
                self.haps[sub] = BlockHap(sub, h.type, h.count)
            else:
                if h.type & T_REF:
                    ex.type = T_REF
                ex.count += h.count
        return self

    def insert_hap(self, seq: str, typ: int) -> None:
        """HapBlock::insert (HapBlock.cpp:48-57)."""
        ex = self.haps.get(seq)
        if ex is None:
            self.haps[seq] = BlockHap(seq, typ, 1)
        else:
            if typ & T_REF:
                ex.type = T_REF
            ex.count += 1

    def start(self) -> int:
        return self.pos0

    def end(self) -> int:
        return self.pos1

    def length(self) -> int:
        return self.pos1 - self.pos0 + 1

    def size(self) -> int:
        return len(self.haps)

    def set_frequencies(self) -> None:
        s = sum(h.count for h in self.haps.values())
        for h in self.haps.values():
            h.freq = h.count / s

    def sorted_haps(self) -> List[BlockHap]:
        return [self.haps[k] for k in sorted(self.haps)]


class HaplotypeDistribution:
    """Block partition of the window with per-block haplotype counts
    (HaplotypeDistribution.cpp:29-486)."""

    def __init__(self, mid_pos: int, ref_seq: str, ref_seq_start: int):
        self.mid_pos = mid_pos
        self.blocks: List[HapBlock] = []
        self._starts: List[int] = []  # parallel pos0 list for plain bisect
        self.insertions: Dict[int, HapBlock] = {}
        bs = 4
        nchunks = len(ref_seq) // bs + (0 if len(ref_seq) % bs == 0 else 1)
        for x in range(nchunks):
            start = ref_seq_start + x * bs
            self._insert_seq(ref_seq[x * bs:(x + 1) * bs], T_REF, start)

    # --- block algebra ---

    def _new_block(self, hb: HapBlock) -> None:
        # blocks stay position-sorted; insertion at the bisect point is
        # equivalent to append + stable sort by start (an equal-start
        # newcomer lands after the incumbent either way)
        import bisect
        i = bisect.bisect_right(self._starts, hb.pos0)
        self.blocks.insert(i, hb)
        self._starts.insert(i, hb.pos0)

    def _del_block(self, idx: int) -> None:
        del self.blocks[idx]
        del self._starts[idx]

    def _first_overlapping(self, seq_start: int, seq_end: int) -> int:
        # blocks are position-sorted and non-overlapping (the reference's
        # invariant, HaplotypeDistribution.cpp:218-250), so the first
        # overlap bisects instead of scanning — this is the hottest
        # host-side call (one per read chunk); equivalence to the linear
        # scan is asserted in tests/test_engine_misc.py
        import bisect
        blocks = self.blocks
        i = bisect.bisect_right(self._starts, seq_start) - 1
        if i >= 0 and blocks[i].pos1 >= seq_start:
            return i
        i += 1
        if i < len(blocks) and blocks[i].pos0 <= seq_end:
            return i
        return -1

    def _split_block(self, idx: int, seq: str, typ: int, seq_start: int) -> None:
        """HaplotypeDistribution::splitBlock (HaplotypeDistribution.cpp:288-330)."""
        if len(seq) == 0:
            raise HapGenError("Empty haplotype!")
        seq_end = seq_start + len(seq) - 1
        block = self.blocks[idx]
        if seq_start < block.pos0 or seq_end > block.pos1:
            raise HapGenError("seq outside of block boundaries")
        len_a = seq_start - block.pos0
        len_b = len(seq)
        len_c = 0 if block.pos1 == seq_end else block.pos1 - seq_end
        hb_a = HapBlock.sub_block(block, block.pos0, len_a) if len_a else None
        hb_b = HapBlock.sub_block(block, block.pos0 + len_a, len_b)
        hb_c = HapBlock.sub_block(block, hb_b.pos1 + 1, len_c) if len_c else None
        self._del_block(idx)
        self._new_block(hb_b)
        if len(seq) != hb_b.length() or seq_start != hb_b.start():
            raise HapGenError("updateBlock-seq mismatch.")
        hb_b.insert_hap(seq, typ)
        if hb_a is not None:
            self._new_block(hb_a)
        if hb_c is not None:
            self._new_block(hb_c)

    def _insert_seq(self, seq: str, typ: int, seq_start: int) -> None:
        """HaplotypeDistribution::insertSeq (HaplotypeDistribution.cpp:343-436)."""
        if typ in (T_NORMAL, T_REF, T_DEL):
            seq_end = seq_start + len(seq) - 1
            idx = self._first_overlapping(seq_start, seq_end)
            if idx != -1:
                block = self.blocks[idx]
                if block.pos0 < seq_start:
                    if seq_end > block.pos1:
                        # block **********   seq        ********
                        overlap = block.pos1 - seq_start + 1
                        self._split_block(idx, seq[:overlap], typ, seq_start)
                        self._insert_seq(seq[overlap:], typ, seq_start + overlap)
                    else:
                        # block *************  seq   *****
                        self._split_block(idx, seq, typ, seq_start)
                else:
                    if block.pos1 > seq_end:
                        # block    ***********  seq *******
                        overlap = seq_end - block.pos0 + 1
                        self._split_block(idx, seq[len(seq) - overlap:], typ, block.pos0)
                        if overlap < len(seq):
                            self._new_block(HapBlock(seq[:len(seq) - overlap], typ, seq_start))
                    else:
                        # block    ***** ***   seq ******************
                        len_a = block.pos0 - seq_start
                        len_b = block.pos1 - block.pos0 + 1
                        len_c = seq_end - block.pos1
                        if len_a:
                            self._new_block(HapBlock(seq[:len_a], typ, seq_start))
                        if len(seq[len_a:len_a + len_b]) != block.length():
                            raise HapGenError("updateBlock-seq mismatch.")
                        block.insert_hap(seq[len_a:len_a + len_b], typ)
                        if len_c:
                            self._insert_seq(seq[len_a + len_b:], typ,
                                             seq_start + len_a + len_b)
            else:
                self._new_block(HapBlock(seq, typ, seq_start))
        elif typ == T_IN:
            hb = self.insertions.get(seq_start)
            if hb is None:
                hb = HapBlock(seq, T_IN, seq_start)
                hb.type = B_INSERT
                hb.insert_hap("", T_REF)  # no-insertion haplotype
                self.insertions[seq_start] = hb
            else:
                hb.insert_hap(seq, T_IN)
        else:
            raise HapGenError("Cannot handle this case.")

    # --- read ingestion (HaplotypeDistribution::insertRead,
    #     HaplotypeDistribution.cpp:74-164) ---

    def insert_read(self, rec) -> None:
        """rec is a BamRecord (io.bam)."""
        from .bam import FMUNMAP
        if rec.flag & FMUNMAP:
            return
        ref_pos = rec.pos
        lastop = None
        last_pos = ref_pos
        l = 0
        for op, ln in rec.cigar:
            seq = ""
            typ = T_NORMAL
            # "="/"X" are M refinements; the reference predates them and
            # errors the window ("I don't know how to smoke this CIGAR")
            if op in ("I", "M", "S", "=", "X"):
                seq = rec.seq[l:l + ln]
                l += ln
            elif op == "D":
                seq = "#" * ln
            if op == "I":
                typ = T_IN
            elif op == "D":
                typ = T_DEL
            if seq:
                if seq[0] == "#":
                    if len(seq) > 30:
                        ln = 30
                    seq = chr(35 + ln)
                self._insert_seq(seq, typ, ref_pos)
            # mark no-insertion at covered insertion sites
            if lastop is not None and lastop != "I":
                if last_pos == ref_pos and lastop not in ("S", "H"):
                    raise HapGenError("Mag niet.")
                for p in range(last_pos, ref_pos):
                    hb = self.insertions.get(p)
                    if hb is not None:
                        hb.insert_hap("", T_IN)
            last_pos = ref_pos
            if op in ("M", "D", "N", "=", "X"):
                ref_pos += ln
            elif op not in ("I", "S", "H"):
                raise HapGenError("I don't know how to smoke this CIGAR")
            lastop = op

    def set_frequencies(self) -> None:
        for b in self.blocks:
            b.set_frequencies()
        for b in self.insertions.values():
            b.set_frequencies()


@dataclass
class _HBS:
    haps: List[BlockHap]
    start: int
    end: int
    type: int


class HDIterator:
    """HDIterator2: window block selection, maxHap pruning and haplotype
    enumeration with candidate-variant injection
    (HaplotypeDistribution.hpp:82-496)."""

    def __str__(self) -> str:
        """--showEmpirical dump (HDIterator2 operator<<,
        HaplotypeDistribution.hpp: block print): per-block haplotypes with
        counts and frequencies."""
        lines = []
        for x, b in enumerate(self.hbs):
            lines.append(f"block[{x}] [{b.start},{b.end}] type={b.type}")
            for h in b.haps:
                lines.append(f"  {h.seq if h.seq else '<del>'} "
                             f"count={h.count} freq={h.freq:.4f}")
        return "\n".join(lines)

    def __init__(self, hd: HaplotypeDistribution, max_hap: int, pos: int,
                 left: int, right: int, no_indel_window: int = -1):
        self.mid_pos = pos
        self._setup_blocks(hd, pos, left, right)
        self._set_thresholds(max_hap)

    def _setup_blocks(self, hd: HaplotypeDistribution, pos: int, left: int, right: int):
        sel: List[HapBlock] = []
        blocks = hd.blocks
        for x in range(len(blocks)):
            if x and blocks[x - 1].end() > blocks[x].start():
                raise HapGenError("Blocks are overlapping.")
            if blocks[x].start() >= left and blocks[x].end() <= right:
                if blocks[x - 1].end() + 1 != blocks[x].start():
                    raise HapGenError("Blocks are not consecutive.")
                sel.append(blocks[x])
        # weave insertion blocks in before the first selected block with
        # start >= insertion position (HaplotypeDistribution.hpp:340-351)
        lit = 0
        for ipos in sorted(hd.insertions):
            ib = hd.insertions[ipos]
            if ib.start() >= left:
                for j in range(lit, len(sel)):
                    if sel[j].start() >= ipos:
                        sel.insert(j, ib)
                        lit = j
                        break
        # HDIterator2::start()/end() return the raw extent of the first/last
        # woven block (HaplotypeDistribution.hpp:115-116)
        if sel:
            self._start = sel[0].start()
            self._end = sel[-1].end()
        self.hbs: List[_HBS] = []
        for blk in sel:
            haps = [BlockHap(h.seq, h.type, h.count, h.freq) for h in blk.sorted_haps()]
            start = blk.start()
            end = blk.end()
            if blk.type == B_INSERT:
                end = start - 1
            if not any(h.type & T_REF for h in haps):
                raise HapGenError("Cannot find reference sequence.")
            self.hbs.append(_HBS(haps=haps, start=start, end=end, type=blk.type))
        if not self.hbs:
            raise HapGenError("Not enough blocks.")

    def _set_thresholds(self, max_hap: int):
        """setThresholds (HaplotypeDistribution.hpp:403-482): remove the
        globally-lowest-frequency non-Ref block haplotype until the product
        of block sizes is <= maxHap."""
        hbs = self.hbs
        elim = [1] * len(hbs)
        log_nh = sum(math.log(len(b.haps)) for b in hbs)
        log_mh = max(math.log(max_hap), 0.0)
        erased = True
        while log_nh > log_mh and erased:
            erased = False
            min_freq = [2.0] * len(hbs)
            for x, b in enumerate(hbs):
                mf = 2.0
                for h in b.haps:
                    if not (h.type & T_REF) and h.freq < mf:
                        mf = h.freq
                if len(b.haps) <= 1:
                    min_freq[x] = 2.0
                    elim[x] = 0
                else:
                    min_freq[x] = mf
            y = min(range(len(hbs)), key=lambda i: min_freq[i])
            if elim[y] == 0:
                break
            for i, h in enumerate(hbs[y].haps):
                if not (h.type & T_REF) and h.freq <= min_freq[y]:
                    del hbs[y].haps[i]
                    erased = True
                    break
            log_nh = sum(math.log(len(b.haps)) for b in hbs)
        self.log_num_haps = log_nh
        # check every block still has the reference hap
        for b in hbs:
            if not any(h.type & T_REF for h in b.haps):
                raise HapGenError("Cannot find reference sequence.")

    def start(self) -> int:
        return self._start

    def end(self) -> int:
        return self._end

    def get_log_num_haps(self) -> float:
        return self.log_num_haps

    def generate_haps_with_aligned_variants(
            self, candidates: AlignedCandidates,
            change_ins_to_n: bool = False) -> List[Haplotype]:
        """generateHapsWithAlignedVariants (HaplotypeDistribution.hpp:171-309)."""
        vec_hap: List[Haplotype] = []
        vec_ref_pos: List[List[int]] = []
        idx = [0] * len(self.hbs)
        maxi = [len(b.haps) for b in self.hbs]
        last = False
        while not last:
            seq_parts: List[str] = []
            ref_pos: List[int] = []
            freq = 1.0
            for x, b in enumerate(self.hbs):
                h = b.haps[idx[x]]
                if b.type == B_NORMAL:
                    p = b.start
                    has_del = False
                    for ch in h.seq:
                        c = ord(ch)
                        if 35 <= c < 65:
                            has_del = True
                        ref_pos.append(p)
                        p += 1
                    if not has_del and len(h.seq) != (b.end - b.start + 1):
                        raise HapGenError("What's going on here?")
                else:
                    ref_pos.extend([-1] * len(h.seq))
                seq_parts.append(h.seq)
                freq *= h.freq
            seq = "".join(seq_parts)
            # effectuate deletion codes
            y = 0
            seq_l = list(seq)
            while y < len(seq_l):
                c = ord(seq_l[y])
                if 35 <= c < 65:
                    ln = c - 35
                    if ln > len(seq_l) - y:
                        ln = len(seq_l) - y
                    del seq_l[y:y + ln]
                    del ref_pos[y:y + ln]
                else:
                    y += 1
            hap = Haplotype(seq="".join(seq_l), freq=freq)
            vec_hap.append(hap)
            vec_ref_pos.append(ref_pos)
            # increment odometer (iter[0] fastest)
            x = 0
            while x < len(idx):
                idx[x] += 1
                if idx[x] != maxi[x]:
                    break
                idx[x] = 0
                if x == len(idx) - 1:
                    last = True
                x += 1

        # inject candidate variants: first addComb, then the rest
        for ac in (True, False):
            num_hap = len(vec_hap)
            for var in candidates.variants:
                if ac:
                    num_hap = len(vec_hap)
                if var.add_comb != ac:
                    continue
                for h in range(num_hap):
                    hap = vec_hap[h]
                    ref_pos = vec_ref_pos[h]
                    try:
                        i = ref_pos.index(var.start_hap)
                    except ValueError:
                        continue
                    changed = False
                    new_seq = hap.seq
                    new_ref_pos = list(ref_pos)
                    if var.type == DEL:
                        # NB: when the deletion extends past the haplotype
                        # tail the reference is undefined behavior
                        # (vector::erase past end,
                        # HaplotypeDistribution.hpp:262-266, crashes under
                        # ASan); Python slice semantics clamp, which is the
                        # only defined extension of the contract
                        new_seq = new_seq[:i] + new_seq[i + var.size():]
                        del new_ref_pos[i:i + var.size()]
                        changed = True
                    elif var.type == INS:
                        ins = ("N" * len(var.seq)) if change_ins_to_n else var.seq
                        new_seq = new_seq[:i] + ins + new_seq[i:]
                        new_ref_pos[i:i] = [-1] * var.size()
                        changed = True
                    elif var.type == SNP:
                        nuc = var.seq[3]
                        if new_seq[i] != nuc:
                            new_seq = new_seq[:i] + nuc + new_seq[i + 1:]
                            changed = True
                    if changed:
                        vec_hap.append(Haplotype(seq=new_seq, freq=hap.freq))
                        vec_ref_pos.append(new_ref_pos)

        # dedupe by sequence, keep first occurrence, output sorted by seq
        seen: Dict[str, Haplotype] = {}
        for hap in vec_hap:
            if hap.seq not in seen:
                seen[hap.seq] = hap
        return [seen[s] for s in sorted(seen)]
