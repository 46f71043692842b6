"""BAM reading/writing + BAI indexing, written from the SAM/BAM spec.

Replaces the libbam API surface the reference uses: record iteration
(``samread``), region fetch (``bam_fetch`` + ``bam_index_load``), record
writing (``bam_write1``), header handling and the RG->library lookup
(``bam_get_library``).  No samtools code."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .bgzf import BgzfReader

CIGAR_OPS = "MIDNSHP=X"
SEQ_NT16 = "=ACMGRSVTWYHKDBN"

# flags
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    qname: str = ""
    flag: int = 0
    tid: int = -1
    pos: int = -1
    mapq: int = 0
    cigar: List[Tuple[str, int]] = field(default_factory=list)
    mtid: int = -1
    mpos: int = -1
    isize: int = 0
    seq: str = ""
    qual: bytes = b""           # raw phred values (no +33)
    tags: List[Tuple[str, str, object]] = field(default_factory=list)
    # optional raw aux bytes; parsed into `tags` on first access (tag
    # parsing was a top host cost and most records never need tags)
    aux_raw: Optional[bytes] = None

    # --- flag helpers (bam.h macro equivalents) ---
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def mate_is_unmapped(self) -> bool:
        return bool(self.flag & FMUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def mate_is_reverse(self) -> bool:
        return bool(self.flag & FMREVERSE)

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FPAIRED)

    def end_pos(self) -> int:
        """bam_calend: pos + ref-consuming cigar lengths; pos+1 if no
        cigar (Read.hpp:181-184)."""
        if not self.cigar:
            return self.pos + 1
        end = self.pos
        for op, ln in self.cigar:
            if op in "MDN=X":
                end += ln
        return end

    def all_tags(self) -> List[Tuple[str, str, object]]:
        if self.aux_raw is not None:
            self.tags = _parse_tags(self.aux_raw, 0)
            self.aux_raw = None
        return self.tags

    def get_tag(self, name: str):
        for tag, _typ, val in self.all_tags():
            if tag == name:
                return val
        return None

    def aux_string(self) -> str:
        """Mirror of Read::getAuxData (Read.hpp:223-256) used by
        --filterReadAux matching."""
        out = []
        for tag, typ, val in self.all_tags():
            if typ in "AZH":
                out.append(f"\t{tag}{typ}:{val}")
            elif typ == "f":
                out.append(f"\t{tag}f:{val:g}")
            else:
                out.append(f"\t{tag}i:{val}")
        return "".join(out)


@dataclass
class BamHeader:
    text: str = ""
    refs: List[Tuple[str, int]] = field(default_factory=list)

    def tid_of(self, name: str) -> int:
        for i, (n, _l) in enumerate(self.refs):
            if n == name:
                return i
        raise KeyError(f"Cannot find ID! {name}")

    def name_of(self, tid: int) -> str:
        return self.refs[tid][0]

    def rg_to_library(self) -> Dict[str, str]:
        """RG ID -> LB map (bam_get_library equivalent)."""
        out = {}
        for line in self.text.split("\n"):
            if line.startswith("@RG"):
                rg_id = None
                lib = None
                for f in line.split("\t")[1:]:
                    if f.startswith("ID:"):
                        rg_id = f[3:]
                    elif f.startswith("LB:"):
                        lib = f[3:]
                if rg_id is not None and lib is not None:
                    out[rg_id] = lib
        return out


def _parse_record(data: bytes) -> BamRecord:
    (tid, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq,
     mtid, mpos, isize) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    qname = data[off:off + l_qname - 1].decode()
    off += l_qname
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", data, off)[0]
        cigar.append((CIGAR_OPS[v & 0xF], v >> 4))
        off += 4
    nseq_bytes = (l_seq + 1) // 2
    seq_chars = []
    for i in range(l_seq):
        b = data[off + (i >> 1)]
        code = (b >> 4) if (i & 1) == 0 else (b & 0xF)
        seq_chars.append(SEQ_NT16[code])
    off += nseq_bytes
    qual = data[off:off + l_seq]
    off += l_seq
    tags = _parse_tags(data, off)
    return BamRecord(qname=qname, flag=flag, tid=tid, pos=pos, mapq=mapq,
                     cigar=cigar, mtid=mtid, mpos=mpos, isize=isize,
                     seq="".join(seq_chars), qual=qual, tags=tags)


def _parse_tags(data: bytes, off: int) -> List[Tuple[str, str, object]]:
    tags = []
    n = len(data)
    while off + 3 <= n:
        tag = data[off:off + 2].decode()
        typ = chr(data[off + 2])
        off += 3
        if typ == "A":
            tags.append((tag, "A", chr(data[off]))); off += 1
        elif typ == "c":
            tags.append((tag, "i", struct.unpack_from("<b", data, off)[0])); off += 1
        elif typ == "C":
            tags.append((tag, "i", struct.unpack_from("<B", data, off)[0])); off += 1
        elif typ == "s":
            tags.append((tag, "i", struct.unpack_from("<h", data, off)[0])); off += 2
        elif typ == "S":
            tags.append((tag, "i", struct.unpack_from("<H", data, off)[0])); off += 2
        elif typ == "i":
            tags.append((tag, "i", struct.unpack_from("<i", data, off)[0])); off += 4
        elif typ == "I":
            tags.append((tag, "i", struct.unpack_from("<I", data, off)[0])); off += 4
        elif typ == "f":
            tags.append((tag, "f", struct.unpack_from("<f", data, off)[0])); off += 4
        elif typ in "ZH":
            end = data.index(b"\x00", off)
            tags.append((tag, typ, data[off:end].decode())); off = end + 1
        elif typ == "B":
            sub = chr(data[off]); cnt = struct.unpack_from("<I", data, off + 1)[0]
            sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            off += 5 + cnt * sz
            tags.append((tag, "B", None))
        else:
            break
    return tags


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BamReader:
    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader.open(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise IOError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        text = self._bgzf.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            refs.append((name, l_ref))
        self.header = BamHeader(text=text, refs=refs)
        self._data_voffset = self._bgzf.tell_virtual()
        self._index: Optional[dict] = None

    def close(self):
        self._bgzf.close()

    def __iter__(self) -> Iterator[BamRecord]:
        self._bgzf.seek_virtual(self._data_voffset)
        while True:
            r = self._read_one()
            if r is None:
                break
            yield r

    def _read_one(self) -> Optional[BamRecord]:
        raw = self._bgzf.read(4)
        if len(raw) < 4:
            return None
        block_size = struct.unpack("<i", raw)[0]
        data = self._bgzf.read(block_size)
        if len(data) < block_size:
            return None
        return _parse_record(data)

    def _load_index(self):
        if self._index is None:
            self._index = read_bai(self.path + ".bai")
        return self._index

    def fetch(self, tid: int, beg: int, end: int) -> Iterator[BamRecord]:
        """bam_fetch semantics: yields records overlapping [beg, end),
        in file order, using the .bai index when present."""
        try:
            idx = self._load_index()
        except FileNotFoundError:
            idx = None
        if idx is None or tid >= len(idx["refs"]):
            for r in self:
                if r.tid == tid and r.pos < end and r.end_pos() > beg:
                    yield r
                elif r.tid > tid or (r.tid == tid and r.pos >= end):
                    break
            return
        bins, linear = idx["refs"][tid]
        chunks = []
        min_off = 0
        lin_i = beg >> 14
        if lin_i < len(linear):
            min_off = linear[lin_i]
        for b in reg2bins(beg, end):
            for (cbeg, cend) in bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        # merge adjacent
        merged = []
        for c in chunks:
            if merged and c[0] <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
            else:
                merged.append(list(c) if False else (c[0], c[1]))
        for (cbeg, cend) in merged:
            self._bgzf.seek_virtual(cbeg)
            while self._bgzf.tell_virtual() < cend:
                r = self._read_one()
                if r is None:
                    break
                if r.tid != tid or r.pos >= end:
                    return
                if r.end_pos() > beg:
                    yield r


def read_bai(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAI\x01":
        raise IOError("bad BAI magic")
    off = 4
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", data, off)[0]
        off += 4
        bins = {}
        for _ in range(n_bin):
            bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                cbeg, cend = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((cbeg, cend))
            bins[bin_id] = chunks
        n_intv = struct.unpack_from("<i", data, off)[0]
        off += 4
        linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        refs.append((bins, linear))
    return {"refs": refs}
