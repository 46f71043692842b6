"""Variant string codec and candidate-window file parsing.

String encoding (reference Variant.hpp:30-75):
  ``+ACGT``  insertion of ACGT
  ``-ACGT``  deletion of ACGT
  ``A=>G``   SNP (4 chars)
  ``*REF``   reference allele marker

Window file format (reference VariantFile.hpp:188-288)::

  tid leftPos rightPos pos,var[,freq[,addComb]] pos,var ... [# ...]

Legacy candidate format (VariantFile.hpp:120-186)::

  tid pos var1 var2 ... [prior freq1 freq2 ...] # counts...
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

INS = 0
DEL = 1
SNP = 2
REF = 3

_TYPE_NAMES = {INS: "INS", DEL: "DEL", SNP: "SNP", REF: "REF"}


class VariantParseError(ValueError):
    pass


def _parse_variant_string(s: str):
    """Returns (type, seq, length). Mirrors Variant::initFromString
    (Variant.hpp:45-70)."""
    if len(s) > 1:
        if s[0] == "-":
            return DEL, s[1:], len(s) - 1
        if s[0] == "+":
            return INS, s[1:], len(s) - 1
        if len(s) == 4 and s[1] == "=" and s[2] == ">":
            return SNP, s, 1
        if s == "*REF":
            return REF, "*REF", 1
    raise VariantParseError(f"Unrecognized variant: {s!r}")


@dataclass(frozen=True)
class Variant:
    """An indel/SNP/REF allele encoded as a string (Variant.hpp:30-75)."""

    str: str

    def __post_init__(self):
        t, seq, length = _parse_variant_string(self.str)
        object.__setattr__(self, "_type", t)
        object.__setattr__(self, "_seq", seq)
        object.__setattr__(self, "_length", length)

    @property
    def type(self) -> int:
        return self._type

    @property
    def seq(self) -> str:
        return self._seq

    @property
    def length(self) -> int:
        return self._length

    def size(self) -> int:
        return self._length

    @property
    def is_indel(self) -> bool:
        return self._type in (INS, DEL)

    @property
    def is_snp(self) -> bool:
        return self._type == SNP

    @property
    def is_ref(self) -> bool:
        return self._type == REF


@dataclass
class AlignedVariant:
    """A variant anchored on a haplotype (and optionally a read).

    Mirrors AlignedVariant (Variant.hpp:78-175).  ``start_hap`` is the
    0-based position in the haplotype/reference-window the variant is
    aligned to; for candidate variants from the window file, it is the
    absolute reference position (the reference constructs them with
    canonicalPos; see VariantFile.hpp:267).
    """

    str: str
    start_hap: int = -1
    end_hap: Optional[int] = None
    start_read: int = -1
    end_read: int = -1
    freq: float = -1.0
    add_comb: bool = False
    # left/right flanking coordinates (ambiguity interval), Variant.hpp:159-166
    left_flank_hap: int = field(default=None)  # type: ignore
    right_flank_hap: int = field(default=None)  # type: ignore
    left_flank_read: int = field(default=None)  # type: ignore
    right_flank_read: int = field(default=None)  # type: ignore

    def __post_init__(self):
        t, seq, length = _parse_variant_string(self.str)
        self.type = t
        self.seq = seq
        self.length = length
        if self.end_hap is None:
            # canonical-position constructor semantics (Variant.hpp:100-121)
            if t == DEL:
                self.end_hap = self.start_hap + length - 1
            else:
                self.end_hap = self.start_hap
        if self.left_flank_hap is None:
            self.left_flank_hap = self.start_hap
        if self.right_flank_hap is None:
            self.right_flank_hap = self.end_hap
        if self.left_flank_read is None:
            self.left_flank_read = self.start_read
        if self.right_flank_read is None:
            self.right_flank_read = self.end_read

    # --- reference API ---
    def size(self) -> int:
        return self.length

    @property
    def is_indel(self) -> bool:
        return self.type in (INS, DEL)

    @property
    def is_snp(self) -> bool:
        return self.type == SNP

    @property
    def is_ref(self) -> bool:
        return self.type == REF

    def is_covered(self, pad: int, first_base: int, last_base: int) -> bool:
        """Variant.hpp:125-128."""
        return first_base + pad <= self.start_read and last_base - pad >= self.end_read

    def is_equal(self, pos: int, type_: int, s: str) -> bool:
        """Variant.hpp:134-147 — candidate matching rule: SNPs compare the
        middle 3 chars, INS compares the full string, DEL compares only the
        length (deleted sequence identity is not required)."""
        if self.type == type_ and self.start_hap == pos:
            if type_ == SNP:
                return s[1:4] == self.str[1:4]
            if type_ == INS:
                return self.str == s
            if type_ == DEL:
                return len(self.str) == len(s)
        return False

    def set_flanking(self, lfh: int, rfh: int, lfr: int, rfr: int) -> None:
        self.left_flank_hap = lfh
        self.right_flank_hap = rfh
        self.left_flank_read = lfr
        self.right_flank_read = rfr

    # ordering mirrors AlignedVariant::operator< (Variant.hpp:130-133)
    def sort_key(self):
        return (self.start_hap, self.str)

    def __hash__(self):
        return hash((self.start_hap, self.str))

    def __eq__(self, other):
        return (self.start_hap, self.str) == (other.start_hap, other.str)

    def __lt__(self, other):
        return self.sort_key() < other.sort_key()

    def __repr__(self):
        return f"AlignedVariant({self.str}@{self.start_hap})"


@dataclass
class AlignedCandidates:
    """One realignment-window line (VariantFile.hpp:38-71)."""

    tid: str = ""
    variants: List[AlignedVariant] = field(default_factory=list)
    left_pos: int = 0
    right_pos: int = 0

    @property
    def center_pos(self) -> int:
        return self.left_pos + (self.right_pos - self.left_pos) // 2

    def find_variant(self, pos: int, type_: int, s: str) -> Optional[AlignedVariant]:
        for v in self.variants:
            if v.is_equal(pos, type_, s):
                return v
        return None


_VARIANT_LEAD = set("-+ACGTR")


def parse_window_line(line: str, is_one_based: bool = False) -> Optional[AlignedCandidates]:
    """Parse one window line (VariantFile::getLineVector,
    VariantFile.hpp:188-288). Returns None for empty/unparseable lines."""
    line = line.rstrip("\n")
    if not line.strip():
        return None
    toks = line.split()
    if len(toks) < 3:
        return None
    tid = toks[0]
    try:
        left_pos = int(toks[1])
        right_pos = int(toks[2])
    except ValueError:
        raise VariantParseError("Cannot read window boundary")
    variants: List[AlignedVariant] = []
    try:
        for tok in toks[3:]:
            if not tok:
                break
            if tok[0] in "#%":
                break
            els = [e for e in _split_fields(tok)]
            if len(els) < 2:
                continue  # reference prints an error and continues
            pos = int(els[0])
            if is_one_based:
                pos -= 1
            col = els[1]
            if not col or col[0] not in _VARIANT_LEAD:
                raise VariantParseError("Unrecognized variant")
            freq = -1.0
            add_comb = False
            if len(els) > 2:
                freq = float(els[2])
            if len(els) > 3:
                add_comb = bool(int(els[3]))
            v = AlignedVariant(col, start_hap=pos, freq=freq, add_comb=add_comb)
            if v.seq:
                variants.append(v)
    except VariantParseError:
        return None
    except ValueError:
        return None
    if not variants:
        return None
    return AlignedCandidates(tid=tid, variants=variants, left_pos=left_pos, right_pos=right_pos)


def _split_fields(tok: str):
    """Split on ',' and ';' exactly like VariantFile.hpp:236-244 (empty
    fields between consecutive separators are dropped; trailing field kept)."""
    els = []
    lastpos = 0
    for x, c in enumerate(tok):
        if c in ",;" and x - lastpos > 0:
            els.append(tok[lastpos:x])
            lastpos = x + 1
    els.append(tok[lastpos:])
    return els
