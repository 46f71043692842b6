"""Indexed FASTA access (.fai), our own implementation of the faidx
behavior the reference gets from samtools (Fasta.hpp:32-71, fai_fetch).

Coordinates in get_sequence are 1-based inclusive, like samtools region
strings; out-of-range ends are clamped like fai_fetch. Results are
uppercased (Fasta.hpp:58, DInDel.cpp:285)."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


class FastaFile:
    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path)
        self.index: Dict[str, Tuple[int, int, int, int]] = {}
        self.order: List[str] = []
        with open(fai) as f:
            for line in f:
                toks = line.rstrip("\n").split("\t")
                if len(toks) < 5:
                    continue
                name = toks[0]
                self.index[name] = (int(toks[1]), int(toks[2]), int(toks[3]), int(toks[4]))
                self.order.append(name)
        self._fh = open(path, "rb")

    def close(self):
        self._fh.close()

    def lengths(self) -> Dict[str, int]:
        return {n: v[0] for n, v in self.index.items()}

    def get_sequence(self, tid: str, start: int, end: int) -> str:
        """1-based inclusive fetch, clamped, uppercased."""
        if tid not in self.index:
            raise KeyError(f"Fasta: unknown sequence {tid}")
        length, offset, linebases, linewidth = self.index[tid]
        if start < 1:
            start = 1
        if end > length:
            end = length
        if end < start:
            raise ValueError("faidx error, len==0")
        s0 = start - 1
        e0 = end
        first_line = s0 // linebases
        first_off = s0 % linebases
        byte_start = offset + first_line * linewidth + first_off
        nbases = e0 - s0
        # bytes to read: bases + newline bytes interspersed
        max_bytes = nbases + (nbases // linebases + 2) * (linewidth - linebases)
        self._fh.seek(byte_start)
        raw = self._fh.read(max_bytes)
        out = []
        n = 0
        for ch in raw:
            if ch in (10, 13):
                continue
            out.append(ch)
            n += 1
            if n == nbases:
                break
        return bytes(out).decode().upper()

    def get0(self, tid: str, start0: int, n: int) -> str:
        """0-based fetch of n bases (python/utils/Fasta.py get semantics)."""
        return self.get_sequence(tid, start0 + 1, start0 + n)


def build_fai(path: str) -> None:
    """Build a .fai index (name, length, offset, linebases, linewidth)."""
    entries = []
    with open(path, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first = True
        while True:
            line_off = f.tell()
            line = f.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = f.tell()
                first = True
            else:
                bases = len(line.rstrip(b"\r\n"))
                if first and bases:
                    linebases = bases
                    linewidth = len(line)
                    first = False
                length += bases
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    with open(path + ".fai", "w") as f:
        for e in entries:
            f.write("\t".join(str(x) for x in e) + "\n")
