"""Writers of the benchmark's input files, from the SAM/BAM spec: a
coordinate-sorted BAM with its .bai index, and a FASTA with its .fai.

The records are packed from numpy arrays in bulk; BGZF blocks are
compressed by zlib on a few threads.  Every record has the read length
of the design, mapping quality `mapq`, one quality value, the tag RG:Z
of the file's one read group and the name r<pair>."""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_NT16 = np.zeros(256, np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    _NT16[ord(_c)] = _i
BLOCK = 0xFF00


def write_fasta(path: str, name: str, seq: np.ndarray, width: int = 60):
    """`seq` (uint8 ASCII) as one FASTA record, and its .fai."""
    head = f">{name}\n".encode()
    n = seq.shape[0]
    full = n // width
    body = np.concatenate([seq[:full * width].reshape(full, width),
                           np.full((full, 1), 10, np.uint8)], 1).tobytes()
    if n % width:
        body += seq[full * width:].tobytes() + b"\n"
    with open(path, "wb") as f:
        f.write(head + body)
    with open(path + ".fai", "w") as f:
        f.write(f"{name}\t{n}\t{len(head)}\t{width}\t{width + 1}\n")


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """UCSC binning (SAM spec section 5.3), over arrays."""
    end = end - 1
    out = np.zeros(beg.shape[0], np.int64)
    done = np.zeros(beg.shape[0], bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & (beg >> shift == end >> shift)
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _names(pair: np.ndarray):
    """(lengths, [(rows, bytes (rows, len))]) of the names "r<pair>" with
    their NUL, grouped by their number of digits."""
    digits = np.ones(pair.shape[0], np.int64)
    for d in range(1, 19):
        digits += pair >= 10 ** d
    groups = []
    for d in np.unique(digits).tolist():
        rows = np.nonzero(digits == d)[0]
        b = np.zeros((rows.shape[0], d + 2), np.uint8)
        b[:, 0] = ord("r")
        for j in range(d):
            b[:, 1 + j] = 48 + pair[rows] // 10 ** (d - 1 - j) % 10
        groups.append((rows, b))
    return digits + 2, groups


_FIXED = np.dtype([("size", "<i4"), ("ref", "<i4"), ("pos", "<i4"),
                   ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("next_ref", "<i4"), ("next_pos", "<i4"),
                   ("tlen", "<i4")])


def _pack(parts, n: int, chunk: int = 1 << 17) -> np.ndarray:
    """The records' bytes, one after another: parts are (rows (n, w),
    valid (n,) bytes of each row's left end, or None for all w)."""
    out = []
    for c in range(0, n, chunk):
        sl = slice(c, min(n, c + chunk))
        rows = np.concatenate([r[sl] for r, _ in parts], 1)
        mask = np.concatenate(
            [np.ones(r[sl].shape, bool) if v is None
             else np.arange(r.shape[1]) < v[sl, None] for r, v in parts], 1)
        out.append(rows[mask])
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def write_bam(path: str, ref_name: str, ref_len: int, sample: str, reads,
              base_qual: int, mapq: int, level: int = 6,
              threads: int = 4, rg: str = "rg1",
              library: str = "lib1") -> None:
    """`reads` (sim.Reads) sorted by position, as a BAM and its .bai,
    with one read group (`rg`, its library and `sample`).  Records are
    packed in bulk with numpy; BGZF blocks are compressed on `threads`
    threads (zlib lets go of the interpreter's lock)."""
    order = np.argsort(reads.pos, kind="stable")
    n, L = reads.seq.shape
    op, at, ln = (reads.ev_op[order], reads.ev_at[order],
                  reads.ev_len[order])
    pos = reads.pos[order].astype(np.int64)
    # the CIGAR: M, then the event, then M, dropping empty operations
    rest = np.where(op == 2, L - at, L - at - ln)
    cig_ops = np.stack([np.zeros(n, np.int64), op, np.zeros(n, np.int64)], 1)
    cig_lens = np.stack([at, ln, rest], 1)
    cig_lens[op == 0] = [L, 0, 0]
    keep = cig_lens > 0
    # left-pack the kept operations
    rank = np.argsort(~keep, axis=1, kind="stable")
    cig_ops = np.take_along_axis(cig_ops, rank, 1)
    cig_lens = np.take_along_axis(cig_lens, rank, 1)
    n_cig = keep.sum(1)
    words = ((cig_lens << 4) | cig_ops).astype("<u4")
    ref_span = np.where(op == 2, L + ln, np.where(op == 0, L, L - ln))
    end = pos + np.maximum(ref_span, 1)
    l_name, names = _names(reads.pair[order].astype(np.int64))

    seq4 = _NT16[reads.seq[order]]
    Lp = (L + 1) // 2
    tag = b"RGZ" + rg.encode() + b"\x00"
    tail = np.empty((n, Lp + L + len(tag)), np.uint8)
    tail[:, :L // 2 + L % 2] = seq4[:, 0::2] << 4
    tail[:, :L // 2] |= seq4[:, 1::2]
    tail[:, Lp:Lp + L] = base_qual
    tail[:, Lp + L:] = np.frombuffer(tag, np.uint8)

    text = (f"@HD\tVN:1.3\tSO:coordinate\n@SQ\tSN:{ref_name}\tLN:{ref_len}\n"
            f"@RG\tID:{rg}\tLB:{library}\tSM:{sample}\n").encode()
    name_b = ref_name.encode() + b"\x00"
    header = (b"BAM\x01" + struct.pack("<i", len(text)) + text
              + struct.pack("<ii", 1, len(name_b)) + name_b
              + struct.pack("<i", ref_len))
    size = 36 + l_name + 4 * n_cig + tail.shape[1]
    starts = len(header) + np.concatenate([[0], np.cumsum(size)])
    fixed = np.zeros(n, _FIXED)
    fixed["size"] = size - 4
    fixed["pos"] = pos
    fixed["l_name"] = l_name
    fixed["mapq"] = mapq
    fixed["bin"] = reg2bin(pos, end)
    fixed["n_cigar"] = n_cig
    fixed["flag"] = reads.flag[order]
    fixed["l_seq"] = L
    fixed["next_pos"] = reads.mpos[order]
    fixed["tlen"] = reads.isize[order]
    name_rows = np.zeros((n, int(l_name.max(initial=0))), np.uint8)
    for rows, b in names:
        name_rows[rows, :b.shape[1]] = b
    raw = np.concatenate([np.frombuffer(header, np.uint8), _pack(
        [(fixed.view(np.uint8).reshape(n, 36), None), (name_rows, l_name),
         (words.view(np.uint8).reshape(n, 12), 4 * n_cig), (tail, None)],
        n)])
    assert raw.shape[0] == starts[-1]
    cuts = range(0, raw.shape[0], BLOCK)
    with ThreadPoolExecutor(threads) as ex:
        blocks = list(ex.map(lambda b: _bgzf_block(raw[b:b + BLOCK], level),
                             cuts))
    coff = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])
    with open(path, "wb") as f:
        f.writelines(blocks)
        f.write(BGZF_EOF)
    voff = (coff[starts // BLOCK] << 16) | (starts % BLOCK)
    _write_bai(path + ".bai", pos, end, fixed["bin"].astype(np.int64),
               voff[:-1], voff[1:])


def _bgzf_block(data, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(data) + comp.flush()
    return (struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                        66, 67, 2, len(cdata) + 25) + cdata
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data)))


def _write_bai(path: str, pos, end, bins, vbeg, vend) -> None:
    """One reference's bins and linear index, as samtools writes them:
    a bin's chunk is a run of consecutive records in that bin (records
    are contiguous, so only neighbours' chunks touch and merge)."""
    n = pos.shape[0]
    run0 = np.nonzero(np.concatenate([[True], bins[1:] != bins[:-1]]))[0]
    run1 = np.concatenate([run0[1:], [n]]) - 1
    chunks = {}
    for b, a, z in zip(bins[run0].tolist(), vbeg[run0].tolist(),
                       vend[run1].tolist()):
        chunks.setdefault(b, []).append((a, z))
    out = bytearray(b"BAI\x01" + struct.pack("<ii", 1, len(chunks)))
    for b in sorted(chunks):
        out += struct.pack("<Ii", b, len(chunks[b]))
        for c in chunks[b]:
            out += struct.pack("<QQ", *c)
    w0, w1 = pos >> 14, (end - 1) >> 14
    n_win = int(w1.max()) + 1 if n else 0
    lin = np.full(n_win, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(lin, w0, vbeg)
    np.minimum.at(lin, w1, vbeg)
    last = int(lin.min()) if n else 0
    arr = []
    for v in lin.tolist():
        last = v if v != np.iinfo(np.int64).max else last
        arr.append(last)
    out += struct.pack(f"<i{n_win}Q", n_win, *arr)
    with open(path, "wb") as f:
        f.write(bytes(out))
