"""The port's read intake (native/reads_intake.cpp, io/reads_intake.py)
and its read-ahead (engine/reads.py ReadBuffer): get_reads returns, window
by window, exactly the reads of dindel_tpu's get_reads (the JAX package's
host code), every field of every read in order, whether a window's intake
came from the read-ahead or ran in the window; the engines write the same
GLF with the read-ahead as without it; and nothing is left running or
open after a pass ends or stops."""

import shutil

import numpy as np
import pytest
import torch

from dindel_tpu.config import Parameters as JaxParameters
from dindel_tpu.engine import reads as jax_reads
from dindel_tpu.io.bam_native import open_bam as jax_open_bam
from dindel_tpu.model import LibraryCollection as JaxLibraries
from dindel_tpu_torch.config import Parameters
from dindel_tpu_torch.engine import reads
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.stats import RunStats
from dindel_tpu_torch.engine.window import WindowEngine
from dindel_tpu_torch.io import reads_intake
from dindel_tpu_torch.io.bam import (BamHeader, BamRecord, BamWriter, FDUP,
                                     FMREVERSE, FMUNMAP, FPAIRED, FQCFAIL,
                                     FREVERSE, FSUPPLEMENTARY, FUNMAP)
from dindel_tpu_torch.io.bam_native import open_bam
from dindel_tpu_torch.model import LibraryCollection
from test_device_call import _sim
from test_torch_engine import no_slab_rescues  # noqa: F401 (autouse)

torch.set_num_threads(1)

READ_LEN = 70


def _write_bam(path, contigs, seed, coverage=8, triple=False, prefix=""):
    """An indexed, coordinate-sorted BAM of random pairs on `contigs`
    [(name, length)] with every flag case the intake columns take:
    duplicates, QC failures and supplementary records (dropped), unmapped
    mates placed at their mate, mates on another contig, single-end
    reads, reverse strands, MAPQ 0-255, soft clips, deletions,
    insertions, RG tags on half the records.  `triple` adds a third
    record under one pair's name."""
    rng = np.random.RandomState(seed)
    text = "@HD\tVN:1.0\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in contigs) + \
        "@RG\tID:g1\tLB:libA\tSM:S\n"
    cigars = [[("M", READ_LEN)], [("S", 5), ("M", READ_LEN - 5)],
              [("M", 30), ("D", 3), ("M", READ_LEN - 30)],
              [("M", 30), ("I", 2), ("M", READ_LEN - 32)]]

    def rec(name, flag, tid, pos, mtid, mpos, cigar, mapq=None):
        tags = [("RG", "Z", "g1")] if rng.rand() < 0.5 else []
        if rng.rand() < 0.02:
            flag |= FDUP
        if rng.rand() < 0.02:
            flag |= FQCFAIL
        if rng.rand() < 0.02:
            flag |= FSUPPLEMENTARY
        n_seq = sum(ln for op, ln in cigar if op in "MIS=X") or READ_LEN
        return BamRecord(
            qname=name, flag=flag, tid=tid, pos=pos,
            mapq=int(rng.choice([0, 10, 29, 37, 50, 60, 255]))
            if mapq is None else mapq,
            cigar=cigar, mtid=mtid, mpos=mpos, isize=0,
            seq="".join("ACGT"[i] for i in rng.randint(0, 4, n_seq)),
            qual=bytes(rng.randint(2, 41, n_seq).tolist()), tags=tags)

    recs = []
    for tid, (name, ln) in enumerate(contigs):
        for i in range(coverage * ln // (2 * READ_LEN)):
            qn = f"{prefix}{name}:p{i}"
            p1 = int(rng.randint(0, ln - 800))
            p2 = p1 + max(0, int(rng.normal(300, 60))) - READ_LEN
            p2 = max(p2, p1)
            c1 = cigars[rng.randint(len(cigars))]
            c2 = cigars[rng.randint(len(cigars))]
            u = rng.rand()
            if u < 0.05:        # single end
                recs.append(rec(qn, 0, tid, p1, -1, -1, c1))
            elif u < 0.10:      # unmapped mate, placed at its mate
                recs.append(rec(qn, FPAIRED | 0x40 | FMUNMAP, tid, p1, tid,
                                p1, c1))
                recs.append(rec(qn, FPAIRED | 0x80 | FUNMAP, tid, p1, tid,
                                p1, [], mapq=0))
            elif u < 0.13:      # mate on another contig
                recs.append(rec(qn, FPAIRED | 0x40, tid, p1,
                                (tid + 1) % (len(contigs) + 1), 1000, c1))
            else:
                rev = rng.rand() < 0.5
                f1 = FPAIRED | 0x2 | 0x40 | (FREVERSE if rev else FMREVERSE)
                f2 = FPAIRED | 0x2 | 0x80 | (FMREVERSE if rev else FREVERSE)
                recs.append(rec(qn, f1, tid, p1, tid, p2, c1))
                recs.append(rec(qn, f2, tid, p2, tid, p1, c2))
    if triple:
        r = next(r for r in recs if r.flag & 0x2 and not r.flag & (
            FDUP | FQCFAIL | FSUPPLEMENTARY) and r.tid == 0
            and 8000 < r.pos < 9000)
        recs.append(BamRecord(qname=r.qname, flag=FPAIRED | 0x40, tid=0,
                              pos=r.pos + 10, mapq=50, cigar=[("M", 70)],
                              mtid=0, mpos=r.pos, seq="A" * 70,
                              qual=bytes([30] * 70)))
    recs.sort(key=lambda r: (r.tid, r.pos))
    w = BamWriter(str(path), BamHeader(
        text=text, refs=[(n, ln) for n, ln in contigs]))
    for r in recs:
        w.write(r)
    w.close()
    return str(path)


def _windows(tid, starts, width=120):
    return [(tid, s, s + width) for s in starts]


def _lib_name(libraries, lib):
    return next(k for k, v in libraries.items() if v is lib)


def _sig(r, libraries):
    """Every field of a Read, the record behind it and the two the
    cascade adds (unknown_lib, bam_end)."""
    b = r.bam
    return (r.seq, r.qual.tolist(), r.map_qual, r.pos, r.pos_stat_first,
            r.pos_stat_var, r.on_reverse_strand, r.is_unmapped, r.is_paired,
            r.mate_is_unmapped, r.mate_is_reverse, r.same_tid_as_mate,
            r.mate_pos, r.mate_len, r.pool_id,
            _lib_name(libraries, r.library), r.qname, r.unknown_lib,
            r.bam_end, b.flag, b.pos, b.tid, b.mapq, list(b.cigar), b.mtid,
            b.mpos, b.isize, b.seq, bytes(b.qual), b.aux_string())


def _drive(mod, bams, windows, params, libraries, stats=None, ahead=False):
    """The engines' window loop over get_reads: per window its reads'
    signatures or its error."""
    buf = mod.ReadBuffer()
    buf.reset = True
    old_tid = None
    out = []
    for k, (tid, left, right) in enumerate(windows):
        params.tid = tid
        if tid != old_tid:
            buf.reset = True
            old_tid = tid
            buf.old_left_pos = 0
        kw = {}
        if ahead:
            kw = dict(stats=stats, next_window=(
                windows[k + 1] if k + 1 < len(windows) else None))
        try:
            got = mod.get_reads(bams, tid, left, right, params, libraries,
                                buf, **kw)
            out.append([_sig(r, libraries) for r in got])
            buf.reset = False
        except mod.WindowError as e:
            out.append(str(e))
            buf.reset = True
        buf.old_left_pos = left
    if ahead:
        buf.close()
    return out


ISOLATED = _windows("1", range(3000, 37000, 6000))


def _case(name, tmp):
    """(BAM paths, windows, Parameters settings) of one case."""
    one = [("1", 40000)]
    if name == "isolated":
        return [_write_bam(tmp / "a.bam", one, 1)], ISOLATED, {}
    if name == "overlapping":
        return ([_write_bam(tmp / "a.bam", one, 2)],
                _windows("1", range(3000, 9000, 400)), {})
    if name == "error_then_next":
        # the third window is too narrow for minReadOverlap: an error,
        # then a reset, so the next window's read-ahead is discarded
        w = ISOLATED[:2] + [("1", 15000, 15030)] + ISOLATED[3:]
        return [_write_bam(tmp / "a.bam", one, 3)], w, {}
    if name == "contig_change":
        bam = _write_bam(tmp / "a.bam", [("1", 30000), ("2", 30000)], 4)
        w = (_windows("1", [3000, 9000, 9300, 21000])
             + _windows("2", [2000, 3000, 15000, 15200])
             + _windows("3", [5000]))
        return [bam], w, {}
    if name == "two_bams":
        return ([_write_bam(tmp / "a.bam", one, 5),
                 _write_bam(tmp / "b.bam", one, 6, prefix="b")],
                _windows("1", [3000, 3500, 9000, 15000, 15400]),
                dict(map_unmapped_reads=True))
    if name == "triple_name":
        return ([_write_bam(tmp / "a.bam", one, 7, triple=True)],
                _windows("1", [3000, 6000, 8500, 8800, 15000, 21000]),
                {})
    if name == "no_bai":
        bam = _write_bam(tmp / "a.bam", one, 8)
        shutil.move(bam + ".bai", str(tmp / "moved.bai"))
        return [bam], _windows("1", [3000, 3400, 9000]), {}
    if name == "small_max_reads":
        # the cap (maxReads x 100) trips where a fetch meets a full
        # buffer; the other windows keep maxReads reads or more
        return ([_write_bam(tmp / "a.bam", one, 9, coverage=12)],
                _windows("1", [3000, 3300, 9000, 15000, 15500, 21000,
                               27000]), dict(max_reads=7))
    raise KeyError(name)


CASES = ["isolated", "overlapping", "error_then_next", "contig_change",
         "two_bams", "triple_name", "no_bai", "small_max_reads"]


@pytest.mark.parametrize("case", CASES)
def test_reads_equal_reference(tmp_path, case):
    """The port's get_reads, reading ahead, equals dindel_tpu's window by
    window; every window but the first of each contig and those after an
    error takes its intake from the read-ahead."""
    paths, windows, settings = _case(case, tmp_path)
    want_p, got_p = JaxParameters(), Parameters()
    for p in (want_p, got_p):
        for k, v in settings.items():
            setattr(p, k, v)
            if hasattr(p.obs_params, k):
                setattr(p.obs_params, k, v)
    want_libs, got_libs = JaxLibraries(), LibraryCollection()
    jb = [jax_open_bam(p) for p in paths]
    pb = [open_bam(p) for p in paths]
    stats = RunStats()
    want = _drive(jax_reads, jb, windows, want_p, want_libs)
    got = _drive(reads, pb, windows, got_p, got_libs, stats, ahead=True)
    for b in jb + pb:
        b.close()
    assert len(got) == len(windows)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, (case, k, windows[k])
    n_ok = sum(not isinstance(w, str) for w in want)
    if case == "small_max_reads":
        assert "Too many reads in region" in want
    else:
        assert n_ok >= 2, want
    c = stats.counts
    if case == "no_bai":
        # no index: every window takes the record iterator, nothing ahead
        assert "reads.ahead_used" not in c
        assert c.get("reads.records_fetched", 0) == 0
    elif case == "isolated":
        assert c["reads.ahead_used"] == len(windows) - 1
        assert "reads.ahead_refetched" not in c
    elif case == "error_then_next":
        assert c["reads.ahead_used"] == len(windows) - 3
        assert c["reads.ahead_refetched"] == 1


def test_intake_columns_match_records(tmp_path):
    """One intake's rows are the records of NativeBamReader.fetch with no
    DUP/QCFAIL/SUPPLEMENTARY flag and pos >= left_fetch, in fetch order,
    with their columns; the flag-kept count includes those left of
    left_fetch; qname keys are equal exactly for equal names, across two
    intakes on one table and not after clear()."""
    bam = _write_bam(tmp_path / "a.bam", [("1", 40000)], 11)
    names = reads_intake.NameTable()
    h = reads_intake.IntakeHandle(bam)
    drop = FDUP | FQCFAIL | FSUPPLEMENTARY
    rd = open_bam(bam)
    keys = {}
    for beg, end, left in [(5000, 9000, 5200), (8000, 12000, 9000)]:
        job = reads_intake.IntakeJob([h], names, [0], beg, end, left, 0,
                                     drop)
        (blk,) = job.blocks()
        assert job.seconds > 0
        recs = list(rd.fetch(0, beg, end))
        assert blk.n_decoded == len(recs) == blk.arena.n
        flag_kept = [i for i, r in enumerate(recs) if not r.flag & drop]
        assert blk.n_flag_kept == len(flag_kept)
        rows = [i for i in flag_kept if recs[i].pos >= left]
        c = blk.cols
        assert c["row"].tolist() == rows
        sel = [recs[i] for i in rows]
        assert c["pos"].tolist() == [r.pos for r in sel]
        assert c["size"].tolist() == [len(r.seq) for r in sel]
        assert c["end"].tolist() == [r.end_pos() for r in sel]
        assert c["mate_pos0"].tolist() == [r.mpos for r in sel]
        assert c["mapq"].tolist() == [r.mapq for r in sel]
        assert c["unmapped"].tolist() == [r.is_unmapped for r in sel]
        assert c["mate_unm"].tolist() == [r.mate_is_unmapped for r in sel]
        assert c["reverse"].tolist() == [r.is_reverse for r in sel]
        assert c["same_tid"].tolist() == [r.mtid == r.tid for r in sel]
        for r, q in zip(sel, c["qid"].tolist()):
            assert keys.setdefault(r.qname, q) == q
        assert [blk.arena.record(i).qname for i in rows] == [
            r.qname for r in sel]
    assert len(set(keys.values())) == len(keys) == len(names)
    names.clear()
    assert len(names) == 0
    h.close()
    names.close()
    rd.close()


def test_block_freed_after_last_view(tmp_path, monkeypatch):
    """A block's columns and arena are views of one native buffer, freed
    once the last of them is gone, and not before."""
    import gc
    bam = _write_bam(tmp_path / "a.bam", [("1", 40000)], 13)
    lib = reads_intake.intake_lib()
    freed = []
    real_free = lib.dri_free
    monkeypatch.setattr(lib, "dri_free",
                        lambda p: (freed.append(p), real_free(p)))
    names = reads_intake.NameTable()
    h = reads_intake.IntakeHandle(bam)
    (blk,) = reads_intake.IntakeJob([h], names, [0], 5000, 9000, 5000, 0,
                                    FDUP).blocks()
    seq, pos = blk.arena.seq_b, blk.cols["pos"]
    want = (bytes(seq[:20]), pos[:5].tolist())
    del blk
    gc.collect()
    assert freed == []
    assert (bytes(seq[:20]), pos[:5].tolist()) == want
    del seq
    gc.collect()
    assert freed == []
    del pos
    gc.collect()
    assert len(freed) == 1
    h.close()
    names.close()


def test_name_table_pruned(tmp_path):
    """A job first drops the names of no record at or right of its
    prune_below: names of records left of it get new keys, the others
    keep theirs, and the table holds no more than the names of the
    records it still covers."""
    bam = _write_bam(tmp_path / "a.bam", [("1", 40000)], 12)
    names = reads_intake.NameTable()
    h = reads_intake.IntakeHandle(bam)
    drop = FDUP | FQCFAIL | FSUPPLEMENTARY
    rd = open_bam(bam)
    (b1,) = reads_intake.IntakeJob([h], names, [0], 5000, 9000, 5000, 0,
                                   drop).blocks()
    first = {}
    for row, q in zip(b1.cols["row"].tolist(), b1.cols["qid"].tolist()):
        r = b1.arena.record(row)
        first[r.qname] = (q, max(r.pos, first.get(r.qname, (0, -1))[1]))
    (b2,) = reads_intake.IntakeJob([h], names, [0], 8500, 12500, 8500,
                                   7000, drop).blocks()
    second = {}
    for row, q in zip(b2.cols["row"].tolist(), b2.cols["qid"].tolist()):
        second[b2.arena.record(row).qname] = q
    kept = {n for n, (_, last) in first.items() if last >= 7000}
    assert kept and set(first) - kept
    for name, q in second.items():
        if name in kept:
            assert q == first[name][0]
        elif name in first:
            assert q != first[name][0]
    assert len(names) == len(kept | set(second))
    assert len(set(second.values())) == len(second)
    h.close()
    names.close()
    rd.close()


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ahead")
    fa, bam, wfs = _sim(tmp, 23, n_var=4, ref_len=31250)
    return tmp, fa, bam, wfs[0]


def _params(tmp, tag):
    p = Parameters()
    p.do_diploid = True
    p.file_name = str(tmp / tag)
    return p


def _engine(sim, kind, tag):
    tmp, fa, bam, _ = sim
    if kind == "batched":
        return BatchedWindowEngine([bam], fa, _params(tmp, tag),
                                   device="cpu", batch_windows=2,
                                   dtype=np.float32)
    return WindowEngine([bam], fa, _params(tmp, tag), hmm_backend="pallas",
                        device="cpu")


def _n_windows(sim):
    with open(sim[3]) as f:
        return sum(1 for line in f if line.strip())


@pytest.mark.parametrize("kind", ["batched", "streaming"])
def test_glf_equal_without_read_ahead(sim, monkeypatch, kind):
    """detect_indels writes the same GLF bytes when every window runs its
    intake itself (read_ahead switched off here) as with the read-ahead,
    which served every window but the first."""
    tmp, wf = sim[0], sim[3]
    eng = _engine(sim, kind, f"on_{kind}")
    eng.detect_indels(wf, str(tmp / f"on_{kind}.glf.txt"))
    eng.close()
    c = eng.stats.counts
    assert c["reads.ahead_used"] == _n_windows(sim) - 1 >= 2
    with monkeypatch.context() as m:
        m.setattr(reads.ReadBuffer, "read_ahead",
                  lambda self, *a, **k: None)
        off = _engine(sim, kind, f"off_{kind}")
        off.detect_indels(wf, str(tmp / f"off_{kind}.glf.txt"))
        off.close()
    assert "reads.ahead_used" not in off.stats.counts
    on_glf = (tmp / f"on_{kind}.glf.txt").read_bytes()
    assert on_glf == (tmp / f"off_{kind}.glf.txt").read_bytes()
    assert on_glf.count(b"\n") > 2


def test_error_window_counts(sim, monkeypatch):
    """With one window failing after its reads were taken, the window
    after it is reset: its read-ahead is discarded and the rest are
    used."""
    real = WindowEngine.get_haplotypes
    calls = []

    def failing(self, *a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise reads.WindowError("injected")
        return real(self, *a, **k)
    monkeypatch.setattr(WindowEngine, "get_haplotypes", failing)
    eng = _engine(sim, "batched", "err")
    eng.detect_indels(sim[3], str(sim[0] / "err.glf.txt"))
    eng.close()
    n = _n_windows(sim)
    assert n >= 3
    assert eng.stats.counts["reads.ahead_used"] == n - 2
    assert eng.stats.counts["reads.ahead_refetched"] == 1


class _Stop(BaseException):
    pass


@pytest.mark.parametrize("when", ["close", "stopped"])
def test_nothing_left_open(sim, monkeypatch, when):
    """After a pass and close(), and after a pass stopped from the read
    stage (as the benchmark's WindowClosed stops one), every job ahead
    was waited for and every intake handle and qname table is closed."""
    opened, jobs = [], []
    real_open = reads_intake.IntakeHandle.__init__
    real_job = reads_intake.IntakeJob.__init__

    def track(self, path):
        real_open(self, path)
        opened.append(self)

    def track_job(self, *a, **k):
        real_job(self, *a, **k)
        jobs.append(self)
    monkeypatch.setattr(reads_intake.IntakeHandle, "__init__", track)
    monkeypatch.setattr(reads_intake.IntakeJob, "__init__", track_job)
    eng = _engine(sim, "batched", f"open_{when}")
    if when == "stopped":
        stage = eng.stats.stage
        n = []

        def stopping(name):
            if name == "get_reads":
                n.append(1)
                if len(n) == 3:
                    raise _Stop()
            return stage(name)
        eng.stats.stage = stopping
        with pytest.raises(_Stop):
            eng.detect_indels(sim[3], str(sim[0] / "stop.glf.txt"))
        assert eng.stats.counts["reads.ahead_used"] == 1
    else:
        eng.detect_indels(sim[3], str(sim[0] / "close.glf.txt"))
        eng.close()
    assert opened and jobs
    assert all(h._h is None for h in opened)
    assert all(j._job is None for j in jobs)
    assert eng.buf._names is None and eng.buf._ahead is None
