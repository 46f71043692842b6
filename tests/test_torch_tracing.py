"""The port's own instrumentation (engine/stats.py RunStats): profiler
spans opened by the program's stages, the host-staging sub-stages of
get_reads and hapgen, the work counters, the main thread's wait on the
finish worker, and error windows counted when their GLF row is
written."""

import json

import numpy as np
import pytest
import torch

from dindel_tpu_torch.config import Parameters
from dindel_tpu_torch.engine import batched, reads, window
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.reads import WindowError
from dindel_tpu_torch.engine.stats import RunStats
from dindel_tpu_torch.engine.window import WindowEngine
from test_device_call import _sim
from test_torch_engine import no_slab_rescues  # noqa: F401 (autouse)

torch.set_num_threads(1)

SUB_STAGES = {"get_reads": ("get_reads.fetch", "get_reads.buffer",
                            "get_reads.cascade"),
              "hapgen": ("hapgen.hapdist", "hapgen.generate",
                         "hapgen.align")}


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracing")
    # sites 6250 bp apart, as in a genome: each window's fetch
    # (maxInsertSize 2000 bp and 200 bp on the left) shares no read with
    # the previous window's
    fa, bam, wfs = _sim(tmp, 21, n_var=3, ref_len=31250)
    return tmp, fa, bam, wfs[0]


def _params(tmp, tag):
    p = Parameters()
    p.do_diploid = True
    p.file_name = str(tmp / tag)
    return p


def _batched(sim, tag):
    tmp, fa, bam, _ = sim
    # two windows a batch: several batches, so the main thread waits on
    # the finish worker more than once
    return BatchedWindowEngine([bam], fa, _params(tmp, tag), device="cpu",
                               batch_windows=2, dtype=np.float32)


def _streaming(sim, tag):
    tmp, fa, bam, _ = sim
    return WindowEngine([bam], fa, _params(tmp, tag), hmm_backend="pallas",
                        device="cpu")


def _run(eng, sim, tag):
    tmp, wf = sim[0], sim[3]
    glf = tmp / f"{tag}.glf.txt"
    eng.detect_indels(wf, str(glf))
    eng.close()
    return glf.read_text()


def test_spans_under_profiler(sim):
    """Every stage is a layer.<stage> span; each sub-stage lies inside
    its layer's span on the same thread; batch_wait, get_reads and its
    sub-stages are on the thread that drives the engine; the read-ahead's
    native thread adds get_reads.ahead seconds and opens no span."""
    eng = _batched(sim, "spans")
    path = sim[0] / "spans.trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.main"):
            _run(eng, sim, "spans")
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    main_tid = next(e["tid"] for e in events if e["name"] == "test.main")
    spans = {}
    for e in events:
        if str(e["name"]).startswith("layer."):
            spans.setdefault(e["name"][len("layer."):], []).append(e)
    for layer, subs in SUB_STAGES.items():
        assert layer in spans
        for sub in subs:
            assert spans.get(sub), f"no span layer.{sub}"
            for s in spans[sub]:
                assert any(p["tid"] == s["tid"] and p["ts"] <= s["ts"]
                           and s["ts"] + s["dur"] <= p["ts"] + p["dur"]
                           for p in spans[layer]), (sub, s)
    assert len(spans["batch_wait"]) >= 2
    assert {s["tid"] for s in spans["batch_wait"]} == {main_tid}
    for name in ("get_reads",) + SUB_STAGES["get_reads"]:
        assert {s["tid"] for s in spans[name]} == {main_tid}, name
    # the read-ahead's intake runs on a native thread: seconds, no span
    assert "get_reads.ahead" not in spans
    assert eng.stats.stage_seconds["get_reads.ahead"] > 0


def test_no_span_without_profiler(sim, monkeypatch):
    """With no profiler recording, a stage opens no record_function."""
    opened = []
    real = torch.profiler.record_function

    class Counted(real):
        def __init__(self, name, *a, **k):
            opened.append(name)
            super().__init__(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    eng = _batched(sim, "nospan")
    _run(eng, sim, "nospan")
    assert eng.stats.stage_seconds["get_reads.fetch"] > 0
    assert opened == []
    # the patched name is the one a stage opens under a profiler
    stats = RunStats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with stats.stage("probe"):
            pass
    assert opened == ["layer.probe"]


@pytest.mark.parametrize("make", [_batched, _streaming],
                         ids=["batched", "streaming"])
def test_counts_per_window(sim, monkeypatch, make):
    """Per window: reads.kept is the reads get_reads returned, at most
    the records fetched; hapgen.haps_kept is the haplotypes returned, at
    most those generated; no sub-stage outlasts its layer."""
    fetches, hapgens = [], []

    def delta(before, after):
        return {k: after.get(k, 0) - before.get(k, 0) for k in after}

    def spy_reads(*a, stats=None, **k):
        c0 = dict(stats.counts)
        out = reads.get_reads(*a, stats=stats, **k)
        fetches.append((delta(c0, stats.counts), len(out)))
        return out
    monkeypatch.setattr(batched, "get_reads", spy_reads)
    monkeypatch.setattr(window, "get_reads", spy_reads)
    real_haps = WindowEngine.get_haplotypes

    def spy_haps(self, *a, **k):
        c0 = dict(self.stats.counts)
        out = real_haps(self, *a, **k)
        hapgens.append((delta(c0, self.stats.counts), out[0], len(out[1])))
        return out
    monkeypatch.setattr(WindowEngine, "get_haplotypes", spy_haps)

    eng = make(sim, "counts")
    _run(eng, sim, "counts")
    assert len(fetches) >= 3 and len(hapgens) >= 3
    for d, n in fetches:
        assert d["reads.kept"] == n
        assert d["reads.records_fetched"] >= n
    kept = [(d, n) for d, skip, n in hapgens if not skip]
    assert kept
    for d, n in kept:
        assert d["hapgen.haps_kept"] == n
        assert d["hapgen.haps_generated"] >= n
    c = eng.stats.counts
    assert c["reads.kept"] == sum(n for _, n in fetches)
    st = eng.stats.stage_seconds
    for layer, subs in SUB_STAGES.items():
        assert 0 < sum(st[s] for s in subs) <= st[layer]


@pytest.mark.parametrize("where", ["staging", "calling"])
def test_error_window_counted_once_when_written(sim, monkeypatch, where):
    """A window that errors, while staged or while called, is counted
    once, as its GLF row is written (not when it is staged)."""
    if where == "staging":
        real = WindowEngine.get_haplotypes
        calls = []

        def failing(self, *a, **k):
            calls.append(1)
            if len(calls) == 2:
                raise WindowError("injected")
            return real(self, *a, **k)
        monkeypatch.setattr(WindowEngine, "get_haplotypes", failing)
    else:
        real = BatchedWindowEngine._call_window
        calls = []

        def failing(self, *a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise WindowError("injected")
            return real(self, *a, **k)
        monkeypatch.setattr(BatchedWindowEngine, "_call_window", failing)
    written = []
    real_row = BatchedWindowEngine._error_row

    def row(self, glf_data, e, msg):
        before = self.stats.windows_error
        real_row(self, glf_data, e, msg)
        written.append((before, self.stats.windows_error))
    monkeypatch.setattr(BatchedWindowEngine, "_error_row", row)
    eng = _batched(sim, f"err_{where}")
    glf = _run(eng, sim, f"err_{where}")
    assert glf.count("error_injected") == 1
    assert eng.stats.error_messages.get("error_injected") == 1
    n_err = sum(line.startswith("error_") for line in glf.splitlines())
    assert eng.stats.windows_error == n_err == len(written)
    assert written == [(k, k + 1) for k in range(len(written))]
    assert eng.stats.windows_ok >= 2


def test_read_ahead_counts_add_up(sim):
    """The read-ahead's counters and its stage, timed on its native
    thread and added from the main thread, add up: every window but the
    first takes its intake from the job ahead, and the main thread's
    wait for it stays inside get_reads.fetch."""
    eng = _batched(sim, "ahead")
    _run(eng, sim, "ahead")
    c, st = eng.stats.counts, eng.stats.stage_seconds
    n = eng.stats.windows_total
    assert n >= 3
    assert c["reads.ahead_used"] + c.get("reads.ahead_refetched", 0) \
        == n - 1
    assert c["reads.ahead_used"] == n - 1
    assert st["get_reads.ahead"] > 0
    assert st["get_reads.fetch"] <= st["get_reads"]


def test_counts_and_stages_from_threads_lose_nothing():
    """The finish worker and the main thread count and time stages (and
    add a native thread's seconds) on one RunStats: with more threads
    than cores and a short switch interval, no increment is lost."""
    import sys
    import threading

    stats = RunStats()
    n_threads, n = 32, 500

    def work():
        for _ in range(n):
            stats.count("c", 1)
            stats.add_seconds("a", 1.0)
            with stats.stage("s"):
                pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert stats.counts == {"c": n_threads * n}
    assert stats.stage_seconds["s"] > 0
    assert stats.stage_seconds["a"] == n_threads * n
