"""The readers of the host-staging sub-stages and the main thread's wait
on the finish worker, and the idle time of a trace whose layer spans
nest sub-stage spans (as the program opens them)."""

import pytest

from benchmark import spec, tracing

STAGE_S = {"get_reads": 0.5, "get_reads.fetch": 0.2,
           "get_reads.buffer": 0.1, "get_reads.cascade": 0.15,
           "hapgen": 0.4, "hapgen.hapdist": 0.1, "hapgen.generate": 0.05,
           "hapgen.align": 0.2, "batch_wait": 0.03}
READERS = [("reads.fetch_ms_per_window", 20.0),
           ("reads.cascade_ms_per_window", 15.0),
           ("hapgen.hapdist_ms_per_window", 10.0),
           ("hapgen.align_ms_per_window", 20.0),
           ("pipeline.wait_ms_per_window", 3.0)]


@pytest.mark.parametrize("name,value", READERS)
def test_reader(name, value):
    rec = dict(windows=10, stage_s=STAGE_S)
    assert spec.reader(name)(rec) == pytest.approx(value)


@pytest.mark.parametrize("name", [n for n, _ in READERS])
def test_reader_silent_without_stage(name):
    """A program without the sub-stages (the parent of the change that
    added them) gives no value, and no window gives none either."""
    parent = {k: v for k, v in STAGE_S.items() if k in ("get_reads", "hapgen")}
    assert spec.reader(name)(dict(windows=10, stage_s=parent)) is None
    assert spec.reader(name)(dict(windows=0, stage_s=STAGE_S)) is None


def ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid}


def test_idle_gaps_name_the_innermost_sub_stage():
    """Each span once (the program's own), the sub-stage inside its
    layer: the idle time goes to the sub-stage, the bare layer keeps
    what its sub-stages leave, and batch_wait on the main thread is
    named."""
    spans = [ev(name, ts, dur) for name, ts, dur in (
        ("layer.get_reads", 0.0, 500000.0),
        ("layer.get_reads.fetch", 100000.0, 200000.0),
        ("layer.batch_wait", 600000.0, 100000.0))]
    events = [ev("benchmark.window", 0.0, 1e6)] + spans + [
        ev("void pair_hmm_dp_warp<float, false>(int const*)", 900000.0,
           100000.0, "kernel")]

    class NoLaunches:
        def bounds(self):
            return []
    idle = dict(tracing.reduce(events, 1.0, NoLaunches())
                ["breakdown"]["idle_gaps"])
    assert idle["layer.get_reads.fetch"] == pytest.approx(0.2)
    assert idle["layer.get_reads"] == pytest.approx(0.3)
    assert idle["layer.batch_wait"] == pytest.approx(0.1)
    assert idle["host.other"] == pytest.approx(0.3)
