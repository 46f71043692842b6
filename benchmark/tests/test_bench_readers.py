"""The per-layer readers on a small recorded trace: a 1 s window with
two K1 launches, a finish, a copy, and layer spans on two threads."""

import pytest

from benchmark import spec, tracing


class FakeLaunches:
    def bounds(self):
        return [("pair_hmm_dp", 0.05), ("pair_hmm_dp", 0.05),
                ("finish", 0.01)]


def ev(name, ts, dur, cat="", tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid}


EVENTS = [
    ev("benchmark.window", 1000.0, 2e6, "user_annotation"),
    ev("layer.get_reads", 1000.0, 300000.0, "user_annotation"),
    ev("layer.hapgen", 301000.0, 400000.0, "user_annotation"),
    ev("layer.calling", 701000.0, 100000.0, "user_annotation", tid=2),
    ev("void pair_hmm_dp_warp<float, false>(int const*)", 350000.0, 200.0,
       "kernel"),
    ev("void pair_hmm_dp_warp<float, false>(int const*)", 360000.0, 200.0,
       "kernel"),
    ev("void finish_kernel<float>(int const*)", 370000.0, 50.0, "kernel"),
    ev("Memcpy HtoD (Pageable -> Device)", 380000.0, 50.0, "gpu_memcpy"),
    ev("aten::add", 380000.0, 10.0, "cpu_op"),
]


@pytest.fixture(scope="module")
def record():
    rec = tracing.reduce(EVENTS, 1.0, FakeLaunches())
    rec.update(windows=10, stage_s={"get_reads": 0.3, "hapgen": 0.4,
                                    "calling": 0.1, "slab_fetch": 0.05})
    return rec


def test_reduce(record):
    assert record["busy_s"] == pytest.approx(500e-6)
    k1 = record["kernels"]["pair_hmm_dp"]
    assert k1["device_s"] == pytest.approx(400e-6)
    assert k1["bound_s"] == pytest.approx(100e-6)
    ops = dict(record["breakdown"]["device_ops"])
    assert ops["pair_hmm_dp_warp"] == pytest.approx(400e-6)
    idle = dict(record["breakdown"]["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(1.0 - 500e-6)
    assert idle["layer.hapgen"] == pytest.approx(0.4 - 500e-6)
    assert idle["worker.layer.calling"] == pytest.approx(0.1)


@pytest.mark.parametrize("name,value", [
    ("reads.ms_per_window", 30.0),
    ("hapgen.ms_per_window", 40.0),
    ("calling.ms_per_window", 15.0),
    ("k1.roofline_pct", 25.0),
    ("epilogue.roofline_pct", 20.0),
    ("device.idle_pct", 100.0 * (1 - 500e-6)),
])
def test_reader(record, name, value):
    assert spec.reader(name)(record) == pytest.approx(value)


@pytest.mark.parametrize("name", ["pack.ms_per_window",
                                  "dispatch.ms_per_window",
                                  "window_hmm.ms_per_window",
                                  "host.windows_per_s"])
def test_reader_finds_nothing(record, name):
    assert spec.reader(name)(record) is None


def test_host_rate_reader():
    rec = dict(windows=10, stage_s={}, windows_per_s=93.5)
    assert spec.reader("host.windows_per_s")(rec) == pytest.approx(93.5)


def test_device_busy_counts_every_device_op_once():
    """The untraced run's busy time: the union of kernel, copy and memset
    intervals wherever they lie (no window clips them); host ops and
    annotations do not count, overlaps count once."""
    events = EVENTS + [
        ev("void finish_kernel<float>(int const*)", 370020.0, 100.0,
           "kernel"),
        ev("Memset (Device)", 5e6, 30.0, "gpu_memset"),
    ]
    assert tracing.device_busy_s(events) == pytest.approx(
        (200.0 + 200.0 + 120.0 + 50.0 + 30.0) * 1e-6)
    assert tracing.device_busy_s(EVENTS[:4]) == 0.0


def test_roofline_readers_silent_without_kernels():
    rec = tracing.reduce(EVENTS[:4], 1.0, FakeLaunches())
    assert spec.reader("k1.roofline_pct")(rec) is None
    assert spec.reader("epilogue.roofline_pct")(rec) is None


COUNTS = {"reads.records_fetched": 20000, "reads.kept": 1000,
          "hapgen.haps_generated": 400, "hapgen.haps_kept": 399,
          "reads.ahead_used": 98, "reads.ahead_refetched": 2}
COUNTERS = [("reads.used_pct", 5.0), ("hapgen.kept_pct", 99.75),
            ("reads.ahead_hit_pct", 98.0)]


@pytest.mark.parametrize("name,value", COUNTERS + [
    ("reads.ahead_ms_per_window", 3.0)])
def test_counter_readers(name, value):
    rec = dict(windows=10, counts=COUNTS,
               stage_s={"get_reads.ahead": 0.03})
    assert spec.reader(name)(rec) == pytest.approx(value)


@pytest.mark.parametrize("name", [n for n, _ in COUNTERS])
def test_counter_readers_silent(name):
    """No counters (a program without them), a zero base, or a counter
    missing: no value."""
    assert spec.reader(name)(dict(windows=10, stage_s={})) is None
    assert spec.reader(name)(dict(windows=10, stage_s={}, counts={})) is None
    zero = {k: 0 for k in COUNTS}
    assert spec.reader(name)(dict(windows=10, counts=zero)) is None
    base = {"reads.used_pct": "reads.kept",
            "hapgen.kept_pct": "hapgen.haps_kept",
            "reads.ahead_hit_pct": "reads.ahead_used"}[name]
    less = {k: v for k, v in COUNTS.items() if k != base}
    assert spec.reader(name)(dict(windows=10, counts=less)) is None


def test_a_refetch_is_counted_only_when_it_happens():
    rec = dict(windows=10, counts={"reads.ahead_used": 50})
    assert spec.reader("reads.ahead_hit_pct")(rec) == pytest.approx(100.0)


def test_traced_rehearsal_record(capsys, monkeypatch):
    """A traced run on the CPU: the counters of the window reach the
    record, the four readers read them, and each stage is one span (the
    program's own), never one inside another of its name."""
    import json
    from benchmark import run
    seen = {}
    real = tracing.reduce

    def reduce(events, *a):
        seen["events"] = events
        seen["record"] = real(events, *a)
        return seen["record"]
    monkeypatch.setattr(tracing, "reduce", reduce)
    rc = run.main(["--workload", "dip30x-batched.isolated", "--seed", "41",
                   "--seconds", "8", "--trace", "1", "--cpu-rehearsal", "3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out
    rec = seen["record"]
    assert rec["counts"]["reads.kept"] > 0
    got = {n: spec.reader(n)(rec) for n in (
        "reads.used_pct", "hapgen.kept_pct", "reads.ahead_hit_pct",
        "reads.ahead_ms_per_window")}
    assert 0 < got["reads.used_pct"] < 100, got
    assert 0 < got["hapgen.kept_pct"] <= 100, got
    assert 0 < got["reads.ahead_hit_pct"] <= 100, got
    assert got["reads.ahead_ms_per_window"] > 0, got
    spans = {}
    for e in seen["events"]:
        if e.get("ph") == "X" and str(e.get("name")).startswith("layer."):
            spans.setdefault((e["tid"], e["name"]), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert any(n == "layer.get_reads" for _, n in spans)
    for iv in spans.values():
        iv.sort()
        for (a0, a1), (b0, b1) in zip(iv, iv[1:]):
            assert b0 >= a1, "a span inside another of its name"
