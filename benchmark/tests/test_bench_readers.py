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
                                  "window_hmm.ms_per_window"])
def test_reader_finds_nothing(record, name):
    assert spec.reader(name)(record) is None


def test_roofline_readers_silent_without_kernels():
    rec = tracing.reduce(EVENTS[:4], 1.0, FakeLaunches())
    assert spec.reader("k1.roofline_pct")(rec) is None
    assert spec.reader("epilogue.roofline_pct")(rec) is None
