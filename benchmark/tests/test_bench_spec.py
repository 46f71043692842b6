"""BENCHMARK.json holds to the benchmark's contract, and the harness
finds every configuration, mix and reader by name."""

import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"_dim$|_rank$|expansion|per_tok)")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for w in bench["command"][1:]:
        assert not w.startswith("/") and ".." not in w
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
        cfg = spec.config(bench, c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])
    assert len({c["source"] for c in bench["configs"]}) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    assert used == names


def test_workloads(bench):
    seen, pairs = set(), set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        seen.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
        spec.traffic(w["traffic"])
    assert 1 <= len(seen) <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(seen) // 4)


def test_metrics(bench):
    names = set()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        layers.add(m["layer"])
        spec.reader(m["name"])
        if m["name"].endswith("_roofline") or m["unit"] == "%":
            assert m["unit"] == "%"
    for c in cells:
        assert spec.metrics_of(bench, c, True), c
        assert len(spec.metrics_of(bench, c, False)) >= 2


def test_paths_hold_only_the_benchmark(bench):
    for p in bench["paths"]:
        root = spec.ROOT / p
        assert root.is_dir()
        for f in root.rglob("*"):
            rel = f.relative_to(spec.ROOT).as_posix()
            if "__pycache__" in rel or f.is_dir():
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_each_piece_found_by_name(bench):
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        for k in ("cli", "sequencing", "limits", "warmup_windows",
                  "burst_gap_s", "check_windows"):
            assert k in cfg, (c["name"], k)
    with pytest.raises(spec.SpecError):
        spec.traffic("no-such-mix")
    with pytest.raises(spec.SpecError):
        spec.reader("no.such_metric")
    with pytest.raises(spec.SpecError):
        spec.cell(bench, "no-such-cell")
