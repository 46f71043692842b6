"""What a run is, found by name: the cell in BENCHMARK.json, its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), the plain reference its configuration names
(reference/<name>.py, default `caller`) and its per-layer metrics (one
reader each in metrics/<metric>.py).  Adding a cell, a mix, a reference
or a metric adds files and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(Exception):
    """BENCHMARK.json, a configuration, a mix or a reader is missing or
    malformed."""


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"{path} is missing")


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise SpecError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def metrics_of(bench: dict, workload: str, trace: bool):
    """The cell's metrics: its end-to-end metrics untraced, its per-layer
    metrics traced (those whose `workloads` list names the cell, or that
    have no list)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """metrics/<name>.py's read(record) -> float or None."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(name: str):
    """The module benchmark/reference/<name>.py, whose
    glf_rows(fasta, bams, window_lines, flags, device=..., dtype=...)
    gives {window index: its GLF rows} for the configuration's
    `dindel_flags`."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise SpecError(f"no reference {name!r}: a module name is needed")
    try:
        return importlib.import_module("benchmark.reference." + name)
    except ModuleNotFoundError as e:
        if e.name != "benchmark.reference." + name:
            raise
        raise SpecError(f"no reference module {HERE / 'reference' / name}.py")
