"""The precision control fails each configuration's limits at a size a
test run can hold (on the card it runs at the cell's size:
benchmark/control.py)."""

import json

import pytest

from benchmark import check, control, spec


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_control_fails(cell):
    bench = spec.benchmark()
    w = spec.cell(bench, cell)
    cfg = spec.config(bench, w["config"])
    # six windows: the float32 control moves a few rows of a dozen on the
    # card, and three windows can miss them all
    traffic = dict(spec.traffic(w["traffic"]), sites=6)
    nums = control.one_seed(dict(cfg, check_windows=6), traffic, 77, "cpu")
    assert nums["compared"] == 6
    assert not check.verdict(nums, cfg["limits"])[0], nums
