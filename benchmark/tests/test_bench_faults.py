"""A whole run on the CPU (the harness's look for a card skipped), with
the timed path broken underneath: `correct` has to come out false for
each fault a cell can have, and true when nothing is broken.  (One card
per cell: no exchange between cards to leave out.)"""

import json

import numpy as np
import pytest
import torch

from benchmark import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(capsys, cell, seed=31):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "8", "--trace", "0", "--cpu-rehearsal", "3"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _skip_odd_windows(monkeypatch):
    """Half of each batch left out: odd windows' calls write no rows."""
    from dindel_tpu_torch.engine import batched, window
    # the window index is the tenth argument of diploid_glf_dev and the
    # eighth of diploid_glf
    for mod, name, at in ((batched, "diploid_glf_dev", 9),
                          (window, "diploid_glf", 7)):
        real = getattr(mod, name)

        def half(*a, _real=real, _at=at, **kw):
            return [] if a[_at] % 2 else _real(*a, **kw)
        monkeypatch.setattr(mod, name, half)


def _alter_answers(monkeypatch):
    """Each GLF row's first genotype likelihood moved by 0.5 as it is
    written."""
    from dindel_tpu_torch.out import glf
    real = glf.OutputData.output

    def altered(self, line):
        i = self.label_to_column["glf"]
        g = line.data[i]
        if g != "NA":
            head, _, rest = g.partition(":")
            num, sep, tail = rest.partition(",")
            line.data[i] = f"{head}:{float(num) + 0.5:g}{sep}{tail}"
        return real(self, line)
    monkeypatch.setattr(glf.OutputData, "output", altered)


def _state_unchanged(monkeypatch):
    """The DP returns its starting state: zero messages, no backpointer
    moves."""
    from dindel_tpu_torch.hmm import slab
    real = slab.pair_hmm_dp

    def unchanged(*a, **kw):
        return tuple(torch.zeros_like(t) for t in real(*a, **kw))
    monkeypatch.setattr(slab, "pair_hmm_dp", unchanged)


def _count_off_by_one(monkeypatch):
    """K3 (pair_stats) returns each pair's count of mismatches at
    high-quality bases (nmmBQT) one too high."""
    from dindel_tpu_torch.hmm import slab
    real = slab.pair_stats

    def off(*a, **kw):
        out = list(real(*a, **kw))
        out[3] = out[3] + 1
        return tuple(out)
    monkeypatch.setattr(slab, "pair_stats", off)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(capsys, cell):
    out = _run(capsys, cell)
    assert out["correct"], out
    assert out["device"]["platform"] == "cpu"
    assert all(m["value"] is None for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_skip_odd_windows, _alter_answers,
                                   _state_unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(capsys, cell)
    assert not out["correct"], out


def test_count_fault_is_caught(capsys, monkeypatch):
    # the batched cells compare the counts exactly: a count that K3 gets
    # wrong fails the run though every likelihood is right
    _count_off_by_one(monkeypatch)
    out = _run(capsys, "dip30x-batched.isolated")
    assert not out["correct"], out
    assert out["checks"]["counts_differ"]["value"] > 0
    assert out["checks"]["value_gap"]["value"] <= out["checks"][
        "value_gap"]["limit"]
