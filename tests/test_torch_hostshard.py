"""dindel_tpu_torch's multi-process host staging (parallel/hostshard.py,
--stageProcs) on the CPU: N spawned staging processes ship packed slabs
to a device server in this process; the per-shard GLF files merge into
bytes identical to one process running the same window files in
sequence, the port's and, in float64, the JAX engine's
(tests/test_hostshard.py ties the JAX run_hostshard to the same
sequential run).  Every staging process must close with no slab rescued
and without having initialized CUDA.  A failure in the server must reach
the staging engine as a RuntimeError and rescue only its slab, on the
server; a rescue the server cannot run ends the run, and the staging
process never runs the DP itself."""

import json
import os
import socket
import tempfile

import numpy as np
import pytest
import torch

from dindel_tpu.config import Parameters as JaxParameters
from dindel_tpu.engine.batched import BatchedWindowEngine as JaxEngine
from dindel_tpu_torch import cli
from dindel_tpu_torch.config import Parameters
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.candidates import get_candidates
from dindel_tpu_torch.hmm import batch as hmm_batch
from dindel_tpu_torch.parallel.hostshard import (DeviceProxy, DeviceServer,
                                                 merge_glf, run_hostshard)
from dindel_tpu_torch.pipeline.windows import make_windows
from dindel_tpu_torch.sim import PlantedVariant, SimConfig, simulate

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The sim of tests/test_hostshard.py::test_hostshard_matches_sequential:
    eight indels in window files of three."""
    tmp = tmp_path_factory.mktemp("hostshard")
    variants = [PlantedVariant(pos=550 + i * 620,
                               var=("-AC", "+TG", "-T", "+A")[i % 4],
                               genotype=1 + i % 2)
                for i in range(8)]
    cfg = SimConfig(ref_len=560 + 8 * 620, coverage=15, read_len=70)
    fa, bam = simulate(str(tmp / "sim"), variants, cfg, seed=17)
    var_file, _ = get_candidates(bam, str(tmp / "cand"), fa)
    win_files = make_windows(var_file, str(tmp / "win"), variants_per_file=3)
    assert len(win_files) >= 2
    return tmp, fa, bam, win_files


def _params(cls, tmp, tag, mode):
    p = cls()
    p.do_diploid = mode in ("dip", "both")
    p.estimate_hap_freqs = mode in ("pooled", "both")
    p.file_name = str(tmp / tag)
    return p


def _sequential(eng, tmp, tag, win_files):
    """One engine over the window files in order, merged as run_hostshard
    merges its shards (one header)."""
    parts = [str(tmp / f"{tag}.glf.{i}") for i in range(len(win_files))]
    for wf, gp in zip(win_files, parts):
        eng.detect_indels(wf, gp)
    eng.close()
    # the JAX engine keeps its rescues in stage_seconds
    rescues = (eng.stats.counts.get("slab.rescues", 0)
               if isinstance(eng, BatchedWindowEngine)
               else eng.stats.stage_seconds.get("slab_rescues", 0))
    assert rescues == 0
    merge_glf(parts, str(tmp / f"{tag}.glf.txt"))
    return open(tmp / f"{tag}.glf.txt").read()


def _check_procs(per_proc):
    for st in per_proc:
        assert st["cuda_initialized"] is False
        assert st["counts"].get("slab.rescues", 0) == 0
        assert st["windows_ok"] > 0


def _check_children(stats, n_procs):
    assert len(stats["per_proc"]) == n_procs
    _check_procs(stats["per_proc"])
    assert stats["slab_rescues"] == 0
    assert stats["server"]["dispatches"] > 0


@pytest.mark.parametrize("mode", ["dip", "pooled"])
def test_hostshard_matches_sequential(sim, mode):
    """The shipped configuration (float32, fast ties, device folds in the
    server); the staging engines take the host EM, so the sequential
    anchor does too."""
    tmp, fa, bam, win_files = sim
    kw = dict(batch_windows=16, device="cpu")
    seq = _sequential(BatchedWindowEngine(
        [bam], fa, _params(Parameters, tmp, f"seq_{mode}", mode),
        device_em=False, **kw), tmp, f"seq_{mode}", win_files)
    out_glf = str(tmp / f"shard_{mode}.glf.txt")
    stats = {}
    shard_paths = run_hostshard(
        [bam], fa, _params(Parameters, tmp, f"shard_{mode}", mode),
        win_files, out_glf, n_procs=2, engine_kw=dict(batch_windows=16),
        stats_out=stats, device="cpu")
    assert len(shard_paths) == len(win_files)
    _check_children(stats, 2)
    got = open(out_glf).read()
    assert ("dip.map" if mode == "dip" else "singlevariant") in got
    assert got == seq


def test_hostshard_f64_matches_jax_sequential(sim):
    """float64, exact ties, both callers: byte-equal to the JAX batched
    engine running the same window files in one process."""
    tmp, fa, bam, win_files = sim
    want = _sequential(JaxEngine([bam], fa,
                                 _params(JaxParameters, tmp, "jseq", "both"),
                                 batch_windows=16, dtype=np.float64),
                       tmp, "jseq", win_files)
    out_glf = str(tmp / "shard64.glf.txt")
    stats = {}
    run_hostshard([bam], fa, _params(Parameters, tmp, "shard64", "both"),
                  win_files, out_glf, n_procs=2,
                  engine_kw=dict(batch_windows=16, dtype=np.float64,
                                 exact_ties=True),
                  stats_out=stats, device="cpu")
    _check_children(stats, 2)
    got = open(out_glf).read()
    assert "dip.map" in got and "singlevariant" in got
    assert got == want


def test_hostshard_cli_cpu(sim):
    """--stageProcs through the CLI (comma-separated --varFile): the merged
    GLF equals one engine's over the same files with the CLI's settings,
    and the staging processes' stats files beside it show no rescue and
    no CUDA."""
    tmp, fa, bam, win_files = sim
    out = str(tmp / "cli")
    assert cli.main(["--analysis", "indels", "--doDiploid", "--bamFile", bam,
                     "--ref", fa, "--varFile", ",".join(win_files),
                     "--outputFile", out, "--engine", "batched",
                     "--stageProcs", "2", "--device", "cpu"]) == 0
    _check_procs([json.load(open(f"{out}.glf.txt.err{s}.stats"))
                  for s in range(2)])
    seq = _sequential(BatchedWindowEngine(
        [bam], fa, _params(Parameters, tmp, "cliseq", "dip"), device="cpu",
        exact_ties=True), tmp, "cliseq", win_files)
    glf = open(out + ".glf.txt").read()
    assert glf.splitlines()[0].startswith("msg index")
    assert " dip " in glf or " dip.map " in glf
    assert glf == seq


@pytest.fixture
def server():
    path = tempfile.mktemp(prefix="dindel_dev_", suffix=".sock")
    srv = DeviceServer(path, "cpu")
    yield srv
    srv.close()
    assert not os.path.exists(path)


def test_server_failure_is_runtime_error(server):
    proxy = DeviceProxy(server.path)
    try:
        h = proxy.dispatch("no-such-kind", {})
        with pytest.raises(RuntimeError, match="remote slab program failed"):
            proxy.fetch_pytrees([h])
    finally:
        proxy.close()


def _remote_engine_with_faults(sim, server, monkeypatch, fails):
    """A staging engine (one window per slab) on `server`, whose n-th
    program (from 1) raises where fails(n); the staging process's own DP
    route raises if it is ever taken.  Returns (engine, kinds of the
    programs the server ran, (pytrees, error) of every fetch that
    raised, the proxy, the window file)."""
    tmp, fa, bam, win_files = sim
    run = DeviceServer._run
    calls = []

    def failing(self, kind, payload):
        calls.append(kind)
        if fails(len(calls)):
            raise RuntimeError("injected device fault")
        return run(self, kind, payload)
    monkeypatch.setattr(DeviceServer, "_run", failing)

    def local_dp(*args, **kw):
        raise AssertionError("the staging process ran the DP")
    monkeypatch.setattr(hmm_batch, "run_packed", local_dp)
    fetches = []
    fetch = DeviceProxy.fetch_pytrees

    def spy(self, objs):
        try:
            return fetch(self, objs)
        except RuntimeError as e:
            fetches.append((len(objs), str(e)))
            raise
    monkeypatch.setattr(DeviceProxy, "fetch_pytrees", spy)
    proxy = DeviceProxy(server.path)
    eng = BatchedWindowEngine(
        [bam], fa, _params(Parameters, tmp, "fault", "dip"),
        device="cpu", remote=proxy, max_pairs_per_slab=1)
    return eng, calls, fetches, proxy, win_files[0]


def test_server_failure_rescues_only_its_slab(sim, server, monkeypatch):
    """The server's second slab program raises: the staging engine's
    combined fetch raises RuntimeError, each slab is fetched again on its
    own, and only the failing slab is rescued, as one dense program per
    window on the server (never on the staging process's CPU); its
    windows still get rows."""
    tmp = sim[0]
    eng, calls, fetches, proxy, wf = _remote_engine_with_faults(
        sim, server, monkeypatch, lambda n: n == 2)
    try:
        eng.detect_indels(wf, str(tmp / "fault.glf.txt"))
        eng.close()
    finally:
        proxy.close()
    slabs = [k for k in calls if k != "dense"]
    assert len(slabs) >= 3
    # the failing slab's one window, re-scored on the server
    assert calls.count("dense") == 1
    assert eng.stats.counts.get("slab.rescues") == 1
    # the combined fetch, then the failing slab alone
    assert [n for n, _ in fetches] == [len(slabs), 1]
    assert all("injected device fault" in e for _, e in fetches)
    assert eng.stats.windows_ok == len(slabs)
    assert server.stats["dispatches"] == len(calls)


@pytest.mark.parametrize("lost", [False, True])
def test_server_failure_during_rescue_ends_run(sim, server, monkeypatch,
                                               lost):
    """Every program of the server past the first raises, or the server
    is gone by the time the rescue dispatches: the rescued window cannot
    reach the device, and the run ends instead of scoring it on the
    staging process's CPU."""
    tmp = sim[0]
    eng, calls, fetches, proxy, wf = _remote_engine_with_faults(
        sim, server, monkeypatch, lambda n: n >= 2)
    if lost:
        # the server drops every connection when the first fetch arrives
        fetch_ids = DeviceProxy._fetch_ids

        def drop(self, rids):
            self._sock.shutdown(socket.SHUT_RDWR)
            return fetch_ids(self, rids)
        monkeypatch.setattr(DeviceProxy, "_fetch_ids", drop)
    try:
        with pytest.raises((RuntimeError, OSError)):
            eng.detect_indels(wf, str(tmp / "fault_end.glf.txt"))
    finally:
        eng.close()
        proxy.close()
    assert eng.stats.counts.get("slab.rescues") == 1
    assert eng.stats.windows_ok == 0
    if not lost:
        assert calls[-1] == "dense"
        assert fetches[-1][0] == 1
