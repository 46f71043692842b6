"""The port's measurement harness (bench_torch.py, tools/bench_windows_torch.py,
tools/profile_host_torch.py) rehearsed on the CPU at a tiny size.

Every script runs in a subprocess with `--device cpu` on 4 planted indels
at 10x with 2 warm passes, on one torch thread; the runs start together
and the tests read their records.  A CPU record names the CPU and leaves
every time and rate null while its counts stay filled; the C++ baseline
is measured from native/refshim/ref_hmm all the same (it runs on the
host's core).  Without a card, `--device cuda` is refused by every
script.  The op counts of tools/profile_host_torch.py repeat exactly
across two runs."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import bench_windows_torch as bw  # noqa: E402

SMALL = ["--n-variants", "4", "--coverage", "10"]
SCRIPTS = {"bench_torch": REPO / "bench_torch.py",
           "bench_windows_torch": REPO / "tools" / "bench_windows_torch.py",
           "profile_host_torch": REPO / "tools" / "profile_host_torch.py"}
MODES = ("pooled", "streaming", "hostshard")
TIMEOUT = 600


def _env():
    # one torch thread per process: the runs share the host with the other
    # test workers
    return dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every CPU rehearsal at once; {name: (rc, stdout, stderr)}."""
    d = tmp_path_factory.mktemp("bench")
    data = d / "data"
    bw.prepare_dataset(data, 4, 10)
    cmds = {
        "bench_torch": [SCRIPTS["bench_torch"], "--device", "cpu",
                        "--modes", "dip", "--repeats", "2", "--dp-reads",
                        "2", *SMALL],
        "profile_0": [SCRIPTS["profile_host_torch"], "--device", "cpu",
                      "--data", data, *SMALL],
        "profile_1": [SCRIPTS["profile_host_torch"], "--device", "cpu",
                      "--data", data, *SMALL],
    }
    for mode in MODES:
        cmds[mode] = [SCRIPTS["bench_windows_torch"], "--device", "cpu",
                      "--mode", mode, "--repeats", "2", "--stage-procs", "2",
                      "--data", data, *SMALL]
    procs = {}
    try:
        for name, cmd in cmds.items():
            procs[name] = subprocess.Popen(
                [sys.executable, *map(str, cmd)], cwd=d, env=_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out = {}
        for name, p in procs.items():
            so, se = p.communicate(timeout=TIMEOUT)
            out[name] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def record(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, se[-3000:]
    return json.loads(so.strip().splitlines()[-1])


def check_windows_record(rec, mode):
    assert rec["metric"] == "windows_per_sec" and rec["mode"] == mode
    assert rec["device"] == {"platform": "cpu"}
    assert rec["windows_ok"] > 0 and rec["windows_error"] >= 0
    assert rec["repeats"] == 2 and len(rec["windows_ok_per_pass"]) == 3
    assert rec["slab_rescues"] == 0
    assert isinstance(rec["k1_launches"], int)
    for key in ("windows_per_sec", "cold_windows_per_sec",
                "warm_last_windows_per_sec", "warm_wall_s", "cold_wall_s",
                "peak_device_memory_bytes", "kernel_build_s", "dataset_s"):
        assert rec[key] is None, key
    assert rec.get("stage_seconds") is None
    if mode == "hostshard":
        assert rec["stage_procs"] == 2 and rec["window_files"] >= 1
        assert rec["server_slab_programs"] > 0
        assert rec["server_enqueue_s"] is None


def test_bench_torch_record(runs):
    rec = record(runs, "bench_torch")
    assert rec["metric"] == "bench_torch"
    assert rec["device"] == {"platform": "cpu"}
    assert rec["failed_modes"] == []
    check_windows_record(rec["modes"]["dip"], "dip")
    assert rec["windows_per_sec"] == {"dip": None}
    assert rec["peak_device_memory_bytes"] == {"dip": None}
    cells = {"C1_fast", "C1_exact", "C2_fast", "C2_exact"}
    for key in ("dp_kernel_cells_per_sec", "pairhmm_cells_per_sec",
                "pairhmm_host_cells_per_sec"):
        assert rec[key] == dict.fromkeys(cells), key
    for k, b in rec["k1_bound"].items():
        assert b["bound_ms"] is None and b["share"] is None, k
        assert b["bound_by"] in ("bytes", "operations"), k
    for k, v in rec["dp_kernel"].items():
        # counts stay filled: C1 one window, C2 four, of 8 haps x 2 reads
        n = 1 if k.startswith("C1") else 4
        assert v["cells"] == n * 8 * 2 * 100 * 2 * 162 * 7, k
        assert v["ms"] is None and v["cells_per_sec"] is None, k
    # the C++ baseline is the host's, measured from the tracked binary
    assert rec["baseline_error"] is None
    assert rec["baseline_cells_per_sec"] > 0
    assert len(rec["baseline_runs_s"]) == 5
    assert rec["vs_baseline"] is None and rec["kernel_build_s"] is None
    assert set(rec["units"]) >= {"windows_per_sec", "dp_kernel_cells_per_sec",
                                 "pairhmm_cells_per_sec",
                                 "baseline_cells_per_sec", "vs_baseline"}


@pytest.mark.parametrize("mode", MODES)
def test_bench_windows_mode_record(runs, mode):
    check_windows_record(record(runs, mode), mode)


def test_profile_op_counts_repeat(runs):
    a, b = record(runs, "profile_0"), record(runs, "profile_1")
    assert a["op_counts"] == b["op_counts"]
    assert a["device"] == {"platform": "cpu"}
    assert a["device_busy_share"] == "not measured"
    assert a["warm_pass_cprofile_s"] is None and a["windows_ok"] > 0
    assert set(a["loops"]) == {"finish.fold", "finish.btf", "finish.btb",
                               "stats.m_log_bq", "stats.n_ind",
                               "stats.variants", "window_call.reads"}
    slab = a["op_counts"]["slab_program"]
    # the shipped fast fold takes the argmax, not the exact fold's loop
    assert slab["exact_ties"] is False and slab["groups"]["finish.fold"] == 0
    reached = ("finish.btf", "finish.btb", "stats.m_log_bq", "stats.n_ind",
               "stats.variants", "window_call.reads", "expand", "dp")
    assert all(slab["groups"][g] > 0 for g in reached), slab["groups"]
    assert slab["total"] == sum(slab["groups"].values())
    win = a["op_counts"]["streaming_window"]
    assert all(win["groups"][g] > 0 for g in ("finish.fold", "finish.btf",
                                              "finish.btb", "dp"))
    assert win["groups"]["expand"] == 0 and win["groups"]["stats.n_ind"] == 0
    assert win["total"] == sum(win["groups"].values())


def test_spread():
    s = bw.spread([4.0, 1.0, 3.0, 2.0])
    assert s == {"median": 2.5, "min": 1.0, "max": 4.0, "iqr": 1.5, "n": 4}
    assert bw.spread([]) is None and bw.spread([None]) is None


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_refuses_without_card(script, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is not refused")
    res = subprocess.run([sys.executable, str(SCRIPTS[script]), "--device",
                          "cuda"], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "needs a CUDA card" in res.stderr
    assert '"platform"' not in res.stdout
