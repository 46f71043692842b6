#!/usr/bin/env python3
"""Where the host time of dindel_tpu_torch goes: a cProfile of a warm
batched-engine pass, and the PyTorch ops one slab program and one
streaming window enqueue, counted per loop.

    python3 tools/profile_host_torch.py [--n-variants 60] [--coverage 30]

The counterpart of tools/profile_host.py for the PyTorch port, on
tools/bench_windows.py's dataset:

1. cProfile of a warm `detect_indels` pass of the batched engine with
   tools/profile_host.py:63-88's settings (batch_windows 64,
   max_pairs_per_slab 8192, float32); the top 45 functions by
   cumulative time are printed;
2. op counts: the first slab program of that run (hmm/slab.py
   `run_slab_stats`, as the engine called it) and one streaming window
   (hmm/slab.py `run_packed` on the median window of that slab by
   pairs, float64, exact ties), each run under `torch.profiler`.  An op
   is a top-level `aten::` event of that trace.  Each op is attributed
   to the innermost frame of the port's source that issued it: the tool
   labels every PyTorch call, from outside the package, with the file
   and current line of that frame (a TorchFunctionMode that opens a
   `record_function` span around the call), and each op takes the label
   of the span around it.  (The profiler's own Python stacks,
   `with_stack=True`, name each frame by its function's first line
   only, so they cannot tell the loops of one function apart, and they
   made the CPU rehearsal 7x slower.)  The groups, from the innermost
   frame outward:
   the loops `finish.fold`, `finish.btf`, `finish.btb` (hmm/finish.py),
   `stats.m_log_bq`, `stats.n_ind`, `stats.variants` (hmm/stats.py),
   `window_call.reads` (infer/device_call.py); then `expand`
   (hmm/expand.py) and `dp` (the K1 wrapper hmm/dp_kernel.py, or its
   plain version hmm/dp_ref.py on the CPU); else `other`.  The K1
   launches are counted apart (`pair_hmm_dp.launches`).  The counts
   depend only on the shapes, so they repeat exactly;
3. on a card, the device's busy and idle share over a separate traced
   warm pass of the first window file, from the profiler's CUDA
   activity; "not measured" when the trace holds no device time.

The last line of standard output is one JSON record.  `--device cuda`
(the default) needs a card and exits non-zero without one; `--device
cpu` rehearses on the CPU (times null, counts filled: the `dp` group
then counts the plain DP's ops).  Imports nothing of JAX or
dindel_tpu."""

from __future__ import annotations

import argparse
import ast
import cProfile
import io
import json
import pstats
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import bench_windows_torch as bw  # noqa: E402
import chip_smoke  # noqa: E402

PKG = REPO / "dindel_tpu_torch"
# (group, file in the package, function, the loop's `range(...)`, which
# of the loops with that range in the function)
LOOPS = [
    ("finish.fold", "hmm/finish.py", "finish", "range(S)", 0),
    ("finish.btf", "hmm/finish.py", "finish", "range(L_pad - 1, 0, -1)", 0),
    ("finish.btb", "hmm/finish.py", "finish", "range(0, L_pad - 1)", 0),
    ("stats.m_log_bq", "hmm/stats.py", "pair_stats", "range(L_pad)", 0),
    ("stats.n_ind", "hmm/stats.py", "pair_stats", "range(L_pad)", 1),
    ("stats.variants", "hmm/stats.py", "pair_stats", "range(V)", 0),
    ("window_call.reads", "infer/device_call.py", "window_call",
     "range(NR)", 0),
]
FILES = {"hmm/expand.py": "expand", "hmm/dp_kernel.py": "dp",
         "hmm/dp_ref.py": "dp"}
GROUPS = [g for g, *_ in LOOPS] + ["expand", "dp", "other"]
LABEL = "dindel_op_group:"


def loop_lines():
    """{group: (file, first line, last line)} of each loop in the
    package's source as it stands; a loop that is gone is left out."""
    out = {}
    for group, rel, func, rng, nth in LOOPS:
        tree = ast.parse((PKG / rel).read_text())
        fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == func]
        loops = sorted((n for f in fns for n in ast.walk(f)
                        if isinstance(n, ast.For)
                        and ast.unparse(n.iter) == rng),
                       key=lambda n: n.lineno)
        if len(loops) > nth:
            out[group] = (str(PKG / rel), loops[nth].lineno,
                          loops[nth].end_lineno)
    return out


class GroupLabels:
    """While active, every PyTorch call runs inside a `record_function`
    span named for the group of the innermost frame of the port's source
    that made it (walking outward until a loop or a file of a group
    matches)."""

    def __init__(self):
        import torch
        from torch.overrides import TorchFunctionMode

        self.loops = loop_lines()
        self.files = {str(PKG / rel): g for rel, g in FILES.items()}
        pkg = str(PKG)
        labels = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                group = labels.group(sys._getframe(1), pkg)
                with torch.profiler.record_function(LABEL + group):
                    return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def group(self, frame, pkg):
        while frame is not None:
            path = frame.f_code.co_filename
            if path.startswith(pkg):
                for g, (f, lo, hi) in self.loops.items():
                    if path == f and lo <= frame.f_lineno <= hi:
                        return g
                if path in self.files:
                    return self.files[path]
            frame = frame.f_back
        return "other"


def count_ops(fn, device, labels: GroupLabels):
    """Run `fn` once under the profiler (the run that captured its
    arguments warmed everything up); returns ({group: top-level aten
    ops}, total, K1 launches)."""
    from torch.profiler import ProfilerActivity, profile
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    launches = pair_hmm_dp.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with labels.mode:
            fn()
        chip_smoke.sync(device)
    launches = pair_hmm_dp.launches - launches
    counts = dict.fromkeys(GROUPS, 0)
    for ev in prof.events():
        if not ev.name.startswith("aten::"):
            continue
        group, up = "other", ev.cpu_parent
        while up is not None:
            if up.name.startswith("aten::"):
                break           # a sub-op of a counted op
            if up.name.startswith(LABEL) and group == "other":
                group = up.name[len(LABEL):]
            up = up.cpu_parent
        else:
            counts[group] += 1
    return counts, sum(counts.values()), launches


class Capture:
    """While active: keeps the arguments of the batched engine's first
    slab program (run_slab_stats) and the windows of its first slab."""

    def __enter__(self):
        from dindel_tpu_torch.engine import batched

        self.slab_args = self.slab = None
        self.saved = [(batched, "run_slab_stats", batched.run_slab_stats),
                      (batched.BatchedWindowEngine, "_stage_slab",
                       batched.BatchedWindowEngine._stage_slab)]
        run, stage = self.saved[0][2], self.saved[1][2]

        def run_slab_stats(*a, **k):
            if self.slab_args is None:
                self.slab_args = (a, k)
            return run(*a, **k)

        def stage_slab(eng, slab):
            if self.slab is None:
                self.slab = [(e["haps"], e["reads"], e["left_pos"])
                             for e in slab]
            return stage(eng, slab)
        batched.run_slab_stats = run_slab_stats
        batched.BatchedWindowEngine._stage_slab = stage_slab
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)
        return False


def device_busy(fa, bam, win_file, d: Path, device):
    """(busy share, idle share) of the card over a traced warm pass of
    one window file, or "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chip_smoke.engine_pass(fa, bam, [win_file], d / "traced.glf.txt",
                               device, max_pairs=8192, batch_windows=64)
    dev_us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages())
    evs = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0 or not spans:
        return "not measured", "not measured"
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:        # the union of the device intervals
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    t0 = min(e.time_range.start for e in evs)
    t1 = max(e.time_range.end for e in evs)
    share = busy / (t1 - t0)
    return share, 1.0 - share


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-variants", type=int, default=60)
    ap.add_argument("--coverage", type=int, default=chip_smoke.COVERAGE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=None,
                    help="dataset directory, reused when already made")
    args = ap.parse_args(argv)
    on_card = bw.require_device(args.device, "profile_host_torch")
    import numpy as np
    from dindel_tpu_torch.config import Parameters
    from dindel_tpu_torch.hmm.pack import pack_pairs
    from dindel_tpu_torch.hmm.slab import run_packed, run_slab_stats

    dev = args.device
    with tempfile.TemporaryDirectory(prefix="profile_host_torch_") as tmp:
        d = Path(tmp)
        fa, bam, wins, _ = bw.prepare_dataset(
            Path(args.data) if args.data else d / "data", args.n_variants,
            args.coverage)
        engine = dict(max_pairs=8192, batch_windows=64)
        with Capture() as cap:      # cold pass: kernel build, caches
            chip_smoke.engine_pass(fa, bam, wins, d / "cold.glf.txt", dev,
                                   **engine)
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        pr.enable()
        wall, st = chip_smoke.engine_pass(fa, bam, wins, d / "warm.glf.txt",
                                          dev, **engine)
        pr.disable()
        dt = time.perf_counter() - t0
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("cumulative").print_stats(45)
        print(f"warm: {st['windows_ok']} windows in {dt:.3f} s"
              + (f" = {st['windows_ok'] / dt:.6g} windows/s (under cProfile)"
                 if on_card else " (CPU rehearsal)"))
        print("stages:", {k: round(v, 3)
                          for k, v in st["stage_seconds"].items()})
        print(out.getvalue())

        labels = GroupLabels()
        a, k = cap.slab_args
        pk = a[0]
        slab = count_ops(lambda: run_slab_stats(*a, **k), dev, labels)
        haps, reads, left = sorted(
            cap.slab, key=lambda w: len(w[0]) * len(w[1]))[len(cap.slab) // 2]
        # the engine's observation parameters: engine_pass's defaults
        wpk = pack_pairs(haps, reads, left, Parameters().obs_params,
                         np.float64)
        window = count_ops(lambda: run_packed(wpk, True, dev), dev, labels)
        busy = (device_busy(fa, bam, wins[0], d, dev) if on_card
                else ("not measured", "not measured"))
    lines = {g: f"{Path(f).relative_to(REPO)}:{lo}"
             for g, (f, lo, _) in labels.loops.items()}
    rec = {
        "metric": "profile_host_torch",
        "device": bw.device_record(on_card),
        "n_variants": args.n_variants, "coverage": args.coverage,
        "windows_ok": st["windows_ok"],
        "warm_pass_cprofile_s": dt if on_card else None,
        "loops": lines,
        "op_counts": {
            "slab_program": dict(
                groups=slab[0], total=slab[1], k1_launches=slab[2],
                B=int(pk["hap_idx"].shape[0]), H_pad=pk["H_pad"],
                L_pad=pk["L_pad"], **{n: a[2][n] for n in ("W", "NH", "S",
                                                          "NR")},
                V=int(a[1]["v_left_h"].shape[1]),
                exact_ties=k.get("exact_ties"),
                device_folds=k.get("device_folds")),
            "streaming_window": dict(
                groups=window[0], total=window[1], k1_launches=window[2],
                B=int(wpk["hap_len"].shape[0]), H_pad=wpk["H_pad"],
                L_pad=wpk["L_pad"], dtype="float64", exact_ties=True),
        },
        "device_busy_share": busy[0],
        "device_idle_share": busy[1],
    }
    for name, (groups, total, launches) in (("slab program", slab),
                                            ("streaming window", window)):
        print(f"[ops] {name}: total {total}, K1 launches {launches}; "
              + ", ".join(f"{g} ({lines.get(g, '-')}) {n}"
                          for g, n in groups.items()))
    print(f"[device] busy {busy[0]}, idle {busy[1]}")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
