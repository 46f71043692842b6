"""The timed path: the program's engine built as its CLI builds it, driven
over the window file in whole passes, and the rate of windows completed.

A pass is one `detect_indels` call over the window file, as a user runs
one window file after another; a pass that ends inside the window is
followed by the next over the same file.  The window closes at the first
window staged after its deadline: HarnessStats raises WindowClosed from
the engine's `get_reads` stage, the engine waits for the batch in flight
and the pass ends there.

The rate is every window completed (RunStats.windows_ok + windows_error,
the windows whose GLF rows the engine wrote, `ok` and `error_*` alike)
over all the time of an interval that starts when the window opens (the
pipeline is empty: warm-up has ended) and ends at the last completion
before the deadline that closes a burst: a batched engine completes its
windows a batch at a time, and a completion followed by no other within
the configuration's `burst_gap_s` ends a burst (0: every completion)."""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

from dindel_tpu_torch.engine.stats import RunStats


class WindowClosed(BaseException):
    """Raised from the engine's read stage once the window's deadline has
    passed (a BaseException, so the engines' per-window handlers let it
    through)."""


class HarnessStats(RunStats):
    """The program's RunStats, with the window's deadline checked where a
    window's staging begins and, in a traced run, each stage wrapped in a
    profiler span named layer.<stage>."""

    def __init__(self):
        super().__init__()
        self.deadline = None
        self.spans = False

    @contextlib.contextmanager
    def stage(self, name: str):
        if (name == "get_reads" and self.deadline is not None
                and time.perf_counter() >= self.deadline):
            raise WindowClosed()
        with contextlib.ExitStack() as st:
            if self.spans:
                import torch
                st.enter_context(torch.profiler.record_function(
                    "layer." + name))
            st.enter_context(super().stage(name))
            yield


def build_engine(cfg: dict, fasta: str, bam: str, device: str):
    """The engine of `--analysis indels` for the configuration's CLI
    arguments, constructed as the CLI's _indels constructs it, with the
    harness's RunStats in place of its own."""
    import numpy as np
    from dindel_tpu_torch import cli
    from dindel_tpu_torch.model import LibraryCollection

    args = cli.build_parser().parse_args(
        list(cfg["cli"]) + ["--bamFile", bam, "--ref", fasta,
                            "--device", device])
    params = cli.params_from_args(args)
    if args.engine == "batched" and params.slower:
        from dindel_tpu_torch.engine.batched import BatchedWindowEngine
        eng = BatchedWindowEngine(
            [bam], fasta, params, LibraryCollection(), device=args.device,
            batch_windows=args.batchWindows,
            max_pairs_per_slab=args.maxPairsPerSlab,
            exact_ties=args.hmmBackend != "pallas", dtype=np.float32)
    else:
        from dindel_tpu_torch.engine.window import WindowEngine
        eng = WindowEngine([bam], fasta, params, LibraryCollection(),
                           hmm_backend=args.hmmBackend, device=args.device)
    eng.stats = HarnessStats()
    eng.rescued_windows = 0
    rescue = getattr(eng, "_rescue_slab", None)
    if rescue is not None:
        def counted(slab, _rescue=rescue):
            eng.rescued_windows += len(slab)
            return _rescue(slab)
        eng._rescue_slab = counted
    return eng


def completed(stats: RunStats) -> int:
    return stats.windows_ok + stats.windows_error


class Completions:
    """Samples the engine's completion counters from a thread: (time,
    windows completed, windows_ok) at every change."""

    def __init__(self, stats: RunStats, period_s: float = 0.01):
        self.stats = stats
        self.period_s = period_s
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def read(self):
        s = self.stats
        return time.perf_counter(), completed(s), s.windows_ok

    def start(self):
        self.samples.append(self.read())
        self._thread.start()

    def _run(self):
        last = self.samples[-1][1:]
        while not self._stop.wait(self.period_s):
            t, n, ok = self.read()
            if (n, ok) != last:
                self.samples.append((t, n, ok))
                last = (n, ok)

    def stop(self):
        self._stop.set()
        self._thread.join()
        self.samples.append(self.read())


def rate_interval(samples, t0: float, deadline: float, gap_s: float,
                  pass_ends=()):
    """(windows, seconds) from the window's start t0 to its last burst
    end before the deadline; None when no burst ended in the window.
    samples: (time, completed, ok) in time order, the first at t0.
    A burst ends at a sample where `ok` grew and `ok` grows no more
    within gap_s (an error counted while a window is staged is no
    completion), or at a pass's end."""
    n0 = samples[0][1]
    ends = set(pass_ends)
    grew = [i for i in range(1, len(samples))
            if samples[i][2] > samples[i - 1][2]]
    best = None
    for k, i in enumerate(grew):
        t, n, _ = samples[i]
        if t > deadline:
            break
        if k + 1 == len(grew) or samples[grew[k + 1]][0] - t > gap_s:
            best = (n - n0, t - t0)
    for t, n, _ in samples:
        if t in ends and t <= deadline and (best is None or t > best[1] + t0):
            best = (n - n0, t - t0)
    return best


def run_passes(eng, windows: str, out_dir: Path, seconds: float):
    """Drive `eng` over `windows` in whole passes for `seconds`; each pass
    writes out_dir/pass<k>.glf.txt.  Returns the window's start and
    deadline, the whole passes and their ends, the completion samples,
    the GLF paths, the stage seconds at the start and at the deadline,
    the count completed at the deadline and the windows rescued."""
    stats = eng.stats
    poll = Completions(stats)
    with stats.lock:
        stage0 = dict(stats.stage_seconds)
    rescued0 = eng.rescued_windows
    poll.start()
    t0 = poll.samples[0][0]
    deadline = t0 + seconds
    stats.deadline = deadline
    closing = {}

    def mark_close():
        # the stage seconds and counts at the deadline
        time.sleep(max(0.0, deadline - time.perf_counter()))
        with stats.lock:
            closing["stage"] = dict(stats.stage_seconds)
        closing["n"] = completed(stats)
        closing["rescued"] = eng.rescued_windows

    marker = threading.Thread(target=mark_close, daemon=True)
    marker.start()
    passes, pass_ends, glfs = 0, [], []
    try:
        while time.perf_counter() < deadline:
            glf = out_dir / f"pass{passes}.glf.txt"
            glfs.append(glf)
            eng.detect_indels(windows, str(glf))
            passes += 1
            end = poll.read()
            poll.samples.append(end)
            pass_ends.append(end[0])
    except WindowClosed:
        pass
    finally:
        stats.deadline = None
    marker.join()
    poll.stop()
    # pass ends sampled on this thread keep the samples in time order
    poll.samples.sort(key=lambda s: s[0])
    return dict(t0=t0, deadline=deadline, passes=passes,
                pass_ends=pass_ends, samples=poll.samples, glfs=glfs,
                stage_open=stage0, stage_close=closing["stage"],
                n_close=closing["n"], rescued=closing["rescued"] - rescued0)
