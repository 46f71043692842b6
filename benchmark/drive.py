"""The timed path: the program's engine as its CLI builds it, driven
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
    window's staging begins.  (Its stages open the program's own
    `layer.<stage>` spans while the profiler records.)"""

    def __init__(self):
        super().__init__()
        self.deadline = None

    @contextlib.contextmanager
    def stage(self, name: str):
        if (name == "get_reads" and self.deadline is not None
                and time.perf_counter() >= self.deadline):
            raise WindowClosed()
        with super().stage(name):
            yield


class _Built(BaseException):
    """Carries the engine the CLI constructed out of the CLI."""

    def __init__(self, engine):
        super().__init__()
        self.engine = engine


@contextlib.contextmanager
def _taken_when_built():
    """While open, an engine's construction ends by raising _Built with
    the engine: the CLI that builds one stops before it runs a window."""
    from dindel_tpu_torch.engine.batched import BatchedWindowEngine
    from dindel_tpu_torch.engine.window import WindowEngine
    saved = {}
    for cls in (BatchedWindowEngine, WindowEngine):
        saved[cls] = cls.__dict__["__init__"]

        def init(self, *a, _cls=cls, _real=saved[cls], **kw):
            _real(self, *a, **kw)
            if type(self) is _cls:
                raise _Built(self)
        cls.__init__ = init
    try:
        yield
    finally:
        for cls, real in saved.items():
            cls.__init__ = real


def build_engine(cfg: dict, fasta: str, bams: list, bam_list: str,
                 device: str):
    """The engine that `python -m dindel_tpu_torch` builds for the
    configuration's CLI arguments, with `--bamFile` for one BAM and
    `--bamFiles <bam_list>` for more: the CLI's own construction runs
    (the BAM list, --libFile, --mesh, the engine kind and its arguments)
    and the engine is taken as it is built, with the harness's RunStats
    then put in place of its own.  --stageProcs (staging processes
    feeding a device server) is no one engine and is refused."""
    from dindel_tpu_torch import cli

    argv = list(cfg["cli"]) + (
        ["--bamFile", bams[0]] if len(bams) == 1 else ["--bamFiles", bam_list]
    ) + ["--ref", fasta, "--device", device]
    if cli.build_parser().parse_args(argv).stageProcs > 0:
        raise ValueError("--stageProcs runs staging processes and a device "
                         "server, not one engine: the harness cannot drive "
                         "it")
    eng = None
    with _taken_when_built():
        try:
            cli.main(argv)
        except _Built as built:
            eng = built.engine
    if eng is None:
        raise ValueError(f"the CLI built no engine for {cfg['cli']}")
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
    the GLF paths, the stage seconds and the program's counters at the
    start and at the deadline, the count completed at the deadline and
    the windows rescued."""
    stats = eng.stats
    poll = Completions(stats)
    with stats.lock:
        stage0 = dict(stats.stage_seconds)
        counts0 = dict(getattr(stats, "counts", {}))
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
            closing["counts"] = dict(getattr(stats, "counts", {}))
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
                counts_open=counts0, counts_close=closing["counts"],
                n_close=closing["n"], rescued=closing["rescued"] - rescued0)
