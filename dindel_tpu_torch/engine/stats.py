"""Run statistics and profiling counters.

The reference's only observability channels are ad-hoc couts and the GLF
diagnostics columns (SURVEY.md §5); here every run tracks per-stage
timing and throughput (windows/s, pair-HMM cells/s, reads fetched,
error-row counts) and can emit a torch.profiler trace (maybe_profile)."""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class RunStats:
    windows_total: int = 0
    windows_ok: int = 0
    windows_error: int = 0
    error_messages: Dict[str, int] = field(default_factory=dict)
    reads_processed: int = 0
    haps_generated: int = 0
    pairs_scored: int = 0
    cells_scored: int = 0
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    wall_start: float = field(default_factory=time.perf_counter)
    # The batched engine updates stats from both the staging thread and
    # the finish worker ('device_hmm'/'slab_fetch' are timed on both);
    # read-modify-writes go through this lock so increments don't vanish
    # under bytecode interleaving.
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self.lock:
                self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                            + dt)

    def record_window(self, n_reads: int, n_haps: int, max_read_len: int,
                      max_hap_len: int, num_t: int) -> None:
        self.windows_ok += 1
        self.reads_processed += n_reads
        self.haps_generated += n_haps
        self.pairs_scored += n_reads * n_haps
        self.cells_scored += (n_reads * n_haps * max_read_len
                              * 2 * (max_hap_len + 2) * num_t)

    def record_error(self, message: str) -> None:
        with self.lock:
            self.windows_error += 1
            self.error_messages[message] = self.error_messages.get(message, 0) + 1

    def record_ok(self, n_reads: int) -> None:
        """Worker-thread-safe windows_ok/reads_processed increment."""
        with self.lock:
            self.windows_ok += 1
            self.reads_processed += n_reads

    def summary(self) -> dict:
        wall = time.perf_counter() - self.wall_start
        return {
            "windows_total": self.windows_total,
            "windows_ok": self.windows_ok,
            "windows_error": self.windows_error,
            "error_messages": self.error_messages,
            "reads_processed": self.reads_processed,
            "haps_generated": self.haps_generated,
            "pairs_scored": self.pairs_scored,
            "cells_scored": self.cells_scored,
            "wall_seconds": wall,
            "windows_per_sec": self.windows_ok / wall if wall > 0 else 0.0,
            "cells_per_sec": self.cells_scored / wall if wall > 0 else 0.0,
            "stage_seconds": self.stage_seconds,
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """torch.profiler trace (host and CUDA activity) when a directory is
    given; the Chrome trace is written there on exit."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                trace_dir)):
        yield
