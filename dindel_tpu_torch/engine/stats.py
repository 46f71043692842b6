"""Run statistics: per-stage host seconds, per-stage profiler spans, and
work counters.

The reference's only observability channels are ad-hoc couts and the GLF
diagnostics columns (SURVEY.md §5); here every run tracks the windows it
wrote (ok and error rows), host seconds per stage (`stage`) and work
counted where it happens (`count`).  While a torch profiler is
recording, each stage is also a `layer.<stage>` span on the thread that
ran it, in the same trace as the device's events; with no profiler, a
stage opens no span.  Work that runs on no Python thread adds its own
clock's seconds to a stage (`add_seconds`), with no span."""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclass
class RunStats:
    windows_total: int = 0
    windows_ok: int = 0
    windows_error: int = 0
    error_messages: Dict[str, int] = field(default_factory=dict)
    reads_processed: int = 0
    pairs_scored: int = 0
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    # The batched engine updates stats from both the staging thread and
    # the finish worker; read-modify-writes go through this lock so
    # increments don't vanish under bytecode interleaving.
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    @contextlib.contextmanager
    def stage(self, name: str):
        # a stage's seconds include its own span, so that a layer's
        # sub-stages account for the spans they open inside it
        t0 = time.perf_counter()
        span = None
        if _profiler_enabled():
            span = torch.profiler.record_function("layer." + name)
            span.__enter__()
        try:
            yield
        finally:
            if span is not None:
                span.__exit__(None, None, None)
            dt = time.perf_counter() - t0
            with self.lock:
                self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                            + dt)

    def add_seconds(self, name: str, seconds: float) -> None:
        """Seconds of a stage that ran on no Python thread (a native
        thread's own clock)."""
        with self.lock:
            self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                        + seconds)

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + n

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
        return {
            "windows_total": self.windows_total,
            "windows_ok": self.windows_ok,
            "windows_error": self.windows_error,
            "error_messages": self.error_messages,
            "reads_processed": self.reads_processed,
            "pairs_scored": self.pairs_scored,
            "stage_seconds": self.stage_seconds,
            "counts": self.counts,
        }
