"""The traced run: torch.profiler over the window, the shapes of every
kernel launch in it, and their reduction to the record the per-layer
readers take.

Launch shapes are recorded by wrapping the kernel wrappers where the
slab program binds them (dindel_tpu_torch.hmm.slab: pair_hmm_dp,
finish, pair_stats, window_call); the wrapper passes every argument on
unchanged and keeps only sizes and references to the per-pair length
vectors and small index tensors, read back after the window: K1 and K2
are counted from each pair's own lengths (roofline.py), not from the
padded shapes or the program's row bounds.  A launch counts while the
engine's window is open (HarnessStats.deadline set and not passed)."""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

from . import roofline

# kernel -> substring of its CUDA symbol in the profiler's trace
KERNELS = {"pair_hmm_dp": "pair_hmm_dp", "finish": "finish_kernel",
           "pair_stats": "pair_stats_kernel",
           "window_call": "window_call_kernel"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Launches:
    """Records (kernel, bound inputs) per launch while `open()`."""

    def __init__(self, stats):
        self.stats = stats
        self.rows = []
        self._saved = {}

    def _open(self):
        d = self.stats.deadline
        return d is not None and time.perf_counter() < d

    def install(self):
        from dindel_tpu_torch.hmm import slab
        for name, shape in (("pair_hmm_dp", _dp_shape),
                            ("finish", _finish_shape),
                            ("pair_stats", _stats_shape),
                            ("window_call", _window_shape)):
            fn = getattr(slab, name)
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, _shape=shape, **kw):
                if self._open():
                    self.rows.append((_name, _shape(*a, **kw)))
                return _fn(*a, **kw)
            setattr(slab, name, wrapped)

    def uninstall(self):
        from dindel_tpu_torch.hmm import slab
        for name, fn in self._saved.items():
            setattr(slab, name, fn)
        self._saved = {}

    def bounds(self):
        """[(kernel, bound_ms)] in launch order (reads back the index
        tensors the bounds need)."""
        return [(name, shape()) for name, shape in self.rows]


def _host(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _dp_shape(H_pad, L_pad, numT, hap_len, read_len, b_mid, read_codes,
              hap_codes, eq, *a, **kw):
    item = eq.element_size()

    def bound():
        return roofline.dp_pair_bound(_host(hap_len), _host(read_len),
                                      _host(b_mid), L_pad, numT, item)[0]
    return bound


def _finish_shape(H_pad, L_pad, numT, b_mid, hap_len, alpha_mid, *a,
                  read_len=None, **kw):
    B, item = int(b_mid.shape[0]), alpha_mid.element_size()

    def bound():
        rl = _host(read_len) if read_len is not None else np.full(B, L_pad)
        return roofline.finish_pair_bound(_host(hap_len), rl, _host(b_mid),
                                          L_pad, item)[0]
    return bound


def _stats_shape(H_pad, L_pad, V, map_state, read_len, hap_len, read_idx,
                 hap_idx, read_codes_r, hap_codes_h, *a, **kw):
    B, nr, nh = (int(map_state.shape[0]), int(read_codes_r.shape[0]),
                 int(hap_codes_h.shape[0]))

    def bound():
        cols = int(np.minimum(_host(read_len), L_pad).sum())
        return roofline.stats_bound(B, L_pad, V, nr, nh, H_pad, cols)[0]
    return bound


def _window_shape(W, NH, S, NR, ll, index_map, nr_w, pair_pr, *a, **kw):
    item = pair_pr.element_size()

    def bound():
        return roofline.window_bound(W, NH, S, NR, int(_host(nr_w).sum()),
                                     item)[0]
    return bound


class Trace:
    """torch.profiler (host and CUDA activity) around the window, with
    the window itself as the span `benchmark.window`."""

    def __init__(self, work_dir: Path):
        self.path = Path(work_dir) / "trace.json"
        self.prof = None
        self.span = None

    def start(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function("benchmark.window")
        self.span.__enter__()

    def stop(self):
        import torch
        self.span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(self.path)
        return events


class DeviceTime:
    """torch.profiler with CUDA activity alone, from the window's start
    until every window staged in it has finished: the card's busy
    seconds over that span (device_busy_s)."""

    def __init__(self, work_dir: Path):
        self.path = Path(work_dir) / "device.json"
        self.prof = None

    def start(self):
        import torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> float:
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(self.path)
        return device_busy_s(events)


def device_busy_s(events) -> float:
    """Seconds in which a kernel, copy or memset ran: the union of their
    intervals, wherever they lie."""
    iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
          if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    return sum(b - a for a, b in _union(iv)) / 1e6


def _union(iv):
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(event) -> str:
    """A device op's name: a kernel's without its return type, namespaces
    that say nothing, templates and arguments; a copy's as traced."""
    name = event["name"]
    if event.get("cat") != "kernel":
        return name
    n = name.replace("(anonymous namespace)::", "").split("(")[0]
    n = n.split("<")[0].split()
    return n[-1] if n else name


def reduce(events, seconds: float, launches):
    """The traced run's record: window_s, busy_s, kernel device seconds
    and launch bounds per kernel, and the breakdown (the device ops that
    took most time; the idle time by the host layer that ran)."""
    win = [e for e in events if e.get("name") == "benchmark.window"
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace lacks the window span")
    w0 = float(win[0]["ts"])
    main_tid = win[0].get("tid")
    w1 = w0 + seconds * 1e6
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    dev.sort(key=lambda e: float(e["ts"]))
    iv = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
          for e in dev]
    busy = _union([(a, b) for a, b in iv if b > a])
    busy_s = sum(b - a for a, b in busy) / 1e6
    ops = {}
    for e, (a, b) in zip(dev, iv):
        if b > a:
            k = _short(e)
            ops[k] = ops.get(k, 0.0) + (b - a) / 1e6
    # kernel time of the recorded launches: the first n traced kernels
    # of each name (one stream executes them in launch order)
    bounds = launches.bounds()
    per = {}
    for k, sub in KERNELS.items():
        times = [float(e["dur"]) / 1e6 for e in dev
                 if e.get("cat") == "kernel" and sub in e["name"]]
        bms = [b for name, b in bounds if name == k]
        n = min(len(times), len(bms))
        per[k] = dict(launches=len(bms), traced=len(times),
                      device_s=sum(times[:n]),
                      bound_s=sum(bms[:n]) / 1e3)
    gaps = []
    cur = w0
    for a, b in busy + [[w1, w1]]:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    spans = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("layer.")
             and w0 <= float(e["ts"]) < w1]
    idle = _attribute(gaps, spans, main_tid)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return dict(window_s=seconds, busy_s=busy_s, kernels=per,
                breakdown=dict(device_ops=top(ops), idle_gaps=top(idle)))


def _labels(spans):
    """Disjoint (start, end, name) segments, each named by the innermost
    (latest started) span covering it."""
    ev = sorted([(a, 1, i) for i, (a, b, _) in enumerate(spans)]
                + [(b, 0, i) for i, (a, b, _) in enumerate(spans)])
    active, out, last = {}, [], None
    for t, kind, i in ev:
        if active and last is not None and t > last:
            inner = max(active, key=lambda j: spans[j][0])
            out.append((last, t, spans[inner][2]))
        if kind:
            active[i] = True
        else:
            active.pop(i, None)
        last = t
    return out


def _overlap(gaps, segs):
    """[(a, b, name)] pieces of the sorted disjoint gaps that the sorted
    disjoint segments cover."""
    out, j = [], 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b = max(g0, segs[k][0]), min(g1, segs[k][1])
            if b > a:
                out.append((a, b, segs[k][2]))
            k += 1
    return out


def _attribute(gaps, spans, main_tid):
    """Idle seconds by what the host ran: the innermost layer span of the
    main thread, else of another thread (worker.<layer>), else
    host.other."""
    main = _labels([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in spans if e.get("tid") == main_tid])
    other = _labels([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      "worker." + e["name"]) for e in spans
                     if e.get("tid") != main_tid])
    out = {}
    total = sum(b - a for a, b in gaps)
    on_main = _overlap(gaps, main)
    for a, b, name in on_main:
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    # what the main thread's spans leave, by the other threads' spans
    covered = _union([(a, b) for a, b, _ in on_main])
    free, j = [], 0
    for g0, g1 in gaps:
        cur = g0
        while j < len(covered) and covered[j][1] <= g0:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < g1:
            if covered[k][0] > cur:
                free.append((cur, covered[k][0]))
            cur = max(cur, covered[k][1])
            k += 1
        if g1 > cur:
            free.append((cur, g1))
    on_other = _overlap(free, other)
    for a, b, name in on_other:
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    named = sum(out.values())
    out["host.other"] = out.get("host.other", 0.0) + total / 1e6 - named
    return out
