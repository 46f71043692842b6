"""Multi-process host staging feeding ONE device: a device server in the
process that owns the card, plus N staging processes that each run the
full host pipeline (getReads -> hapgen -> NW -> pack -> calling -> GLF)
for a disjoint subset of window FILES and ship packed slabs to the
server over a unix socket.

Counterpart of ``dindel_tpu/parallel/hostshard.py``.  Why: on one card
the batched engine's wall is one Python thread's host staging (PERF.md
§5, C3); here the staging is split over processes that hold no device
context (each hides the card before its first CUDA call), and only the
server's process pays for one.  The server's threads enqueue every slab
program under one interpreter lock (PERF.md §5, C11).  The window FILE is the parallel unit
because it is the reference's own process boundary
(python/makeWindows.py:46-54 spawns one dindel job per window file, each
with a fresh read buffer), so per-shard GLF bytes stay identical to
sequential runs.

Protocol (length-prefixed pickle over a unix stream socket; numpy
arrays only, never tensors):
  ("dispatch", id, kind, payload) -> no reply; server enqueues the slab
      program on its device (kind: "stats" | "compact" | "dense")
  ("fetch", [ids])               -> one reply: [fetched results]
  ("bye",)                       -> closes the connection
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..device import resolve_device
from ..hmm.slab import run_packed, run_slab_decode, run_slab_stats

_HDR = struct.Struct("<Q")


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> Any:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return pickle.loads(_recv_exact(sock, n))


def _is_error(r) -> bool:
    return isinstance(r, tuple) and len(r) == 2 and r[0] == "__error__"


class RemoteHandle:
    """Placeholder for a device result living in the server process."""

    __slots__ = ("rid",)

    def __init__(self, rid: int):
        self.rid = rid

    def __repr__(self):
        return f"RemoteHandle({self.rid})"


# ---------------------------------------------------------------------------
# Server (runs in the process that owns the device)


class DeviceServer:
    """Accepts staging connections and runs slab programs on `device`,
    one thread per connection.  A dispatch enqueues the program (CUDA
    runs it asynchronously); a fetch copies the results to the host in
    the requesting connection's thread, so other clients keep
    dispatching.  ``stats`` sums the seconds the server's threads spend
    enqueueing (``dispatch_s``) and fetching (``fetch_s``), for reading
    whether the server thread is the wall."""

    def __init__(self, path: str, device):
        self.path = path
        self.device = resolve_device(device)
        self.stats = dict(dispatches=0, dispatch_s=0.0, fetch_s=0.0)
        self._stats_lock = threading.Lock()
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(16)
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _run(self, kind: str, payload: dict):
        if kind == "stats":
            return run_slab_stats(
                payload["merged"], payload["vtab"], payload["callmeta"],
                payload["max_mismatch"], exact_ties=payload["exact_ties"],
                device_folds=payload["device_folds"], device=self.device)
        if kind == "compact":
            return run_slab_decode(payload["merged"], payload["exact_ties"],
                                   self.device)
        if kind == "dense":
            return run_packed(payload["merged"], payload["exact_ties"],
                              self.device)
        raise ValueError(f"unknown dispatch kind {kind}")

    def _count(self, **inc) -> None:
        with self._stats_lock:
            for k, v in inc.items():
                self.stats[k] += v

    def _serve(self, conn: socket.socket):
        results: Dict[int, Any] = {}
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if op == "dispatch":
                    _, rid, kind, payload = msg
                    t0 = time.perf_counter()
                    try:
                        results[rid] = self._run(kind, payload)
                    except Exception as e:  # ship the fault to the client
                        results[rid] = ("__error__", repr(e))
                    self._count(dispatches=1,
                                dispatch_s=time.perf_counter() - t0)
                elif op == "fetch":
                    _, rids = msg
                    # every requested slab's tensors to numpy in one pass
                    # and one reply; a slab whose copy raises (its
                    # program failed on the device) ships as an error
                    t0 = time.perf_counter()
                    out = []
                    for rid in rids:
                        r = results.pop(rid)
                        if not _is_error(r):
                            try:
                                r = tuple(t.cpu().numpy() for t in r)
                            except Exception as e:
                                r = ("__error__", repr(e))
                        out.append(r)
                    self._count(fetch_s=time.perf_counter() - t0)
                    _send_msg(conn, out)
                elif op == "bye":
                    return
        except (ConnectionError, EOFError):
            return
        finally:
            conn.close()

    def close(self):
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# Client


class DeviceProxy:
    """Staging-process view of the device server.  dispatch() returns a
    RemoteHandle immediately; fetch_pytrees() replaces every RemoteHandle
    in the given pytrees with the server-fetched arrays in ONE round
    trip, and raises RuntimeError if any of them failed on the server.
    What the server sent back stays here until it is claimed by a fetch
    that succeeds, so after a failed combined fetch each pytree can be
    fetched again on its own and only the failing ones raise."""

    def __init__(self, path: str):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)
        self._next = 0
        self._lock = threading.Lock()
        self._held: Dict[int, Any] = {}

    def dispatch(self, kind: str, payload: dict) -> RemoteHandle:
        with self._lock:
            rid = self._next
            self._next += 1
            _send_msg(self._sock, ("dispatch", rid, kind, payload))
        return RemoteHandle(rid)

    def _fetch_ids(self, rids: List[int]) -> List[Any]:
        with self._lock:
            _send_msg(self._sock, ("fetch", rids))
            return _recv_msg(self._sock)

    def fetch_pytrees(self, objs: List[Any]) -> List[Any]:
        handles: List[RemoteHandle] = []

        def collect(o):
            if isinstance(o, RemoteHandle):
                handles.append(o)
            elif isinstance(o, dict):
                for v in o.values():
                    collect(v)
            elif isinstance(o, (list, tuple)):
                for v in o:
                    collect(v)

        for o in objs:
            collect(o)
        missing = [h.rid for h in handles if h.rid not in self._held]
        if missing:
            self._held.update(zip(missing, self._fetch_ids(missing)))
        for h in handles:
            f = self._held[h.rid]
            if _is_error(f):
                raise RuntimeError(f"remote slab program failed: {f[1]}")
        table = {h.rid: self._held.pop(h.rid) for h in handles}

        def subst(o):
            if isinstance(o, RemoteHandle):
                return table[o.rid]
            if isinstance(o, dict):
                return {k: subst(v) for k, v in o.items()}
            if isinstance(o, list):
                return [subst(v) for v in o]
            if isinstance(o, tuple):
                return tuple(subst(v) for v in o)
            return o

        return [subst(o) for o in objs]

    def close(self):
        try:
            _send_msg(self._sock, ("bye",))
        except OSError:
            pass
        self._sock.close()


# ---------------------------------------------------------------------------
# Orchestration: N staging processes + per-shard GLF files


def _staging_main(sock_path: str, bam_paths: List[str], fasta_path: str,
                  params_bytes: bytes, win_files: List[str],
                  glf_paths: List[str], engine_kw: dict,
                  err_path: str, repeats: int = 1,
                  lib_file: Optional[str] = None) -> None:
    """Entry point of one staging process.  It hides the card before its
    first CUDA call and builds its engine on the CPU with the proxy as
    `remote`, so it never opens a device context: all device work, a
    slab rescue's per-window programs included, goes through the proxy.
    Its torch work runs on one thread: the staging processes share the
    host's cores."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        import json

        import torch
        torch.set_num_threads(1)
        from ..engine.batched import BatchedWindowEngine
        params = pickle.loads(params_bytes)
        libraries = None
        if lib_file:
            from ..model import LibraryCollection
            libraries = LibraryCollection()
            libraries.add_from_file(lib_file)
        proxy = DeviceProxy(sock_path)
        eng = BatchedWindowEngine([p for p in bam_paths], fasta_path, params,
                                  libraries, device="cpu", remote=proxy,
                                  **engine_kw)
        # per-process timing that EXCLUDES interpreter/torch startup, for
        # honest multi-process windows/s numbers
        t0 = time.time()
        marks = []
        for _ in range(repeats):
            r0 = time.time()
            w0 = eng.stats.windows_ok
            for wf, gp in zip(win_files, glf_paths):
                eng.detect_indels(wf, gp)
            marks.append(dict(t0=r0, t1=time.time(),
                              windows=eng.stats.windows_ok - w0))
        t1 = time.time()
        eng.close()
        proxy.close()
        with open(err_path + ".stats", "w") as f:
            json.dump(dict(t_start=t0, t_end=t1, repeats=marks,
                           windows_ok=eng.stats.windows_ok,
                           windows_total=eng.stats.windows_total,
                           stage_seconds=dict(eng.stats.stage_seconds),
                           counts=dict(eng.stats.counts),
                           cuda_initialized=torch.cuda.is_initialized()),
                      f)
    except Exception:
        import traceback
        with open(err_path, "w") as f:
            traceback.print_exc(file=f)
        raise


def run_hostshard(bam_paths: List[str], fasta_path: str, params,
                  win_files: List[str], out_glf: str, n_procs: int = 4,
                  engine_kw: Optional[dict] = None,
                  sock_path: Optional[str] = None,
                  repeats: int = 1, stats_out: Optional[dict] = None,
                  lib_file: Optional[str] = None,
                  device="cuda") -> List[str]:
    """Run the window files through n_procs staging processes feeding
    this process's `device`, then concatenate the per-shard GLF files
    into out_glf (single header, shard rows in window-file order —
    byte-equal to a sequential multi-file run).  engine_kw are the
    staging engines' BatchedWindowEngine arguments (dtype, exact_ties,
    device_folds, batch_windows, ...).  Every staging process's stats
    are read: one that initialized CUDA raises RuntimeError, and slab
    rescues are summed (``slab_rescues``) and reported on stderr.
    Returns the shard GLF paths; with `stats_out`, fills it with the
    staging processes' timings and stage seconds (``per_proc``), the
    summed rescues and the server's stats (``server``)."""
    import json
    import multiprocessing as mp
    import tempfile

    engine_kw = dict(engine_kw or {})
    if sock_path is None:
        sock_path = tempfile.mktemp(prefix="dindel_dev_", suffix=".sock")
    server = DeviceServer(sock_path, device)
    n_procs = max(1, min(n_procs, len(win_files)))
    shards: List[List[str]] = [[] for _ in range(n_procs)]
    for i, wf in enumerate(win_files):
        shards[i % n_procs].append(wf)
    glf_of = {wf: f"{out_glf}.shard{i:03d}"
              for i, wf in enumerate(win_files)}

    ctx = mp.get_context("spawn")
    procs = []
    err_paths = []
    try:
        for s, files in enumerate(shards):
            err = f"{out_glf}.err{s}"
            err_paths.append(err)
            p = ctx.Process(
                target=_staging_main,
                args=(sock_path, bam_paths, fasta_path,
                      pickle.dumps(params), files, [glf_of[f] for f in files],
                      engine_kw, err, repeats, lib_file))
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
        for p, err in zip(procs, err_paths):
            if p.exitcode != 0:
                detail = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(
                    f"staging process failed (exit {p.exitcode}):\n{detail}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        server.close()

    # every process exited 0, so each wrote its stats
    stats = [json.load(open(err + ".stats")) for err in err_paths]
    if any(st["cuda_initialized"] for st in stats):
        raise RuntimeError("a staging process initialized CUDA")
    rescues = sum(st["counts"].get("slab.rescues", 0) for st in stats)
    if rescues:
        print(f"WARNING: staging processes rescued {rescues:g} slabs on the "
              "device server (see their stderr for the first cause)",
              file=sys.stderr)
    shard_paths = [glf_of[wf] for wf in win_files]
    merge_glf(shard_paths, out_glf)

    if stats_out is not None:
        stats_out["slab_rescues"] = rescues
        stats_out["t_start"] = min(st["t_start"] for st in stats)
        stats_out["t_end"] = max(st["t_end"] for st in stats)
        stats_out["windows_ok"] = sum(st["windows_ok"] for st in stats)
        # warm = the BEST repeat past the first across all procs
        # (cold start-up lands in repeat 1)
        nrep = min(len(st["repeats"]) for st in stats)
        best = None
        for k in range(1, nrep):
            marks = [st["repeats"][k] for st in stats]
            span = max(m["t1"] for m in marks) - min(m["t0"] for m in marks)
            wins = sum(m["windows"] for m in marks)
            if span > 0 and (best is None or wins / span > best[0]):
                best = (wins / span, span, wins)
        if best:
            stats_out["warm_span_s"] = best[1]
            stats_out["warm_windows"] = best[2]
        stats_out["per_proc"] = stats
        stats_out["server"] = dict(server.stats)
    return shard_paths


def merge_glf(paths: List[str], out_glf: str) -> None:
    """Ordered GLF merge: the header of the first file, then every file's
    data rows in the order given (the bytes one process writes for the
    same window files in sequence)."""
    with open(out_glf, "w") as out:
        for i, path in enumerate(paths):
            with open(path) as f:
                for j, line in enumerate(f):
                    if j == 0 and i > 0:
                        continue  # drop repeated header
                    out.write(line)
