"""Batched window processing on one torch device, a mesh of devices, or
a device server in another process.

Counterpart of ``dindel_tpu.engine.batched.BatchedWindowEngine``
(engine/batched.py:88), for the diploid and the pooled caller:

  1. host: read fetch + haplotype generation + NW alignment for a batch
     of windows (per-window fault isolation: failed windows become
     error_* rows, as in the reference);
  2. device: the batch's (hap, read) pairs in slabs of at most
     max_pairs_per_slab pairs, each one slab program (hmm/slab.py) on
     one of two routes, chosen per slab as the JAX engine chooses:
     - device call (the default): expand, the CUDA DP kernel, finish,
       pair stats and window folds; six small planes come back;
     - full decode: expand, the DP kernel, finish; map_state comes back
       and is decoded per pair on the host (hmm/liks.py LiksView).  It
       serves --outputRealignedBAM and --opl (the whole run) and slabs
       whose variant flanks reach the LO/RO sentinel codes.  A slab
       that needs the insert-size positional prior (--insertPrior, or
       --libFile with mapped mates) is packed dense (hmm/pack.py
       pack_pairs) and runs the DP kernel and finish on its per-pair
       arrays (slab.run_packed), then decodes the same way;
  3. host (one finish worker, so GLF rows stay in window order): fetch
     each slab's planes, run the pooled caller's VB-EM for the batch's
     device-call windows in one device dispatch (infer/device_em.py),
     then filter, pooled and diploid calling, GLF rows and realigned
     BAMs per window.

A slab whose device phase raises is re-scored window by window through
the per-window backend (float64, exact ties, the DP kernel on this
engine's device, or under ``remote`` on the device server's:
WindowEngine.compute_likelihoods); every rescue is counted in
stats.counts["slab.rescues"] and its first cause is printed to
stderr.  A rescue never runs the DP anywhere else: if the device fails
again, the run ends.  --faster runs the streaming engine (the CLI routes
it there) and raises ValueError here.

With ``mesh`` (a parallel.mesh.Mesh, or (n_dp, n_rp), --mesh) the
device-call and full-decode slab programs run with their pair axis
sharded over the mesh (hmm/slab.py run_slab_decode_sharded); dense slabs,
the device EM and the rescue run on the mesh's first device.  With
``remote`` (a parallel.hostshard.DeviceProxy, --stageProcs) this engine
stages on the host and ships each slab's numpy tables to the device
server, which runs the slab program; the batch's results come back in
one round trip, and a rescued window's dense program runs there too."""

from __future__ import annotations

import copy
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..hmm.liks import LiksStats, decode_liks_view
from ..hmm.pack import (_round_up, merge_compact, pack_pairs,
                        pack_pairs_compact, pad_compact)
from ..hmm.slab import (DENSE_KEYS, run_packed, run_slab_decode,
                        run_slab_decode_sharded, run_slab_stats)
from ..infer.device_call import (build_call_tables, diploid_glf_dev,
                                 filter_haplotypes_dev, host_window_folds,
                                 pair_enum)
from ..infer.device_em import run_batched_em
from ..infer.diploid import _WindowThrow, diploid_glf
from ..infer.filterhaps import filter_haplotypes
from ..infer.pooled import em_inputs, estimate_hap_freqs_bayes_em
from ..out.glf import OutputData, make_glf_output
from ..parallel.mesh import Mesh, make_mesh
from ..variants import read_window_file
from .reads import ReadBuffer, WindowError, get_reads
from .window import WindowEngine, check_guards_and_on_hap, with_next


class BatchedWindowEngine(WindowEngine):
    """WindowEngine variant that runs the pair-HMM and the calling folds
    batched across windows on `device`.

    exact_ties selects the DP's EPS/TIE fold and the exact sequential
    likelihood finish (the reference's tie rules); False is the fast
    fold with the argmax finish.  device_folds (default: True for
    float32, False for float64) runs the diploid read folds on the
    device; otherwise they run on the host in numpy, whose exp/log the
    GLF byte contract is anchored to.  device_em (the same default)
    runs the pooled caller's VB-EM of the device-call windows on the
    device (infer/device_em.py); otherwise, and always for full-decode
    windows, the host loop runs it, which is the byte-parity anchor.

    mesh (a Mesh, or (n_dp, n_rp) built on `device`'s type) shards the
    compact slab programs over its devices and makes its first device
    the engine's device.  remote (a hostshard.DeviceProxy) runs every
    slab program, and every rescued window's, in the device server;
    device EM is then off.  The two are exclusive."""

    def __init__(self, bam_paths, fasta_path, params, libraries=None, *,
                 device="cuda", batch_windows: int = 128,
                 max_pairs_per_slab: int = 24576, exact_ties: bool = False,
                 dtype=np.float32, device_folds: Optional[bool] = None,
                 device_em: Optional[bool] = None, mesh=None, remote=None):
        if not params.slower:
            raise ValueError(
                "the batched engine has no --faster path: --faster runs "
                "the streaming engine (WindowEngine), as the CLI routes it")
        if mesh is not None:
            if remote is not None:
                raise ValueError("remote staging and mesh sharding are "
                                 "exclusive")
            if not isinstance(mesh, Mesh):
                # (n_dp, n_rp) on the engine's device type: cuda:0.. or
                # the one CPU repeated
                dev = resolve_device(device)
                mesh = make_mesh(*mesh, devices=None if dev.type == "cuda"
                                 else [dev] * (mesh[0] * mesh[1]))
            device = mesh.first
        # the per-window backend of the slab rescue: float64, exact ties,
        # the DP kernel on this engine's device (JAX batched.py:98-103),
        # or under remote staging on the server's: this process has none
        super().__init__(bam_paths, fasta_path, params, libraries,
                         hmm_backend="jax", device=device)
        self._batch_hmm.remote = remote
        self.batch_windows = batch_windows
        self.max_pairs_per_slab = max_pairs_per_slab
        self.exact_ties = exact_ties
        self.np_dtype = np.dtype(dtype)
        if self.np_dtype not in (np.float32, np.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.device_folds = (self.np_dtype == np.float32
                             if device_folds is None else device_folds)
        # under remote staging the pooled windows take the host EM: the
        # device is the server's, and this process has none (JAX
        # batched.py:292-294)
        self.device_em = remote is None and (
            self.np_dtype == np.float32 if device_em is None else device_em)
        self.mesh = mesh
        self.remote = remote
        self._rescue_reported = False

    # ------------------------------------------------------------------
    def detect_indels(self, var_file: str, glf_path: Optional[str] = None):
        p = self.params
        if glf_path is None:
            glf_path = p.file_name + ".glf.txt"
        all_rows: List[dict] = []
        staged: List[dict] = []
        # One finish worker: batch N's fetch + calling + GLF write run on
        # it while this thread stages batch N+1; one worker and FIFO
        # futures keep GLF rows in window order.  The worker gets a
        # per-batch copy of the parameters and never touches the staging
        # state.
        finisher = ThreadPoolExecutor(max_workers=1)
        pending = None

        def wait():
            # this thread's wait on the finish worker's previous batch
            if pending is not None:
                with self.stats.stage("batch_wait"):
                    all_rows.extend(pending.result())

        with open(glf_path, "w") as out:
            glf_data = make_glf_output(out)
            glf_data.write_header()
            try:
                for entry in self.staged_windows(var_file):
                    staged.append(entry)
                    if len(staged) >= self.batch_windows:
                        batch = self._dispatch_batch(staged)
                        wait()
                        pending = finisher.submit(self._finish_batch, batch,
                                                  glf_data)
                        staged = []
                if staged:
                    batch = self._dispatch_batch(staged)
                    wait()
                    pending = finisher.submit(self._finish_batch, batch,
                                              glf_data)
                wait()
            finally:
                finisher.shutdown(wait=True)
        return all_rows

    def staged_windows(self, var_file: str):
        """Yield one staged entry per line of a window file, in order
        (the read buffer slides across windows of one contig, and reads
        one window ahead; it is closed when the pass ends or stops)."""
        p = self.params
        self.buf = ReadBuffer()
        self.buf.reset = True
        old_tid = "-1"
        try:
            for index, (candidates, nxt) in enumerate(with_next(
                    read_window_file(var_file, p.var_file_is_one_based)),
                    start=1):
                p.tid = candidates.tid
                if p.tid != old_tid:
                    self.buf.reset = True
                    old_tid = p.tid
                    self.buf.old_left_pos = 0
                if candidates.left_pos < self.buf.old_left_pos:
                    raise RuntimeError(
                        "Candidate variant files must be sorted on left "
                        "position of window!")
                yield self._stage_window(index, candidates, nxt)
        finally:
            self.buf.close()

    def _stage_window(self, index: int, candidates, nxt=None) -> dict:
        """Host staging of one window: reads, haplotypes, hap<->ref NW;
        `nxt` (get_reads' next_window) starts the next one's read intake
        ahead."""
        p = self.params
        left_pos = candidates.left_pos
        right_pos = candidates.right_pos
        self.stats.windows_total += 1
        entry = dict(index=index, tid=p.tid, pos=candidates.center_pos,
                     left_pos=left_pos, right_pos=right_pos,
                     candidates=candidates, error=None)
        try:
            with self.stats.stage("get_reads"):
                reads = get_reads(self.bams, p.tid, left_pos, right_pos, p,
                                  self.libraries, self.buf, stats=self.stats,
                                  next_window=nxt)
            self.buf.reset = False
            with self.stats.stage("hapgen"):
                skip, haps, lp2, rp2 = self.get_haplotypes(
                    reads, entry["pos"], left_pos, right_pos, candidates)
            if len(reads) * len(haps) > p.max_hap_read_prod:
                raise WindowError(
                    f"skipped_numhap_times_numread>{p.max_hap_read_prod}")
            entry.update(reads=reads, haps=haps, skip=skip, left_pos=lp2,
                         right_pos=rp2)
        except WindowError as e:
            entry["error"] = "error_" + str(e).replace(" ", "_")
            self.buf.reset = True
        except MemoryError:
            entry["error"] = "error_bad_alloc"
            self.buf.reset = True
        self.buf.old_left_pos = (entry["left_pos"] if entry["error"] is None
                                 else left_pos)
        return entry

    # ------------------------------------------------------------------
    def _dispatch_batch(self, staged: List[dict]) -> dict:
        """Partition the batch's good windows into slabs and enqueue each
        slab program on the device (asynchronous on CUDA)."""
        good = [e for e in staged
                if e["error"] is None and not e.get("skip") and e.get("haps")]
        slabs, slab, slab_pairs = [], [], 0
        for e in good:
            n = len(e["haps"]) * len(e["reads"])
            if slab and slab_pairs + n > self.max_pairs_per_slab:
                slabs.append(slab)
                slab, slab_pairs = [], 0
            slab.append(e)
            slab_pairs += n
        if slab:
            slabs.append(slab)
        items, rescued = [], {}
        for slab in slabs:
            try:
                items.append(self._stage_slab(slab))
            except Exception:
                rescued.update(self._rescue_slab(slab))
        return dict(staged=staged, items=items, rescued=rescued,
                    params=copy.copy(self.params))

    def _want_device_call(self) -> bool:
        """Realigned BAMs and --opl dumps need per-pair MLAlignments: the
        whole run takes the full-decode route (JAX batched.py:363-367)."""
        p = self.params
        return not (p.output_realigned_bam or p.output_pooled_likelihoods)

    def _stage_slab(self, slab: List[dict]):
        """Host pack (+ call tables on the device-call route) + slab
        program enqueue (or, under remote staging, its dispatch to the
        device server).  Returns (route, slab, pks, kmap_of, planes);
        planes is a RemoteHandle under remote staging."""
        p = self.params
        H_max = max(max(h.size() for h in e["haps"]) for e in slab)
        L_max = max(max(r.size() for r in e["reads"]) for e in slab)
        H_pad = _round_up(H_max, 16)
        L_pad = _round_up(max(L_max, 2), 16)
        with self.stats.stage("slab_pack"):
            pks = [pack_pairs_compact(e["haps"], e["reads"], e["left_pos"],
                                      p.obs_params, self.np_dtype,
                                      H_pad=H_pad, L_pad=L_pad)
                   for e in slab]
            dense = any(pk is None for pk in pks)
            if dense:
                # the insert-size positional prior needs per-pair tables:
                # the whole slab ships dense and takes the full-decode
                # route (JAX batched.py:395-401, 432-447)
                pks = [pack_pairs(e["haps"], e["reads"], e["left_pos"],
                                  p.obs_params, self.np_dtype, H_pad=H_pad,
                                  L_pad=L_pad) for e in slab]
                merged = {k: np.concatenate([pk[k] for pk in pks])
                          for k in DENSE_KEYS}
                merged.update(H_pad=H_pad, L_pad=L_pad, numT=pks[0]["numT"],
                              scalars=pks[0]["scalars"])
            else:
                merged = pad_compact(merge_compact(pks))
            use_dev = not dense and self._want_device_call()
            if use_dev:
                for e in slab:
                    e["ctab"] = build_call_tables(
                        e["haps"], e["candidates"], e["left_pos"], p)
                # a flank window reaching the LO/RO sentinel codes
                # (left_flank_read - padCover <= -3) makes the device
                # slot-coverage fold diverge from the host column-wise
                # computation: the whole slab takes the full-decode
                # route, as in the JAX engine (batched.py:406-415)
                use_dev = not any(
                    (e["ctab"]["v_valid"] & (e["ctab"]["v_left"] <= -3)).any()
                    for e in slab)
            if use_dev:
                vtab, callmeta, kmap_of = self._call_meta(slab, merged)
        with self.stats.stage("slab_dispatch"):
            if self.remote is not None:
                payload = dict(merged=merged, exact_ties=self.exact_ties)
                if use_dev:
                    payload.update(vtab=vtab, callmeta=callmeta,
                                   max_mismatch=p.obs_params.max_mismatch,
                                   device_folds=self.device_folds)
                kind = "dense" if dense else "stats" if use_dev else "compact"
                handle = self.remote.dispatch(kind, payload)
                if use_dev:
                    return "stats", slab, pks, kmap_of, handle
                return "decode", slab, pks, None, handle
            if dense:
                return ("decode", slab, pks, None,
                        run_packed(merged, self.exact_ties, self.device))
            if not use_dev:
                planes = (run_slab_decode(merged, self.exact_ties, self.device)
                          if self.mesh is None else run_slab_decode_sharded(
                              merged, self.exact_ties, self.mesh))
                return "decode", slab, pks, None, planes
            planes = run_slab_stats(
                merged, vtab, callmeta, p.obs_params.max_mismatch,
                exact_ties=self.exact_ties, device_folds=self.device_folds,
                device=self.device, mesh=self.mesh)
        return "stats", slab, pks, kmap_of, planes

    def _call_meta(self, slab: List[dict], merged: dict):
        """Per-hap variant flank tables aligned with the merged compact
        hap tables, and the per-window fold layout.  W, NH, NR, S and V
        are quantised (pow2 W/NR/S/V, NH at least maxHap) as in the JAX
        engine, so both packages lay a slab out the same way."""
        p = self.params
        vmax = max((len(e["ctab"]["slot_vars"][h])
                    for e in slab for h in range(len(e["haps"]))),
                   default=0)
        V = max(2, 1 << (max(vmax, 1) - 1).bit_length())
        n_hap_rows = merged["hap_codes_h"].shape[0]
        vtab = dict(v_left_h=np.zeros((n_hap_rows, V), np.int32),
                    v_right_h=np.zeros((n_hap_rows, V), np.int32),
                    v_isdel_h=np.zeros((n_hap_rows, V), bool),
                    v_valid_h=np.zeros((n_hap_rows, V), bool))
        row = 0
        for e in slab:
            ct = e["ctab"]
            nh = len(e["haps"])
            for k in ("v_left", "v_right", "v_isdel", "v_valid"):
                vtab[k + "_h"][row:row + nh, :ct[k].shape[1]] = ct[k]
            row += nh

        W = max(8, 1 << (len(slab) - 1).bit_length())
        NH = max(p.max_hap, max(len(e["haps"]) for e in slab))
        NR = max(len(e["reads"]) for e in slab)
        NR = max(64, 1 << (NR - 1).bit_length())
        S = max(len(e["ctab"]["var_positions"]) for e in slab)
        S = max(4, 1 << (max(S, 1) - 1).bit_length())
        NP = len(pair_enum(NH)[0])
        index_map = np.zeros((W, NH, NR), np.int32)
        nr_w = np.zeros(W, np.int32)
        pair_pr = np.zeros((W, S, NP), self.np_dtype)
        kmap_of = {}
        off = 0
        for w, e in enumerate(slab):
            ct = e["ctab"]
            nh = len(e["haps"])
            nr = len(e["reads"])
            index_map[w, :nh, :nr] = off + (
                np.arange(nh, dtype=np.int32)[:, None] * nr
                + np.arange(nr, dtype=np.int32)[None, :])
            nr_w[w] = nr
            # window pair k -> padded pair index under the NH enumeration
            kmap = (ct["h1v"] * (2 * NH - ct["h1v"] + 1)) // 2 \
                + (ct["h2v"] - ct["h1v"])
            kmap_of[e["index"]] = kmap
            ns = len(ct["var_positions"])
            if ns:
                pair_pr[w, :ns, kmap] = ct["pair_pr"].T
            off += nh * nr
        callmeta = dict(W=W, NH=NH, S=S, NR=NR, index_map=index_map,
                        nr_w=nr_w, pair_pr=pair_pr)
        return vtab, callmeta, kmap_of

    # ------------------------------------------------------------------
    def _finish_batch(self, batch: dict, glf_data: OutputData) -> List[dict]:
        """Finish worker: fetch every slab's planes, run the batch's
        device EM, then call each window and write its GLF rows in
        window order."""
        p = batch["params"]
        liks_by_idx = dict(batch["rescued"])
        items = batch["items"]
        fetched = [None] * len(items)
        if self.remote is not None and items:
            # every slab of the batch in ONE round trip (JAX
            # batched.py:726-749); if that raises, each slab is fetched
            # again on its own below, so only a failing slab is rescued
            try:
                with self.stats.stage("slab_fetch"):
                    fetched = self.remote.fetch_pytrees(
                        [item[4] for item in items])
            except Exception:
                pass
        for item, f in zip(items, fetched):
            try:
                self._finish_slab(item, liks_by_idx, p, f)
            except Exception:
                liks_by_idx.update(self._rescue_slab(item[1]))
        if p.estimate_hap_freqs and self.device_em:
            self._batch_em(batch["staged"], liks_by_idx, p)
        rows: List[dict] = []
        for e in batch["staged"]:
            if e["error"] is not None:
                self._error_row(glf_data, e, e["error"])
                continue
            if e.get("skip"):
                continue
            p.tid = e["tid"]
            try:
                liks = liks_by_idx.get(e["index"])
                if liks is None:
                    continue
                rows.extend(self._call_window(e, liks, glf_data, p))
                self.stats.record_ok(len(e["reads"]))
            except WindowError as err:
                msg = "error_" + str(err).replace(" ", "_")
                self._error_row(glf_data, e, msg)
        return rows

    def _error_row(self, glf_data: OutputData, e: dict, msg: str) -> None:
        """A window's error row, counted as it is written."""
        self.stats.record_error(msg)
        line = glf_data.line()
        line.set("msg", msg)
        line.set("index", e["index"])
        line.set("tid", e["tid"])
        line.set("lpos", e["left_pos"])
        line.set("rpos", e["right_pos"])
        glf_data.output(line)

    def _fetch(self, planes) -> list:
        """One slab's planes as numpy arrays."""
        with self.stats.stage("slab_fetch"):
            if self.remote is not None:
                return list(self.remote.fetch_pytrees([planes])[0])
            return [t.cpu().numpy() for t in planes]

    def _finish_slab(self, item, liks_by_idx: dict, params,
                     fetched=None) -> None:
        """Fetch one slab's planes (unless `fetched` holds them) and build
        each window's liks: (LiksView, None) on the full-decode route,
        (LiksStats, fold results) on the device-call route."""
        route, slab, pks, kmap_of, planes = item
        if fetched is None:
            fetched = self._fetch(planes)
        if route == "decode":
            self._finish_slab_decode(slab, pks, fetched, liks_by_idx, params)
            return
        f_plane, m_log_bq, i_plane, b_plane, base, site = fetched
        st = dict(ll=f_plane[:, 0], ll_off=f_plane[:, 1],
                  ll_on=f_plane[:, 2], m_log_bq=m_log_bq,
                  fb=i_plane[:, 0], lb=i_plane[:, 1], n_bqt=i_plane[:, 2],
                  n_mm_bqt=i_plane[:, 3], n_mm_left=i_plane[:, 4],
                  n_mm_right=i_plane[:, 5], num_mm=i_plane[:, 6],
                  n_ind=i_plane[:, 7], off_hap=b_plane[:, 0],
                  off_hap_hmq=b_plane[:, 1], has_event=b_plane[:, 2],
                  any_mism=b_plane[:, 3], cov_ok=b_plane[:, 4:])
        base = base.astype(np.float64)
        site = site.astype(np.float64)
        obs = params.obs_params
        off = 0
        with self.stats.stage("slab_decode"):
            for w, (e, pk) in enumerate(zip(slab, pks)):
                B = pk["hap_len"].shape[0]
                sl = slice(off, off + B)
                view = LiksStats(e["haps"], e["reads"], obs, pk["read_len"],
                                 pk["hap_len"],
                                 {k: v[sl] for k, v in st.items()})
                if self.device_folds:
                    kmap = kmap_of[e["index"]]
                    ns = len(e["ctab"]["var_positions"])
                    dev = dict(base=base[w][kmap],
                               site=site[w][:ns][:, kmap] if ns
                               else np.zeros((0, len(kmap))))
                else:
                    hb, hs = host_window_folds(view.ll2d, e["ctab"])
                    dev = dict(base=hb, site=hs)
                liks_by_idx[e["index"]] = (view, dev)
                off += B

    def _finish_slab_decode(self, slab, pks, fetched, liks_by_idx,
                            params) -> None:
        """Full-decode route: decode each window's pairs on the host from
        the fetched finish outputs, map_state included."""
        ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state = fetched
        off = 0
        with self.stats.stage("slab_decode"):
            for e, pk in zip(slab, pks):
                B = pk["hap_len"].shape[0]
                sl = slice(off, off + B)
                # dense per-pair code view for the decode (host gather)
                dense = pk if not pk.get("compact") else dict(
                    H_pad=pk["H_pad"], L_pad=pk["L_pad"],
                    hap_len=pk["hap_len"], read_len=pk["read_len"],
                    hap_codes=pk["hap_codes_h"][pk["hap_idx"]],
                    read_codes=pk["read_codes_r"][pk["read_idx"]])
                liks_by_idx[e["index"]] = (decode_liks_view(
                    e["haps"], e["reads"], dense, ll[sl], off_hap[sl],
                    off_hap_hmq[sl], ll_off[sl], ll_on[sl], map_state[sl],
                    params.obs_params), None)
                off += B

    def _rescue_slab(self, slab: List[dict]) -> dict:
        """Slab-level fault isolation (JAX batched.py:672-702), called
        where a slab's staging, dispatch or fetch raised: each window of
        the slab is re-scored through the per-window backend (float64,
        exact ties, the DP kernel on this engine's device or, under
        remote staging, one dense program per window on the server's), so
        one pathological window cannot take down its slab-mates.  A
        window's WindowError becomes its error row; anything else raised
        here (a sticky CUDA error, a failed or lost server among them)
        ends the run.  Returns {window
        index: (LiksView, None)}: rescued windows take the host
        callers."""
        self.stats.count("slab.rescues", 1)
        if not self._rescue_reported:
            self._rescue_reported = True
            print("WARNING: slab device phase failed; per-window rescue "
                  "engaged. First cause:", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
        out = {}
        for e in slab:
            try:
                liks, _on_hap = self.compute_likelihoods(
                    e["haps"], e["reads"], e["left_pos"])
                out[e["index"]] = (liks, None)
            except WindowError as err:
                e["error"] = "error_" + str(err).replace(" ", "_")
        return out

    def _batch_em(self, staged: List[dict], liks_by_idx: dict, p) -> None:
        """Pooled VB-EM of every device-call window of the batch in one
        device dispatch (JAX batched.py:287-320).  Full-decode windows
        keep the host EM."""
        insts, keys = [], []
        for e in staged:
            if e["error"] is not None or e.get("skip"):
                continue
            liks = liks_by_idx.get(e["index"])
            if liks is None or liks[1] is None:
                continue
            view = liks[0]
            filtered, var_cov = filter_haplotypes_dev(
                e["haps"], e["reads"], view, e["ctab"], p,
                p.filter_haplotypes)
            e["_fv"] = (filtered, var_cov)
            rlT, compat, numah = em_inputs(
                e["haps"], e["reads"], view, p, filtered, p.bayes_type)
            if compat.shape[0]:
                insts.append((rlT, compat, numah))
                keys.append(e)
        if insts:
            with self.stats.stage("device_em"):
                res = run_batched_em(insts, p.bayes_a0, p.em_tol,
                                     dtype=self.np_dtype, device=self.device)
            for e, r in zip(keys, res):
                e["_em_res"] = r

    def _call_window(self, e, liks, glf_data, p) -> List[dict]:
        """GLF rows of one window: pooled first, then diploid (the
        reference's order); realigned BAMs diploid first, then pooled,
        to the same file name (DInDel.cpp:498-534, 589-633)."""
        view, dev = liks
        haps, reads = e["haps"], e["reads"]
        on_hap = check_guards_and_on_hap(view, len(haps), len(reads))
        rows: List[dict] = []
        with self.stats.stage("calling"):
            if dev is not None:
                filtered, var_coverage = e.get("_fv") or filter_haplotypes_dev(
                    haps, reads, view, e["ctab"], p, p.filter_haplotypes)
            else:
                filtered, var_coverage = filter_haplotypes(
                    haps, reads, view, p, p.filter_haplotypes)
            if p.estimate_hap_freqs:
                rows.extend(estimate_hap_freqs_bayes_em(
                    haps, reads, view, e["pos"], e["left_pos"],
                    e["right_pos"], glf_data, e["index"], e["candidates"], p,
                    filtered, var_coverage, len(self.bams), p.bayes_type,
                    em_results=e.get("_em_res"))[2])
            if p.do_diploid:
                args = (e["pos"], e["left_pos"], e["right_pos"], glf_data,
                        e["index"])
                try:
                    if dev is not None:
                        rows.extend(diploid_glf_dev(
                            haps, reads, view, dev["base"], dev["site"],
                            *args, e["ctab"], p, filtered, var_coverage,
                            "dip"))
                    else:
                        rows.extend(diploid_glf(
                            haps, reads, view, *args, e["candidates"], p,
                            filtered, var_coverage, "dip"))
                except _WindowThrow as err:
                    raise WindowError(str(err))
            if p.output_realigned_bam:
                for diploid, on in ((True, p.do_diploid),
                                    (False, p.estimate_hap_freqs)):
                    if on:
                        self._write_realigned_bam(
                            e["index"], haps, reads, view, on_hap,
                            e["left_pos"], e["right_pos"], e["candidates"],
                            diploid=diploid, params=p)
        return rows
