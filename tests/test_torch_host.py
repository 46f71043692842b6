"""dindel_tpu_torch host code vs the JAX package's originals.

The port copies the JAX-free host code that sits in modules importing
JAX (packing, call tables, host folds, the device-call filter and
diploid caller, LiksStats, the guards); each copy is held byte-equal to
its original on the sim windows of tests/test_device_call.py.  A
subprocess with ``jax`` and ``dindel_tpu`` blocked runs the port's CLI
end to end on the CPU: the GPU host has no JAX, and the port carries
its own copy of every host module it runs."""

import io
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import dindel_tpu.hmm.batch as jbatch
import dindel_tpu.infer.device_call as jdc
from dindel_tpu.config import Parameters
from dindel_tpu.engine.reads import WindowError
from dindel_tpu.engine.window import check_guards_and_on_hap as jax_guards
from dindel_tpu.out.glf import make_glf_output
from dindel_tpu.parallel.mesh import synth_windows as jax_synth
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.reads import WindowError as PortWindowError
from dindel_tpu_torch.engine.window import check_guards_and_on_hap
from dindel_tpu_torch.hmm import pack
from dindel_tpu_torch.hmm.liks import LiksStats
from dindel_tpu_torch.infer import device_call as tdc
from dindel_tpu_torch.parallel import mesh
from test_device_call import _sim
from test_torch_engine import no_slab_rescues  # noqa: F401 (autouse)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The good windows of the seed-3 device-call sim, staged by the
    port's engine (f32, fast ties, host folds), plus its slab results."""
    tmp = tmp_path_factory.mktemp("host")
    fa, bam, wfs = _sim(tmp, 3)
    params = Parameters()
    params.do_diploid = True
    eng = BatchedWindowEngine([bam], fa, params, device="cpu",
                              dtype=np.float32, device_folds=False,
                              max_pairs_per_slab=4096)
    entries = [e for wf in wfs for e in eng.staged_windows(wf)
               if e["error"] is None and not e["skip"] and e["haps"]]
    batch = eng._dispatch_batch(entries)
    liks = {}
    for item in batch["items"]:
        eng._finish_slab(item, liks, batch["params"])
    eng.close()
    assert len(entries) >= 4
    return entries, liks, batch["params"]


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        assert np.array_equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, what


def _packs(entries, mod, dtype):
    out = []
    for e in entries:
        H_max = max(h.size() for h in e["haps"])
        L_max = max(r.size() for r in e["reads"])
        out.append(mod.pack_pairs_compact(
            e["haps"], e["reads"], e["left_pos"], Parameters().obs_params,
            dtype, H_pad=pack._round_up(H_max, 16),
            L_pad=pack._round_up(L_max, 16)))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_pairs_compact_equal(staged, dtype):
    entries, _, _ = staged
    for want, got in zip(_packs(entries, jbatch, dtype),
                         _packs(entries, pack, dtype)):
        assert want.keys() == got.keys()
        for k in want:
            _assert_same(want[k], got[k], k)


def test_merge_and_pad_compact_equal(staged):
    entries, _, _ = staged
    # one slab needs one H_pad/L_pad: pack every window at the widest
    H_pad = pack._round_up(max(h.size() for e in entries
                               for h in e["haps"]), 16)
    L_pad = pack._round_up(max(r.size() for e in entries
                               for r in e["reads"]), 16)
    res = []
    for mod in (jbatch, pack):
        pks = [mod.pack_pairs_compact(e["haps"], e["reads"], e["left_pos"],
                                      Parameters().obs_params, np.float32,
                                      H_pad=H_pad, L_pad=L_pad)
               for e in entries]
        res.append(mod.pad_compact(mod.merge_compact(pks)))
    want, got = res
    assert want.keys() == got.keys()
    for k in want:
        _assert_same(want[k], got[k], k)
    t = pack.tables_to_device(got, "cpu")
    for k, v in t.items():
        assert np.array_equal(v.numpy(), got[k]), k


def test_build_call_tables_equal(staged):
    entries, _, params = staged
    for e in entries:
        want = jdc.build_call_tables(e["haps"], e["candidates"],
                                     e["left_pos"], params)
        got = tdc.build_call_tables(e["haps"], e["candidates"],
                                    e["left_pos"], params)
        assert want.keys() == got.keys()
        for k in want:
            if k != "find_variant":  # a closure over the candidates
                _assert_same(want[k], got[k], k)


def test_host_window_folds_equal(staged):
    entries, liks, _ = staged
    for e in entries:
        view, _dev = liks[e["index"]]
        for w, g in zip(jdc.host_window_folds(view.ll2d, e["ctab"]),
                        tdc.host_window_folds(view.ll2d, e["ctab"])):
            _assert_same(w, g, "host folds")
    assert tdc.pair_enum(5)[0].tolist() == jdc.pair_enum(5)[0].tolist()
    assert tdc.pair_enum(5)[1].tolist() == jdc.pair_enum(5)[1].tolist()


def test_filter_and_diploid_glf_dev_equal(staged):
    entries, liks, params = staged
    n_rows = 0
    for e in entries:
        view, dev = liks[e["index"]]
        params.tid = e["tid"]
        outs = []
        for mod in (jdc, tdc):
            filtered, var_cov = mod.filter_haplotypes_dev(
                e["haps"], e["reads"], view, e["ctab"], params,
                params.filter_haplotypes)
            buf = io.StringIO()
            glf = make_glf_output(buf)
            rows = mod.diploid_glf_dev(
                e["haps"], e["reads"], view, dev["base"], dev["site"],
                e["pos"], e["left_pos"], e["right_pos"], glf, e["index"],
                e["ctab"], params, filtered, var_cov, "dip")
            outs.append((filtered, var_cov, rows, buf.getvalue()))
        assert outs[0] == outs[1]
        n_rows += len(outs[1][2])
    assert n_rows > 0


def test_liks_stats_and_guards_equal(staged):
    entries, liks, params = staged
    e = entries[0]
    view, _ = liks[e["index"]]
    fields = {k: getattr(view, k) for k in (
        "ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on", "fb", "lb",
        "n_bqt", "n_mm_bqt", "m_log_bq", "n_mm_left", "n_mm_right",
        "num_mm", "has_event", "any_mism", "cov_ok")}
    fields["n_ind"] = view._n_ind
    args = (e["haps"], e["reads"], params.obs_params, view.read_len,
            view._hap_len, fields)
    jv, tv = jbatch.LiksStats(*args), LiksStats(*args)
    for k in [f for f in fields if f != "n_ind"] + ["ll2d", "off_hap2d",
                                                     "off_hap_hmq2d"]:
        _assert_same(getattr(jv, k), getattr(tv, k), k)
    for h in range(tv.nh):
        _assert_same(jv.n_indel_entries_row(h), tv.n_indel_entries_row(h),
                     "n_ind")
    nh, nr = tv.nh, tv.nr
    assert (check_guards_and_on_hap(tv, nh, nr) == jax_guards(jv, nh, nr))
    # each package raises its own WindowError class
    for bad, exc in ((float("nan"), (WindowError, PortWindowError)),
                     (0.5, (RuntimeError, RuntimeError))):
        f2 = dict(fields, ll=fields["ll"].copy())
        f2["ll"][3] = bad
        for guard, cls, e in ((check_guards_and_on_hap, LiksStats, exc[1]),
                              (jax_guards, jbatch.LiksStats, exc[0])):
            with pytest.raises(e):
                guard(cls(*args[:5], f2), nh, nr)


def test_synth_windows_equal():
    for (jh, jr, js), (th, tr, ts) in zip(
            jax_synth(2, nh=3, nr=7, H=50, L=20, seed=4),
            mesh.synth_windows(2, nh=3, nr=7, H=50, L=20, seed=4)):
        assert js == ts
        assert [h.seq for h in jh] == [h.seq for h in th]
        assert [(r.seq, r.map_qual, r.pos_stat_first) for r in jr] == \
            [(r.seq, r.map_qual, r.pos_stat_first) for r in tr]
        assert all(np.array_equal(a.qual, b.qual) for a, b in zip(jr, tr))


_NO_JAX = textwrap.dedent("""
    import glob
    import sys
    # every `import jax` / `import dindel_tpu...` now raises ImportError
    sys.modules["jax"] = None
    sys.modules["dindel_tpu"] = None
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)  # the test runs beside other workers
    import dindel_tpu_torch
    from dindel_tpu_torch import cli
    from dindel_tpu_torch.engine.batched import BatchedWindowEngine
    from dindel_tpu_torch.sim import PlantedVariant, SimConfig, simulate
    from dindel_tpu_torch.engine import window
    _close = window.WindowEngine.close

    def _checked(eng):  # every engine must close with no slab rescued
        _close(eng)
        assert not eng.stats.counts.get("slab.rescues"), "rescue"
    window.WindowEngine.close = _checked

    fa, bam = simulate("sim", [PlantedVariant(pos=500, var="-AC",
                                              genotype=1)],
                       SimConfig(ref_len=1200, coverage=10, read_len=50),
                       seed=1)
    assert cli.main(["--analysis", "getCIGARindels", "--bamFile", bam,
                     "--ref", fa, "--outputFile", "cand"]) == 0
    assert cli.main(["--analysis", "makeWindows", "--inputVarFile",
                     "cand.variants.txt", "--windowFilePrefix", "win"]) == 0
    def indels(out, *extra):
        assert cli.main(["--analysis", "indels", "--engine", "batched",
                         "--hmmBackend", "pallas", "--device", "cpu",
                         "--bamFile", bam, "--ref", fa, "--varFile",
                         "win.1.txt", "--outputFile", out, *extra]) == 0
        return open(out + ".glf.txt").read()

    glf = indels("out", "--doDiploid")
    assert "dip" in glf, glf
    # the full-decode route (LiksView, host callers, realigned BAMs)
    glf = indels("ra", "--doDiploid", "--outputRealignedBAM", "--opl")
    assert "dip.map" in glf, glf
    assert glob.glob("ra.ra.*.bam") and glob.glob("ra.check.txt")
    # the pooled caller with its device EM, beside the diploid caller
    glf = indels("pooled", "--doPooled", "--doDiploid")
    assert "singlevariant" in glf and "dip.map" in glf, glf
    assert sys.modules["jax"] is None and sys.modules["dindel_tpu"] is None
    assert not [m for m in sys.modules
                if m.startswith(("jax.", "jaxlib", "dindel_tpu."))]
    print("NO_JAX_OK")
""")


def test_port_runs_without_jax(tmp_path):
    res = subprocess.run([sys.executable, "-c", _NO_JAX.format(repo=str(REPO))],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout
