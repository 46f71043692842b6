"""dindel_tpu_torch on the card: the CUDA DP kernel and the slab
epilogue's kernels (finish, pair_stats, window_call) against their plain
PyTorch versions (at the edge shapes, C1 and C2, both dtypes and both
folds), and the slab programs (both routes), the dense program
and the per-window backend at a streaming window's shape (float64 exact
and float32 fast), the pooled VB-EM and both engines on CUDA against
the CPU; the sharded slab programs on a mesh of the card (and of two
cards where there are two) against one device, and the hostshard device
server on the card against one process.  Every test is marked ``cuda`` and skips without a CUDA device
(the kernel has no CPU mode).  This file imports no JAX, so it also runs
on a GPU host that has none; tests/conftest.py imports JAX, hence

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

there.  All comparisons are exact, except the VB-EM's (float64, to
1e-9 relative: torch's reductions may associate differently on the
card)."""

import glob

import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_CASES, FOLD_EDGE_CASES, STATS_EDGE_CASES,
                         dp_mismatches, edge_inputs, epilogue_edge_case,
                         epilogue_phase, epilogue_special_phase,
                         stats_edge_case, window_edge_case)
from dindel_tpu_torch.config import ObservationModelParameters, Parameters
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.candidates import get_candidates
from dindel_tpu_torch.engine.window import WindowEngine
from dindel_tpu_torch.hmm.batch import BACKENDS, BatchedPairHMM
from dindel_tpu_torch.hmm.dp_ref import dp_bounds, dp_ref
from dindel_tpu_torch.hmm.expand import expand_compact
from dindel_tpu_torch.hmm.liks import LiksView
from dindel_tpu_torch.hmm.pack import (merge_compact, pack_pairs,
                                       pack_pairs_compact, pad_compact,
                                       tables_to_device)
from dindel_tpu_torch.hmm.slab import (run_packed, run_slab_decode,
                                       run_slab_decode_sharded,
                                       run_slab_stats)
from dindel_tpu_torch.infer.device_em import run_batched_em
from dindel_tpu_torch.io.bam import BamReader
from dindel_tpu_torch.parallel.hostshard import merge_glf, run_hostshard
from dindel_tpu_torch.parallel.mesh import make_mesh, synth_windows
from dindel_tpu_torch.pipeline.windows import make_windows
from dindel_tpu_torch.sim import PlantedVariant, SimConfig, simulate

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _slab(dtype, H_pad=78, max_del=None):
    windows = synth_windows(3, nh=3, nr=12, H=60, L=30, seed=2)
    params = ObservationModelParameters()
    if max_del is not None:
        params.max_length_del = max_del
    return pad_compact(merge_compact([
        pack_pairs_compact(haps, reads, hs, params, dtype, H_pad=H_pad,
                           L_pad=32)
        for haps, reads, hs in windows]))


def _dp_args(pk, device):
    t = tables_to_device(pk, device)
    rc, eq, uq, hc, lpe, lpn = expand_compact(
        pk["H_pad"], pk["L_pad"], t["eq_r"].dtype, t,
        (pk["log_off_hmq"], pk["log_on_hmq"]),
        (pk["log_ins0"], pk["log_ins1"]))[:6]
    return [pk["H_pad"], pk["L_pad"], pk["numT"], t["hap_len"],
            t["read_len"], t["b_mid"], rc, hc, eq, uq, lpe, lpn,
            pk["scalars"]]


@pytest.mark.parametrize("max_del", [None, 13])  # default numT 7, and 15
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("exact_ties", [True, False])
def test_kernel_matches_plain_on_card(cuda, dtype, exact_ties, max_del):
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    pk = _slab(dtype, max_del=max_del)
    args = _dp_args(pk, cuda)
    n0 = pair_hmm_dp.launches
    got = pair_hmm_dp(*args, exact_ties=exact_ties)
    torch.cuda.synchronize()
    assert pair_hmm_dp.launches == n0 + 1
    want = dp_ref(*args, exact_ties=exact_ties)
    L_act, MB, MN = dp_bounds(pk["read_len"], pk["b_mid"], pk["L_pad"])
    assert got[2].dtype == got[3].dtype == torch.uint8
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2][:MB], want[2][:MB])
    assert torch.equal(got[3][MN:L_act - 1], want[3][MN:L_act - 1])


@pytest.mark.parametrize("case", [kw for _, kw in EDGE_CASES],
                         ids=[name for name, _ in EDGE_CASES])
@pytest.mark.parametrize("exact_ties", [True, False])
def test_kernel_matches_plain_at_edge_shapes(cuda, case, exact_ties):
    """S_half not a multiple of 32, odd and up to 1024; numT 2..15; B not
    a multiple of the pairs per block; b_mid at 0 and at read_len-1; a
    zero-length hap; float64 (chip_smoke.EDGE_CASES)."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    args, bounds = edge_inputs(device=cuda, **case)
    got = pair_hmm_dp(*args, exact_ties=exact_ties, bounds=bounds)
    want = dp_ref(*args, exact_ties=exact_ties, bounds=bounds)
    torch.cuda.synchronize()
    assert dp_mismatches(got, want, bounds) == []


def test_kernel_rejects_what_it_cannot_take(cuda):
    """S_half over 1024 and numT over 15 raise; no fallback to dp_ref."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    args, bounds = edge_inputs(device=cuda, B=2, H_pad=1023, L_pad=16,
                               numT=7, dtype="float32", seed=1)
    with pytest.raises(ValueError, match="S_half"):
        pair_hmm_dp(*args, bounds=bounds)
    args, bounds = edge_inputs(device=cuda, B=2, H_pad=30, L_pad=16,
                               numT=7, dtype="float32", seed=1)
    args[2] = 16
    with pytest.raises(ValueError, match="numT"):
        pair_hmm_dp(*args, bounds=bounds)


# K1's edge shapes in both folds, then pair_stats's own edge rows (no fold)
EPILOGUE_EDGE = ([(ex, name, kw) for ex in (True, False)
                  for name, kw in EDGE_CASES]
                 + [(False, name, kw) for name, kw in STATS_EDGE_CASES])


@pytest.mark.parametrize("exact_ties,case", [(ex, kw) for ex, _, kw in
                                             EPILOGUE_EDGE],
                         ids=[f"{ex}-{name}" for ex, name, _ in EPILOGUE_EDGE])
def test_epilogue_kernels_match_plain_at_edge_shapes(cuda, case, exact_ties):
    """finish (with read_len on the consumed columns, without it on every
    column) and pair_stats (V = 4 and V = 0) on K1's outputs at K1's
    edge shapes; pair_stats at its edge rows (chip_smoke.STATS_EDGE_CASES:
    L_pad 33-200, V 0/1/8, ins runs and repeated event positions across
    column 32, read_len 0 and above L_pad, hap_len 0, NaN, +-inf and
    -0.0 log10q terms); kernel vs plain on the card: bit-equal, NaN equal
    to NaN."""
    if "V" in case:
        assert stats_edge_case(case, cuda) == []
    else:
        assert epilogue_edge_case(case, exact_ties, cuda) == []


@pytest.mark.parametrize("case", FOLD_EDGE_CASES)
def test_window_call_kernel_matches_plain_at_edge_shapes(cuda, case):
    assert window_edge_case(case, cuda)[0] == 0


def test_epilogue_kernels_match_plain_on_special_values(cuda):
    """finish on rows with ties and near-ties across lanes, NaN, +-0.0 at
    the maximum and all -inf (both folds, both types), window_call with
    NaN terms, signed-zero seeds and nr_w outside [0, NR]: kernel vs
    plain on the card, NaN equal to NaN."""
    assert epilogue_special_phase(cuda) == []


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_windows", [1, 4], ids=["C1", "C2"])
def test_epilogue_kernels_match_plain_at_c1_c2(cuda, n_windows, dtype):
    """C1 (6144 pairs) and C2 (24576), both folds: each kernel bit-equal
    to its plain version (epilogue_phase raises otherwise), and each
    wrapper counts its launches."""
    from dindel_tpu_torch.hmm import epilogue_kernel as ek

    n0 = [w.launches for w in (ek.finish, ek.pair_stats, ek.window_call)]
    rows = epilogue_phase(f"C{n_windows}", n_windows, n_windows, cuda,
                          reps=1, plain_reps=1, dtype=dtype)
    assert set(rows) == {"finish", "pair_stats", "window_call"}
    assert rows["window_call"]["max_ulps"] == 0
    n1 = [w.launches for w in (ek.finish, ek.pair_stats, ek.window_call)]
    assert all(b > a for a, b in zip(n0, n1))


def test_epilogue_kernels_raise_without_fallback(cuda):
    """What a kernel cannot take raises on the card; nothing falls back
    to the plain version."""
    from dindel_tpu_torch.hmm import epilogue_kernel as ek

    args, bounds = edge_inputs(device=cuda, B=3, H_pad=30, L_pad=16,
                               numT=7, dtype="float32", seed=1)
    amid, bmid, btf, btb = dp_ref(*args, bounds=bounds)
    n0 = ek.finish.launches
    with pytest.raises(ValueError, match="numT"):
        ek.finish(30, 16, 16, args[5], args[3], amid, bmid, amid, amid, amid,
                  btf, btb)
    with pytest.raises(TypeError, match="obs_mid"):
        ek.finish(30, 16, 7, args[5], args[3], amid, bmid, amid.double(),
                  amid, amid, btf, btb)
    assert ek.finish.launches == n0


def _vtab_cm(pk):
    n = pk["hap_codes_h"].shape[0]
    rng = np.random.RandomState(5)
    left = rng.randint(-4, 50, size=(n, 4)).astype(np.int32)
    vtab = dict(v_left_h=left,
                v_right_h=(left + rng.randint(0, 8, size=(n, 4))
                           ).astype(np.int32),
                v_isdel_h=rng.rand(n, 4) < 0.5,
                v_valid_h=rng.rand(n, 4) < 0.8)
    cm = dict(W=8, NH=4, S=4, NR=64, index_map=np.zeros((8, 4, 64), np.int32),
              nr_w=np.zeros(8, np.int32),
              pair_pr=np.zeros((8, 4, 10), np.float32))
    return vtab, cm


@pytest.mark.parametrize("exact_ties", [True, False])
def test_run_slab_stats_card_equals_cpu(cuda, exact_ties):
    pk = _slab(np.float32)
    vtab, cm = _vtab_cm(pk)
    cpu = run_slab_stats(pk, vtab, cm, 2, exact_ties, False, "cpu")
    gpu = run_slab_stats(pk, vtab, cm, 2, exact_ties, False, cuda)
    for c, g in zip(cpu[:4], gpu[:4]):
        assert torch.equal(c, g.cpu())


def test_slab_decode_and_liks_view_card_equals_cpu(cuda):
    """The full-decode route: run_slab_decode's planes, and every
    LiksView array over them, on the consumed columns."""
    windows = synth_windows(3, nh=3, nr=12, H=60, L=30, seed=2)
    params = ObservationModelParameters()
    pks = [pack_pairs_compact(haps, reads, hs, params, np.float32, H_pad=78,
                              L_pad=32) for haps, reads, hs in windows]
    merged = pad_compact(merge_compact(pks))
    planes = {}
    for dev in ("cpu", cuda):
        planes[str(dev)] = [t.cpu().numpy()
                            for t in run_slab_decode(merged, False, dev)]
    cpu, gpu = planes["cpu"], planes[str(cuda)]
    for c, g in zip(cpu[:5], gpu[:5]):
        assert c.dtype == g.dtype and np.array_equal(c, g)
    off = 0
    for (haps, reads, _), pk in zip(windows, pks):
        B = pk["hap_len"].shape[0]
        dense = dict(H_pad=pk["H_pad"], L_pad=pk["L_pad"],
                     hap_len=pk["hap_len"], read_len=pk["read_len"],
                     hap_codes=pk["hap_codes_h"][pk["hap_idx"]],
                     read_codes=pk["read_codes_r"][pk["read_idx"]])
        valid = (np.arange(pk["L_pad"])[None, :]
                 < pk["read_len"][:, None])
        assert np.array_equal(cpu[5][off:off + B][valid],
                              gpu[5][off:off + B][valid])
        vc, vg = [LiksView(haps, reads, dense,
                           *[a[off:off + B] for a in pl], params)
                  for pl in (cpu, gpu)]
        for k in ("fb", "lb", "n_bqt", "n_mm_bqt", "n_mm_left",
                  "n_mm_right", "num_mm", "m_log_bq", "has_event",
                  "any_mism"):
            assert np.array_equal(getattr(vc, k), getattr(vg, k)), k
        for k in ("xs", "hpos_all"):
            assert np.array_equal(getattr(vc, k)[valid],
                                  getattr(vg, k)[valid]), k
        assert vc.materialize() == vg.materialize()
        off += B


def test_device_em_card_equals_cpu_f64(cuda):
    rng = np.random.RandomState(3)
    insts = []
    for _ in range(9):
        nr, nh = rng.randint(5, 90), rng.randint(2, 7)
        compat = rng.rand(rng.randint(1, 4), nh) < 0.7
        compat[:, 0] = True
        insts.append((-np.abs(rng.randn(nr, nh)) * rng.uniform(1, 30),
                      compat, compat.sum(axis=1).astype(np.float64)))
    cpu = run_batched_em(insts, 0.001, 1e-4, dtype=np.float64, device="cpu")
    gpu = run_batched_em(insts, 0.001, 1e-4, dtype=np.float64, device=cuda)
    for wc, wg in zip(cpu, gpu):
        assert len(wc) == len(wg)
        for (lc, pc), (lg, pg) in zip(wc, wg):
            np.testing.assert_allclose(lg, lc, rtol=1e-9)
            np.testing.assert_allclose(pg, pc, rtol=1e-9)


def _ra_records(prefix):
    return [(p[len(prefix):], [(r.qname, r.pos, r.cigar, r.flag)
                               for r in BamReader(p)])
            for p in sorted(glob.glob(prefix + ".ra.*.bam"))]


@pytest.mark.parametrize("realigned", [False, True])
def test_engine_card_equals_cpu(cuda, tmp_path, realigned):
    """The shipped configuration (fast ties, float32, host folds) on the
    card writes the same GLF bytes as on the CPU, through the kernel; with
    --outputRealignedBAM (the full-decode route) the same BAM records."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    variants = [PlantedVariant(pos=600, var="-ACG", genotype=1),
                PlantedVariant(pos=1400, var="+TT", genotype=2)]
    fa, bam = simulate(str(tmp_path / "sim"), variants,
                       SimConfig(ref_len=2000, coverage=12, read_len=50),
                       seed=9)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    win_files = make_windows(var_file, str(tmp_path / "win"))
    glfs, bams = [], []
    for dev in ("cpu", "cuda"):
        params = Parameters()
        params.do_diploid = True
        params.output_realigned_bam = realigned
        params.file_name = str(tmp_path / dev)
        eng = BatchedWindowEngine([bam], fa, params, device=dev,
                                  dtype=np.float32, device_folds=False)
        n0 = pair_hmm_dp.launches
        glf = str(tmp_path / f"{dev}.glf.txt")
        for wf in win_files:
            eng.detect_indels(wf, glf)
        eng.close()
        assert eng.stats.counts.get("slab.rescues", 0) == 0
        glfs.append(open(glf).read())
        bams.append(_ra_records(str(tmp_path / dev)))
    assert pair_hmm_dp.launches > n0
    assert "dip.map" in glfs[0]
    assert glfs[0] == glfs[1]
    assert bool(bams[0]) == realigned
    assert bams[0] == bams[1]


def _streaming_window():
    """One window at a streaming window's shape: 5 haps x 64 reads,
    H 160, L 100 (phase 4 of chip_smoke.py)."""
    (haps, reads, hs), = synth_windows(1, nh=5, nr=64, H=160, L=100, seed=3)
    return haps, reads, hs


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_run_packed_card_equals_cpu(cuda, backend):
    """The dense program (K1 + finish) in float64 exact ties ('jax') and
    float32 fast ties ('pallas'): one kernel launch; the five scalar
    planes equal, map_state equal inside each read."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    dtype, exact = BACKENDS[backend]
    haps, reads, hs = _streaming_window()
    pk = pack_pairs(haps, reads, hs, ObservationModelParameters(), dtype)
    n0 = pair_hmm_dp.launches
    gpu = [t.cpu().numpy() for t in run_packed(pk, exact, cuda)]
    assert pair_hmm_dp.launches == n0 + 1
    cpu = [t.numpy() for t in run_packed(pk, exact, "cpu")]
    for c, g in zip(cpu[:5], gpu[:5]):
        assert c.dtype == g.dtype and np.array_equal(c, g)
    valid = np.arange(pk["L_pad"])[None, :] < pk["read_len"][:, None]
    assert np.array_equal(cpu[5][valid], gpu[5][valid])


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_batched_pair_hmm_card_equals_cpu(cuda, backend):
    dtype, exact = BACKENDS[backend]
    haps, reads, hs = _streaming_window()
    views = [BatchedPairHMM(ObservationModelParameters(), dtype,
                            exact_ties=exact, device=dev).compute(
                                haps, reads, hs)
             for dev in ("cpu", cuda)]
    for k in ("ll2d", "off_hap2d", "off_hap_hmq2d"):
        assert np.array_equal(getattr(views[0], k), getattr(views[1], k))
    assert views[0].materialize() == views[1].materialize()


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_streaming_engine_card_equals_cpu(cuda, tmp_path, backend):
    """The streaming engine writes the same GLF bytes on the card as on
    the CPU, one kernel launch per scored window."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    fa, bam = simulate(str(tmp_path / "sim"),
                       [PlantedVariant(pos=600, var="-ACG", genotype=1),
                        PlantedVariant(pos=1400, var="+TT", genotype=2)],
                       SimConfig(ref_len=2000, coverage=12, read_len=50),
                       seed=9)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    wf = make_windows(var_file, str(tmp_path / "win"))[0]
    glfs = []
    for dev in ("cpu", "cuda"):
        params = Parameters()
        params.do_diploid = True
        params.file_name = str(tmp_path / dev)
        eng = WindowEngine([bam], fa, params, hmm_backend=backend,
                           device=dev)
        n0 = pair_hmm_dp.launches
        eng.detect_indels(wf, params.file_name + ".glf.txt")
        eng.close()
        glfs.append(open(params.file_name + ".glf.txt").read())
    assert eng.stats.windows_ok >= 2
    assert pair_hmm_dp.launches - n0 >= 2
    assert "dip.map" in glfs[0]
    assert glfs[0] == glfs[1]


def _sharded_equals_single(devices, exact_ties):
    """Both compact routes sharded over a 2x2 (or 2x1) mesh of `devices`
    against one device: the DP kernel launched once per shard, outputs
    equal (map_state on each pair's read columns)."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    mesh = make_mesh(len(devices) // 2, 2, devices)
    pk = _slab(np.float32)
    want = run_slab_decode(pk, exact_ties, mesh.first)
    n0 = pair_hmm_dp.launches
    got = run_slab_decode_sharded(pk, exact_ties, mesh)
    torch.cuda.synchronize()
    assert pair_hmm_dp.launches == n0 + mesh.size
    valid = (torch.arange(pk["L_pad"], device=mesh.first)[None, :]
             < torch.from_numpy(pk["read_len"]).to(mesh.first)[:, None])
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.device == mesh.first and w.dtype == g.dtype
        if i == 5:
            w, g = w.masked_fill(~valid, -1), g.masked_fill(~valid, -1)
        assert torch.equal(w, g)
    vtab, cm = _vtab_cm(pk)
    want = run_slab_stats(pk, vtab, cm, 2, exact_ties, False, mesh.first)
    got = run_slab_stats(pk, vtab, cm, 2, exact_ties, False, mesh.first,
                         mesh=mesh)
    for w, g in zip(want[:4], got[:4]):
        assert torch.equal(w, g)


@pytest.mark.parametrize("exact_ties", [True, False])
def test_sharded_slab_on_one_card_equals_single(cuda, exact_ties):
    _sharded_equals_single([torch.device("cuda", 0)] * 4, exact_ties)


def test_sharded_slab_on_two_cards_equals_single(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _sharded_equals_single([torch.device("cuda", 0), torch.device("cuda", 1)],
                           False)


def test_hostshard_on_card_equals_one_process(cuda, tmp_path):
    """Two staging processes feed this process's card: the merged GLF
    equals one engine's on the card over the same window files, the
    kernel ran here, and no staging process initialized CUDA or rescued
    a slab."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    fa, bam = simulate(str(tmp_path / "sim"),
                       [PlantedVariant(pos=550 + i * 620, var="-AC",
                                       genotype=1) for i in range(4)],
                       SimConfig(ref_len=560 + 4 * 620, coverage=15,
                                 read_len=70), seed=23)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    win_files = make_windows(var_file, str(tmp_path / "win"),
                             variants_per_file=2)
    params = Parameters()
    params.do_diploid = True
    params.file_name = str(tmp_path / "seq")
    eng = BatchedWindowEngine([bam], fa, params, device="cuda")
    parts = [str(tmp_path / f"seq.{i}") for i in range(len(win_files))]
    for wf, part in zip(win_files, parts):
        eng.detect_indels(wf, part)
    eng.close()
    merge_glf(parts, str(tmp_path / "seq.glf.txt"))
    params.file_name = str(tmp_path / "shard")
    stats = {}
    n0 = pair_hmm_dp.launches
    run_hostshard([bam], fa, params, win_files,
                  str(tmp_path / "shard.glf.txt"), n_procs=2,
                  stats_out=stats, device="cuda")
    assert pair_hmm_dp.launches > n0
    assert stats["slab_rescues"] == 0
    for st in stats["per_proc"]:
        assert st["cuda_initialized"] is False
        assert st["counts"].get("slab.rescues", 0) == 0
    got = open(tmp_path / "shard.glf.txt").read()
    assert "dip.map" in got
    assert got == open(tmp_path / "seq.glf.txt").read()


def test_engine_mesh_on_four_cards_equals_single(cuda, tmp_path):
    """The batched engine on a 2x2 mesh of four distinct cards writes the
    single-card GLF, launching the kernel once per shard of every slab."""
    from dindel_tpu_torch.hmm.dp_kernel import pair_hmm_dp

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    fa, bam = simulate(str(tmp_path / "sim"),
                       [PlantedVariant(pos=600, var="-ACG", genotype=1),
                        PlantedVariant(pos=1400, var="+TT", genotype=2)],
                       SimConfig(ref_len=2000, coverage=12, read_len=50),
                       seed=9)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    wf = make_windows(var_file, str(tmp_path / "win"))[0]
    glfs, launches = [], []
    for tag, mesh in (("single", None), ("mesh", make_mesh(2, 2))):
        params = Parameters()
        params.do_diploid = True
        params.file_name = str(tmp_path / tag)
        eng = BatchedWindowEngine([bam], fa, params, device="cuda",
                                  mesh=mesh, max_pairs_per_slab=2048)
        n0 = pair_hmm_dp.launches
        eng.detect_indels(wf, params.file_name + ".glf.txt")
        eng.close()
        assert eng.stats.counts.get("slab.rescues", 0) == 0
        launches.append(pair_hmm_dp.launches - n0)
        glfs.append(open(params.file_name + ".glf.txt").read())
    assert "dip.map" in glfs[0]
    assert glfs[0] == glfs[1]
    assert launches[0] > 0 and launches[1] == 4 * launches[0]
