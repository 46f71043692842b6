"""dindel_tpu_torch's mesh path (parallel/mesh.py, the sharded slab
programs, the engine's and the CLI's --mesh, entry.py) on the CPU, held
to itself unsharded and to dindel_tpu on the same seeded inputs.  The
JAX side runs on the 8 virtual CPU devices of tests/conftest.py with
x64; the port's meshes repeat the CPU device.

Tolerances: every comparison is exact (map_state on each pair's read
columns, the only defined ones) except G against the JAX window step,
within 1e-12 relative in float64 (torch's and XLA's logaddexp and sum
differ by ulps), and entry()'s ll against __graft_entry__.entry()'s,
within 1e-5 relative in float32."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dindel_tpu.config import ObservationModelParameters as JaxObsParams
from dindel_tpu.config import Parameters as JaxParameters
from dindel_tpu.engine.batched import BatchedWindowEngine as JaxEngine
from dindel_tpu.hmm.batch import merge_compact as jax_merge
from dindel_tpu.hmm.batch import pack_pairs_compact as jax_pack_compact
from dindel_tpu.hmm.batch import pad_compact as jax_pad
from dindel_tpu.hmm.batch import run_packed_compact_sharded
from dindel_tpu.parallel import mesh as jax_mesh
from dindel_tpu_torch import cli, entry
from dindel_tpu_torch.config import ObservationModelParameters, Parameters
from dindel_tpu_torch.engine.batched import BatchedWindowEngine
from dindel_tpu_torch.engine.candidates import get_candidates
from dindel_tpu_torch.hmm.pack import (merge_compact, pack_pairs_compact,
                                       pad_compact)
from dindel_tpu_torch.hmm.slab import (run_slab_decode,
                                       run_slab_decode_sharded,
                                       run_slab_stats)
from dindel_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                            pack_window_batch,
                                            sharded_window_step,
                                            synth_windows)
from dindel_tpu_torch.pipeline.windows import make_windows
from dindel_tpu_torch.sim import PlantedVariant, SimConfig, simulate
from test_torch_engine import no_slab_rescues  # noqa: F401
from test_torch_slab import _callmeta, _vtab

torch.set_num_threads(1)

CPU = torch.device("cpu")
OUTS = ("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on", "map_state")


def _cpu_mesh(n_dp, n_rp):
    return make_mesh(n_dp, n_rp, [CPU] * (n_dp * n_rp))


def _slab(dtype, H_pad=62, pad=False):
    """Two windows of 3 haps x 12 reads and one of 1 hap x 13 reads: 85
    pairs, a multiple of none of 2, 3 and 8."""
    windows = (synth_windows(2, nh=3, nr=12, H=48, L=30, seed=4)
               + synth_windows(1, nh=1, nr=13, H=44, L=30, seed=5))
    params = ObservationModelParameters()
    merged = merge_compact([
        pack_pairs_compact(haps, reads, hs, params, dtype, H_pad=H_pad,
                           L_pad=32)
        for haps, reads, hs in windows])
    return pad_compact(merged) if pad else merged


def _assert_outs_equal(want, got, read_len):
    valid = np.arange(want[5].shape[1])[None, :] < np.asarray(read_len)[:, None]
    for nm, w, g in zip(OUTS, want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert w.dtype == g.dtype and w.shape == g.shape, nm
        if nm == "map_state":
            w, g = w[valid], g[valid]
        assert np.array_equal(w, g), nm


def test_make_mesh():
    m = _cpu_mesh(4, 2)
    assert isinstance(m, Mesh) and m.shape == (4, 2) and m.size == 8
    assert m.axis_names == ("dp", "rp") and m.first == CPU
    with pytest.raises(RuntimeError, match="need 8 devices"):
        make_mesh(4, 2, [CPU] * 7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
            make_mesh(2, 1)


@pytest.mark.parametrize("dtype,exact", [(np.float32, False),
                                         (np.float64, True)])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_sharded_slab_bit_equal_single(n_dev, dtype, exact):
    pk = _slab(dtype)
    assert pk["hap_idx"].shape[0] == 85
    want = [t.numpy() for t in run_slab_decode(pk, exact, CPU)]
    got = [t.numpy() for t in run_slab_decode_sharded(
        pk, exact, _cpu_mesh(n_dev, 1))]
    _assert_outs_equal(want, got, pk["read_len"])


def test_sharded_slab_matches_jax_sharded_f64():
    """float64, exact ties: bit-equal to run_packed_compact_sharded on
    JAX's 4x2 mesh of virtual CPU devices."""
    windows = synth_windows(3, nh=3, nr=12, H=60, L=30, seed=2)
    merged_j = jax_pad(jax_merge([
        jax_pack_compact(haps, reads, hs, JaxObsParams(), np.float64,
                         H_pad=78, L_pad=32)
        for haps, reads, hs in jax_mesh.synth_windows(3, nh=3, nr=12, H=60,
                                                      L=30, seed=2)]))
    want = [np.asarray(o) for o in run_packed_compact_sharded(
        merged_j, "xla", jax_mesh.make_mesh(4, 2))]
    merged = pad_compact(merge_compact([
        pack_pairs_compact(haps, reads, hs, ObservationModelParameters(),
                           np.float64, H_pad=78, L_pad=32)
        for haps, reads, hs in windows]))
    got = [t.numpy() for t in run_slab_decode_sharded(merged, True,
                                                      _cpu_mesh(4, 2))]
    _assert_outs_equal(want, got, merged["read_len"])


@pytest.mark.parametrize("device_folds", [False, True])
def test_run_slab_stats_mesh_equals_single(device_folds):
    pk = _slab(np.float64, H_pad=78, pad=True)
    vtab, cm = _vtab(pk), _callmeta(np.float64)
    want = run_slab_stats(pk, vtab, cm, 2, True, device_folds, CPU)
    got = run_slab_stats(pk, vtab, cm, 2, True, device_folds, CPU,
                         mesh=_cpu_mesh(2, 2))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and torch.equal(w, g)


def _window_batch(n_dp, n_rp):
    nr = 4 * n_rp + 1  # uneven over rp
    return (synth_windows(2 * n_dp, 3, nr, H=48, L=32),
            jax_mesh.synth_windows(2 * n_dp, 3, nr, H=48, L=32))


def test_sharded_window_step_matches_jax():
    """The dp x rp window step against JAX's on a 4x2 mesh with an
    uneven read count: the packed batch byte-equal, ll bit-equal, G
    within 1e-12, and G bit-equal to the port's own fold of each rp
    partial added in rp order."""
    n_dp, n_rp = 4, 2
    wins, jwins = _window_batch(n_dp, n_rp)
    args, H_pad, L_pad, numT, nh = pack_window_batch(
        wins, ObservationModelParameters(), dtype=np.float64, n_rp=n_rp)
    jargs, *jdims = jax_mesh.pack_window_batch(
        jwins, JaxObsParams(), dtype=np.float64, n_rp=n_rp)
    assert [H_pad, L_pad, numT, nh] == jdims
    for a, b in zip(args, jargs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jm = jax_mesh.make_mesh(n_dp, n_rp)
    with jm:
        ll_j, G_j = jax_mesh.sharded_window_step(
            jm, H_pad, L_pad, numT, nh)(*[jnp.asarray(a) for a in jargs])
    ll, G = sharded_window_step(_cpu_mesh(n_dp, n_rp), H_pad, L_pad, numT,
                                nh)(*args)
    assert ll.shape == (2 * n_dp, nh, 10) and G.shape == (2 * n_dp, nh, nh)
    assert np.array_equal(ll.numpy(), np.asarray(ll_j))
    np.testing.assert_allclose(G.numpy(), np.asarray(G_j), rtol=1e-12)

    mask = torch.from_numpy(args[14]).reshape(2 * n_dp, n_rp, nh, 5)
    fold = None
    for j in range(n_rp):
        lj = ll[:, :, 5 * j:5 * (j + 1)]
        pair = torch.logaddexp(lj[:, :, None, :], lj[:, None, :, :]) \
            + math.log(0.5)
        part = torch.where(mask[:, j][:, :, None, :], pair,
                           torch.zeros((), dtype=pair.dtype)).sum(-1)
        fold = part if fold is None else fold + part
    assert torch.equal(G, fold)


def test_dryrun_multichip_8_cpu():
    entry.dryrun_multichip(8, [CPU] * 8)


def test_entry_matches_graft_entry():
    import __graft_entry__ as graft

    fn, args = entry.entry(device="cpu")
    assert all(isinstance(a, torch.Tensor) and a.device == CPU
               for a in args)
    ll = fn(*args)[0].numpy()
    assert ll.dtype == np.float32 and np.isfinite(ll).all()
    jfn, jargs = graft.entry()
    want = np.asarray(jax.jit(jfn)(*[jnp.asarray(a) for a in jargs])[0])
    np.testing.assert_allclose(ll, want, rtol=1e-5)


@pytest.fixture(scope="module")
def mesh_sim(tmp_path_factory):
    """The sim of tests/test_parallel.py::test_engine_sharded_step_bit_equal."""
    tmp = tmp_path_factory.mktemp("mesh")
    variants = [PlantedVariant(pos=700, var="-ACG", genotype=1),
                PlantedVariant(pos=1500, var="+TT", genotype=2)]
    fa, bam = simulate(str(tmp / "sim"), variants,
                       SimConfig(ref_len=2300, coverage=18, read_len=70),
                       seed=13)
    var_file, _ = get_candidates(bam, str(tmp / "cand"), fa)
    return tmp, fa, bam, make_windows(var_file, str(tmp / "win"))[0]


def _glf(cls, tmp, fa, bam, wf, tag, **kw):
    params = (Parameters if cls is BatchedWindowEngine else JaxParameters)()
    params.do_diploid = True
    params.estimate_hap_freqs = True
    params.file_name = str(tmp / tag)
    eng = cls([bam], fa, params, batch_windows=8, **kw)
    glf = str(tmp / f"{tag}.glf.txt")
    eng.detect_indels(wf, glf)
    eng.close()
    assert eng.stats.windows_ok >= 2
    return open(glf).read()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_engine_mesh_glf_byte_equal(mesh_sim, dtype):
    """The engine under mesh=(4, 2) on the CPU writes the GLF of the
    single-device engine, diploid and pooled; in float64 also the JAX
    engine's under its own 4x2 mesh."""
    tmp, fa, bam, wf = mesh_sim
    exact = dtype == np.float64
    tag = np.dtype(dtype).name
    single = _glf(BatchedWindowEngine, tmp, fa, bam, wf, f"single_{tag}",
                  device="cpu", dtype=dtype, exact_ties=exact)
    meshed = _glf(BatchedWindowEngine, tmp, fa, bam, wf, f"mesh_{tag}",
                  device="cpu", dtype=dtype, exact_ties=exact, mesh=(4, 2))
    assert "dip.map" in single and "singlevariant" in single
    assert meshed == single
    if exact:
        assert _glf(JaxEngine, tmp, fa, bam, wf, "jax_mesh", dp_impl="xla",
                    dtype=np.float64, mesh=(4, 2)) == meshed


def test_engine_mesh_and_remote_exclusive(mesh_sim):
    tmp, fa, bam, _ = mesh_sim
    p = Parameters()
    with pytest.raises(ValueError, match="exclusive"):
        BatchedWindowEngine([bam], fa, p, device="cpu", mesh=(2, 1),
                            remote=object())


def _indels(fa, bam, wf, out, *extra):
    return ["--analysis", "indels", "--doDiploid", "--engine", "batched",
            "--hmmBackend", "pallas", "--bamFile", bam, "--ref", fa,
            "--varFile", wf, "--outputFile", out, *extra]


def test_cli_mesh_cpu_equals_plain(mesh_sim):
    tmp, fa, bam, wf = mesh_sim
    glfs = []
    for tag, extra in (("plain", ()), ("mesh", ("--mesh", "2x2"))):
        out = str(tmp / f"cli_{tag}")
        assert cli.main(_indels(fa, bam, wf, out, "--device", "cpu",
                                *extra)) == 0
        glfs.append(open(out + ".glf.txt").read())
    assert "dip.map" in glfs[0]
    assert glfs[0] == glfs[1]


def test_cli_mesh_cuda_without_cards_raises(mesh_sim):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, fa, bam, wf = mesh_sim
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_indels(fa, bam, wf, str(tmp / "nocuda"), "--mesh", "2x2",
                         "--device", "cuda"))
