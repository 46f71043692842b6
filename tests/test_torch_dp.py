"""dindel_tpu_torch pair-HMM DP and finish vs the JAX package.

The plain PyTorch DP (dindel_tpu_torch/hmm/dp_ref.py) is held to the
Pallas kernel in interpret mode in float32 (both fold modes; its uint8
backpointer codes to the Pallas kernel's int32 words, in value) and to
the XLA DP in float64 with exact ties; the finish is held to
``dindel_tpu.hmm.batch._finish(bt_codes=True)``.  Every comparison is
exact: no tolerance.  The CUDA kernel is held to the plain version on the
card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dindel_tpu.config import ObservationModelParameters
from dindel_tpu.hmm.batch import _dp_xla, _finish, compute_obs_mid, pack_pairs
from dindel_tpu.hmm.pallas_kernel import dp_pallas
from dindel_tpu.hmm.pallas_kernel import expand_bt_codes as jax_expand
from dindel_tpu.parallel.mesh import synth_windows
from dindel_tpu_torch.hmm.dp_ref import dp_bounds, dp_ref, expand_bt_codes
from dindel_tpu_torch.hmm.finish import finish

torch.set_num_threads(1)

JAX_KEYS = ["hap_len", "read_len", "b_mid", "read_codes", "hap_codes",
            "eq", "uq", "lpe", "lpn", "lpeV", "lpnV"]
TORCH_KEYS = ["hap_len", "read_len", "b_mid", "read_codes", "hap_codes",
              "eq", "uq", "lpe", "lpn"]
# the shapes of tests/test_pallas_kernel.py, and numT = 15 (the largest
# the 4-bit class codes hold: --maxLengthIndel 13)
SHAPES = {"a": dict(nh=4, nr=32, H=80, L=14, seed=3, H_pad=126, L_pad=16),
          "b": dict(nh=3, nr=16, H=70, L=24, seed=9, H_pad=126, L_pad=32),
          "numT15": dict(nh=3, nr=16, H=70, L=24, seed=9, H_pad=126,
                         L_pad=32, max_del=13)}


def _pk(shape, dtype):
    s = SHAPES[shape]
    (haps, reads, hs), = synth_windows(1, nh=s["nh"], nr=s["nr"], H=s["H"],
                                       L=s["L"], seed=s["seed"])
    params = ObservationModelParameters()
    params.max_length_del = s.get("max_del", params.max_length_del)
    return pack_pairs(haps, reads, hs, params, dtype=dtype, H_pad=s["H_pad"],
                      L_pad=s["L_pad"])


def _jax_args(pk):
    return ([jnp.asarray(pk[k]) for k in JAX_KEYS]
            + [jnp.asarray(pk["scalars"])])


def _torch_dp(pk, exact_ties):
    args = [torch.from_numpy(np.ascontiguousarray(pk[k])) for k in TORCH_KEYS]
    return dp_ref(pk["H_pad"], pk["L_pad"], pk["numT"], *args, pk["scalars"],
                  exact_ties=exact_ties)


def _bounds(pk):
    return dp_bounds(pk["read_len"], pk["b_mid"], pk["L_pad"])


@pytest.mark.parametrize("shape", ["a", "b", "numT15"])
@pytest.mark.parametrize("exact_ties", [True, False])
def test_dp_ref_matches_pallas_interpret_f32(shape, exact_ties):
    pk = _pk(shape, np.float32)
    assert pk["numT"] == (15 if shape == "numT15" else 7)
    want = [np.asarray(x) for x in dp_pallas(
        pk["H_pad"], pk["L_pad"], pk["numT"], *_jax_args(pk),
        interpret=True, exact_ties=exact_ties)]
    got = [x.numpy() for x in _torch_dp(pk, exact_ties)]
    L_act, MB, MN = _bounds(pk)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    # uint8 class codes here, int32 words (the TPU's tile type) there:
    # equal in value; only the rows the finish consumes are written by
    # either kernel
    assert got[2].dtype == got[3].dtype == np.uint8
    assert want[2].dtype == want[3].dtype == np.int32
    assert np.array_equal(got[2][:MB], want[2][:MB])
    assert np.array_equal(got[3][MN:L_act - 1], want[3][MN:L_act - 1])


@pytest.mark.parametrize("shape", ["a", "b"])
def test_dp_ref_matches_xla_f64_exact(shape):
    pk = _pk(shape, np.float64)
    want = [np.asarray(x) for x in _dp_xla(pk["H_pad"], pk["L_pad"],
                                           pk["numT"], *_jax_args(pk))]
    got = _torch_dp(pk, exact_ties=True)
    f, g = expand_bt_codes(got[2], got[3], torch.from_numpy(pk["hap_len"]),
                           pk["H_pad"], pk["numT"])
    L_act, MB, MN = _bounds(pk)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(f.numpy()[:MB], want[2][:MB].astype(np.int32))
    assert np.array_equal(g.numpy()[MN:L_act - 1],
                          want[3][MN:L_act - 1].astype(np.int32))


def test_expand_bt_codes_matches_jax():
    pk = _pk("a", np.float32)
    _, _, btf, btb = _torch_dp(pk, exact_ties=False)
    want = jax_expand(btf.numpy(), btb.numpy(), pk["hap_len"], pk["H_pad"],
                      pk["numT"])
    got = expand_bt_codes(btf, btb, torch.from_numpy(pk["hap_len"]),
                          pk["H_pad"], pk["numT"])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("exact_ties", [True, False])
def test_finish_matches_jax(exact_ties):
    """Same DP planes into both finishes: all six outputs equal, map_state
    on the valid region (beyond read_len it decodes unconsumed rows)."""
    pk = _pk("b", np.float32)
    amid, bmid, btf, btb = _torch_dp(pk, exact_ties)
    obs_mid = compute_obs_mid(pk)
    want = [np.asarray(o) for o in _finish(
        pk["H_pad"], pk["L_pad"], jnp.asarray(pk["b_mid"]),
        jnp.asarray(amid.numpy()), jnp.asarray(bmid.numpy()),
        jnp.asarray(obs_mid), jnp.asarray(pk["prior_rmq"]),
        jnp.asarray(pk["prior_hmq"]), jnp.asarray(btf.numpy()),
        jnp.asarray(btb.numpy()), exact_ties=exact_ties, bt_codes=True,
        numT=pk["numT"], hap_len=jnp.asarray(pk["hap_len"]))]
    t = lambda k: torch.from_numpy(np.ascontiguousarray(pk[k]))  # noqa: E731
    got = [o.numpy() for o in finish(
        pk["H_pad"], pk["L_pad"], pk["numT"], t("b_mid"), t("hap_len"),
        amid, bmid, torch.from_numpy(obs_mid), t("prior_rmq"),
        t("prior_hmq"), btf, btb, exact_ties=exact_ties)]
    valid = (np.arange(pk["L_pad"])[None, :]
             < np.asarray(pk["read_len"])[:, None])
    names = ("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on", "map_state")
    for nm, w, g in zip(names, want, got):
        if nm == "map_state":
            w = np.where(valid, w, -1)
            g = np.where(valid, g, -1)
        assert np.array_equal(w, g), nm


def test_dp_rejects_numT_over_15():
    pk = _pk("a", np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(pk[k])) for k in TORCH_KEYS]
    with pytest.raises(ValueError, match="numT"):
        dp_ref(pk["H_pad"], pk["L_pad"], 16, *args, pk["scalars"])

