"""Port CAVI step == JAX CAVI step and the f64 reference model.

Both packages start from the same JAX init_state (carried over with
state_from_numpy) and take 3 steps on the same data. The port is held to
the JAX dense step at rtol=5e-4, atol=1e-6 (the bound of
tests/test_dense_pallas.py::test_step_parity_dense_pallas) and to the f64
oracle tests/reference_impl.py at rtol=5e-3, atol=1e-5 (the bound of
tests/test_step_golden.py: f32 state iterated against f64).
"""

import os

import numpy as np
import pytest
import torch

import reference_impl as R
from conftest import make_synthetic
from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.data.device import build_device_data as j_build
from hgaprec_tpu.io.checkpoint import save_npz as j_save_npz
from hgaprec_tpu.models.state import init_state as j_init
from hgaprec_tpu.models.step import make_step as j_make_step
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.data.device import build_device_data as t_build
from hgaprec_tpu_torch.data.ratings import RatingsStore as TStore
from hgaprec_tpu_torch.models import step as step_mod
from hgaprec_tpu_torch.models.state import (init_state, state_from_numpy,
                                            state_to_numpy)
from hgaprec_tpu_torch.models.step import make_multi_step, make_step
from hgaprec_tpu_torch.ops.gamma import expectations

CASES = [("hpf", {}), ("bpf", {}), ("bpf", {"bias": True}),
         ("bpf", {"bias": True, "vb": False}), ("hpf", {"bias": True})]


def port_store(js):
    """The port's store holding exactly the JAX store's ids and COO."""
    ts = TStore(js.n, js.m, js.binary, js.rating_threshold)
    for f in ("user2seq", "seq2user", "movie2seq", "seq2movie"):
        setattr(ts, f, dict(getattr(js, f)))
    ts._u, ts._i, ts._y = list(js.coo_u), list(js.coo_i), list(js.coo_y)
    ts.finalize()
    return ts


def _arrays(tmp_path, jstate):
    path = os.path.join(str(tmp_path), "s.npz")
    j_save_npz(path, jstate, 0)
    z = np.load(path)
    return {k: z[k] for k in z.files if k != "iteration"}


def _cfg_dict(cfg):
    return dict(a=cfg.a, b=cfg.b, c=cfg.c, d=cfg.d, ap=cfg.ap, bp=cfg.bp,
                cp=cfg.cp, dp=cfg.dp, vb=cfg.vb)


@pytest.mark.parametrize("variant,kw", CASES)
def test_step_matches_jax_and_oracle(tmp_path, rng, variant, kw):
    js, _, _ = make_synthetic(rng, n=25, m=19, density=0.4)
    jcfg = JCfg(n=js.n, m=js.m, k=4, variant=variant, sweep="dense", **kw)
    tcfg = TCfg(n=js.n, m=js.m, k=4, variant=variant, sweep="dense", **kw)
    jstate = j_init(jcfg, seed=7)
    tstate = state_from_numpy(_arrays(tmp_path, jstate), tcfg, "cpu")
    oracle = R.state_from_jax(jstate, variant, jcfg.bias, jcfg.hier)
    jdata = j_build(js, pad_multiple=128)
    tdata = t_build(port_store(js), "cpu", pad_multiple=128)
    coo = list(zip(js.coo_u.tolist(), js.coo_i.tolist(),
                   js.coo_y.tolist()))
    ref_step = R.hpf_step if variant == "hpf" else R.bpf_step
    jstep, tstep = j_make_step(jcfg), make_step(tcfg)
    for _ in range(3):
        jstate = jstep(jstate, jdata)
        tstate = tstep(tstate, tdata)
        oracle = ref_step(oracle, coo, _cfg_dict(jcfg))

    want = _arrays(tmp_path, jstate)
    got = state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=5e-4,
                                   atol=1e-6, err_msg=key)
    pairs = [("theta.e", "theta_e"), ("beta.e", "beta_e"),
             ("theta.elog", "theta_elog")]
    if variant == "hpf":
        pairs += [("theta_rate.e", "xi_e"), ("beta_rate.e", "eta_e")]
    if tcfg.bias:
        pairs += [("theta_bias.e", "tbias_e"), ("beta_bias.e", "bbias_e")]
    for key, okey in pairs:
        np.testing.assert_allclose(got[key].astype(np.float64), oracle[okey],
                                   rtol=5e-3, atol=1e-5, err_msg=key)


def test_multi_step_equals_repeated_step(rng):
    js, _, _ = make_synthetic(rng, n=20, m=15, density=0.4)
    cfg = TCfg(n=js.n, m=js.m, k=3, variant="hpf")
    data = t_build(port_store(js), "cpu")
    from hgaprec_tpu_torch.models.state import init_state
    a = init_state(cfg, seed=1, device="cpu")
    b = init_state(cfg, seed=1, device="cpu")
    a = make_multi_step(cfg)(a, data, 4)
    step = make_step(cfg)
    for _ in range(4):
        b = step(b, data)
    for key, v in state_to_numpy(a).items():
        np.testing.assert_array_equal(v, state_to_numpy(b)[key], key)


# tests/test_step_golden.py:39-51: segment, dense and MLE/Canny rows
GOLDEN = [
    ("bpf", {}, "segment"),
    ("bpf", {}, "dense"),
    ("bpf", {"bias": True}, "segment"),
    ("bpf", {"bias": True, "vb": False}, "dense"),
    ("bpf", {"binary": True}, "dense"),
    ("hpf", {}, "segment"),
    ("hpf", {}, "dense"),
    ("hpf", {"bias": True}, "dense"),
    ("mle_user", {}, "dense"),
    ("mle_item", {}, "dense"),
    ("canny", {}, "segment"),
]

_ORACLE_STEP = {
    "bpf": R.bpf_step, "hpf": R.hpf_step, "mle_user": R.mle_user_step,
    "mle_item": R.mle_item_step,
    "canny": lambda st, coo, c: R.mle_item_step(st, coo, c, canny=True),
}


@pytest.mark.parametrize("variant,kw,mode", GOLDEN)
def test_golden_cases_match_jax_and_oracle(tmp_path, rng, variant, kw, mode):
    """The golden cases: 4 steps from the same JAX init_state in both
    packages and the f64 oracle, in the case's sweep mode. The port is
    held to the JAX step on every state array (the bound above), and to
    the oracle on the arrays test_step_golden.py checks."""
    binary = kw.get("binary", False)
    js, _, _ = make_synthetic(rng, n=25, m=19, k=0, density=0.4,
                              binary=binary,
                              rating_threshold=2 if binary else 1)
    jcfg = JCfg(n=js.n, m=js.m, k=4, variant=variant, sweep=mode, **kw)
    tcfg = TCfg(n=js.n, m=js.m, k=4, variant=variant, sweep=mode, **kw)
    jstate = j_init(jcfg, seed=7)
    tstate = state_from_numpy(_arrays(tmp_path, jstate), tcfg, "cpu")
    oracle = R.state_from_jax(jstate, variant, jcfg.bias, jcfg.hier)
    jdata = j_build(js, pad_multiple=128)
    tdata = t_build(port_store(js), "cpu", pad_multiple=128)
    coo = list(zip(js.coo_u.tolist(), js.coo_i.tolist(),
                   js.coo_y.tolist()))
    jstep, tstep = j_make_step(jcfg), make_step(tcfg)
    for _ in range(4):
        jstate = jstep(jstate, jdata)
        tstate = tstep(tstate, tdata)
        oracle = _ORACLE_STEP[variant](oracle, coo, _cfg_dict(jcfg))

    want = _arrays(tmp_path, jstate)
    got = state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=5e-4,
                                   atol=1e-6, err_msg=key)
    if variant in ("bpf", "hpf"):
        pairs = [("theta.e", "theta_e"), ("beta.e", "beta_e"),
                 ("theta.elog", "theta_elog")]
    elif variant == "mle_user":
        pairs = [("theta_mle", "theta_mle"), ("beta.e", "beta_e")]
    else:
        pairs = [("beta_mle", "beta_mle"), ("theta.e", "theta_e")]
    if variant == "hpf":
        pairs += [("theta_rate.e", "xi_e"), ("beta_rate.e", "eta_e")]
    if tcfg.bias:
        pairs += [("theta_bias.e", "tbias_e"), ("beta_bias.e", "bbias_e")]
    for key, okey in pairs:
        np.testing.assert_allclose(got[key].astype(np.float64), oracle[okey],
                                   rtol=5e-3, atol=1e-5, err_msg=key)


def _copying_update(g, shape, rate, row_mask=None):
    """The update as it stood before it wrote in place: the shape, the
    rate and their expectations as fresh tensors, then four copies into
    g's buffers. `shape` and `rate` take models/step.py::_update's forms
    (a pair (x, y) for x + y, or a number)."""
    def value(v, like):
        return v[0] + v[1] if isinstance(v, tuple) else \
            torch.full_like(like, v)
    shape, rate = value(shape, g.shape), value(rate, g.rate)
    e, elog = expectations(shape, rate)
    if row_mask is not None:
        e = e * row_mask.reshape((-1,) + (1,) * (e.dim() - 1))
    g.shape.copy_(shape)
    g.rate.copy_(rate)
    g.e.copy_(e)
    g.elog.copy_(elog)


# the six variants, and the three that take a bias with it
INPLACE_CASES = [("bpf", {}), ("bpf", {"vb": False}), ("hpf", {}),
                 ("mle_user", {}), ("mle_item", {}), ("canny", {}),
                 ("bpf", {"bias": True}),
                 ("bpf", {"bias": True, "vb": False}),
                 ("hpf", {"bias": True})]


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows",
                                                       "row_mask"])
@pytest.mark.parametrize("variant,kw", INPLACE_CASES,
                         ids=["-".join([v, *kw]) for v, kw in INPLACE_CASES])
def test_inplace_update_equals_copying(rng, monkeypatch, variant, kw,
                                       masked):
    """The step computing its updates into the state's buffers gives the
    bits of the step that computed fresh tensors and copied them in, over
    4 steps (with a row mask zeroing the last rows' expectations, as a
    sharded run's padding rows; MLE-user takes none), and leaves every
    state tensor at its address."""
    js, _, _ = make_synthetic(rng, n=25, m=19, density=0.4)
    cfg = TCfg(n=js.n, m=js.m, k=4, variant=variant, sweep="dense", **kw)
    data = t_build(port_store(js), "cpu", pad_multiple=128)
    mask = None
    if masked:
        mask = (torch.arange(js.n) < js.n - 3).float()
    inplace = init_state(cfg, seed=7, device="cpu")
    copying = init_state(cfg, seed=7, device="cpu")
    ptrs = [t.data_ptr() for _, t in step_mod.tensor_leaves(inplace)]
    for _ in range(4):
        step_mod.cavi_step(inplace, data, cfg, None, mask)
    assert ptrs == [t.data_ptr() for _, t in step_mod.tensor_leaves(inplace)]
    monkeypatch.setattr(step_mod, "_update", _copying_update)
    for _ in range(4):
        step_mod.cavi_step(copying, data, cfg, None, mask)
    want = state_to_numpy(copying)
    for key, v in state_to_numpy(inplace).items():
        np.testing.assert_array_equal(v, want[key], key)
