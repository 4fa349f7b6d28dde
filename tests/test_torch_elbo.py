"""The port's ELBO and Gamma ELBO terms against the JAX package.

`elbo_term`, `training_elbo` and `true_elbo` are held to the JAX functions
on the same state (the JAX state after a few steps, carried across with
`state_from_numpy`) at rtol 1e-5: both sum f32 values, the port in
f32 chunk sums added in f64. `training_elbo` is also held to the f64 oracle
`reference_impl.reference_elbo` at rtol 1e-3 (tests/test_step_golden.py:
108), and the true ELBO must not decrease over 15 of the port's segment
steps (tests/test_step_golden.py:111-131).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_impl as R
from conftest import make_synthetic
from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.data.device import build_device_data as j_build
from hgaprec_tpu.models import elbo as j_elbo
from hgaprec_tpu.models.state import init_state as j_init
from hgaprec_tpu.models.step import make_step as j_make_step
from hgaprec_tpu.ops.gamma import elbo_term as j_elbo_term
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.data.device import build_device_data as t_build
from hgaprec_tpu_torch.models import elbo as t_elbo
from hgaprec_tpu_torch.models.state import init_state, state_from_numpy
from hgaprec_tpu_torch.models.step import make_step
from hgaprec_tpu_torch.ops.gamma import elbo_term
from test_torch_step import _arrays, _cfg_dict, port_store

CASES = [("hpf", {}), ("bpf", {}), ("bpf", {"bias": True}),
         ("hpf", {"bias": True}), ("bpf", {"binary": True}),
         ("mle_user", {}), ("mle_item", {}), ("canny", {})]


@pytest.mark.parametrize("case", ["global_rate", "row_prior", "vector"])
def test_elbo_term_matches_jax(rng, case):
    n, k = 9, 4
    if case == "vector":
        shape = rng.random(n) + 0.2
        rate = rng.random(n) + 0.3
    else:
        shape = rng.random((n, k)) + 0.2
        rate = rng.random(k) + 0.3
    shape = shape.astype(np.float32)
    rate = rate.astype(np.float32)
    e = (shape / rate).astype(np.float32)
    elog = (np.log(shape) - np.log(rate)).astype(np.float32)
    if case == "row_prior":
        rp = (rng.random(n) + 0.5).astype(np.float32)
        rlog = (np.log(rp) - 0.1).astype(np.float32)
        want = j_elbo_term(*map(jnp.asarray, (shape, rate, e, elog)), 0.3,
                           jnp.asarray(rp), jnp.asarray(rlog))
        got = elbo_term(*map(torch.from_numpy, (shape, rate, e, elog)), 0.3,
                        torch.from_numpy(rp), torch.from_numpy(rlog))
    else:
        want = j_elbo_term(*map(jnp.asarray, (shape, rate, e, elog)), 0.3,
                           0.7)
        got = elbo_term(*map(torch.from_numpy, (shape, rate, e, elog)), 0.3,
                        0.7)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _carried(tmp_path, rng, variant, kw, steps=3):
    """A JAX state after `steps` dense steps, the same state in the port,
    and both packages' data and configs."""
    binary = kw.get("binary", False)
    js, _, _ = make_synthetic(rng, n=25, m=19, density=0.4, binary=binary,
                              rating_threshold=2 if binary else 1)
    jcfg = JCfg(n=js.n, m=js.m, k=4, variant=variant, sweep="dense", **kw)
    tcfg = TCfg(n=js.n, m=js.m, k=4, variant=variant, sweep="dense", **kw)
    jdata = j_build(js, pad_multiple=128)
    jstate, jstep = j_init(jcfg, seed=7), j_make_step(jcfg)
    for _ in range(steps):
        jstate = jstep(jstate, jdata)
    tstate = state_from_numpy(_arrays(tmp_path, jstate), tcfg, "cpu")
    return (jstate, jdata, jcfg), (tstate, t_build(port_store(js), "cpu",
                                                   pad_multiple=128), tcfg)


@pytest.mark.parametrize("variant,kw", CASES)
def test_elbos_match_jax(tmp_path, rng, variant, kw):
    (js, jd, jc), (ts, td, tc) = _carried(tmp_path, rng, variant, kw)
    for name in ("training_elbo", "true_elbo"):
        want = float(getattr(j_elbo, name)(js, jd, jc))
        got = getattr(t_elbo, name)(ts, td, tc)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("bias", [False, True])
def test_chunked_elbo_equals_one_chunk(tmp_path, rng, bias):
    _, (ts, td, tc) = _carried(tmp_path, rng, "hpf", {"bias": bias})
    assert td.nnz_padded > 7
    for fn in (t_elbo.training_elbo, t_elbo.true_elbo):
        np.testing.assert_allclose(fn(ts, td, tc, chunk=7),
                                   fn(ts, td, tc, chunk=td.nnz_padded),
                                   rtol=1e-6)


def test_training_elbo_matches_reference(rng):
    """Three of the port's segment steps against the f64 oracle's steps,
    then both ELBOs (tests/test_step_golden.py::test_elbo_matches_
    reference)."""
    js, _, _ = make_synthetic(rng, n=20, m=15, density=0.4)
    cfg = TCfg(n=js.n, m=js.m, k=4, variant="hpf", sweep="segment")
    data = t_build(port_store(js), "cpu", pad_multiple=128)
    state = init_state(cfg, seed=7, device="cpu")
    st = R.state_from_jax(state, "hpf", False, True)
    coo = list(zip(js.coo_u.tolist(), js.coo_i.tolist(), js.coo_y.tolist()))
    step = make_step(cfg)
    for _ in range(3):
        state = step(state, data)
        st = R.hpf_step(st, coo, _cfg_dict(cfg))
    np.testing.assert_allclose(t_elbo.training_elbo(state, data, cfg),
                               R.reference_elbo(st, coo, _cfg_dict(cfg)),
                               rtol=1e-3)


@pytest.mark.parametrize("variant,kw", [
    ("bpf", {}), ("bpf", {"bias": True}), ("hpf", {}),
    ("bpf", {"binary": True}),
])
def test_true_elbo_monotone_in_segment_mode(rng, variant, kw):
    """CAVI correctness: the true ELBO must be non-decreasing."""
    binary = kw.get("binary", False)
    js, _, _ = make_synthetic(rng, n=30, m=25, density=0.35, binary=binary)
    cfg = TCfg(n=js.n, m=js.m, k=5, variant=variant, sweep="segment", **kw)
    data = t_build(port_store(js), "cpu", pad_multiple=128)
    state = init_state(cfg, seed=3, device="cpu")
    step = make_step(cfg)
    vals = []
    for _ in range(15):
        state = step(state, data)
        vals.append(t_elbo.true_elbo(state, data, cfg))
    diffs = np.diff(np.asarray(vals))
    # allow tiny f32 wiggle (the JAX test's bound)
    assert (diffs > -np.abs(np.asarray(vals[1:])) * 1e-5).all(), vals
