"""Port state and Gamma ops == JAX state and Gamma ops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.io.checkpoint import save_npz as j_save_npz
from hgaprec_tpu.models.state import init_state as j_init
from hgaprec_tpu.ops.gamma import expectations as j_expect
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.io.checkpoint import load_npz as t_load_npz
from hgaprec_tpu_torch.models.state import (init_state, state_from_numpy,
                                            state_to_numpy)
from hgaprec_tpu_torch.ops.gamma import expectations

VARIANTS = [("hpf", {}), ("bpf", {}), ("bpf", {"bias": True}),
            ("hpf", {"bias": True})]


def _jax_arrays(path):
    z = np.load(path)
    return {k: z[k] for k in z.files if k != "iteration"}


@pytest.mark.parametrize("variant,kw", VARIANTS)
def test_init_state_bit_equal(tmp_path, variant, kw):
    """Same seed, same NumPy draw order: every array equal bit for bit,
    keyed as the npz checkpoint keys them."""
    jstate = j_init(JCfg(n=23, m=17, k=5, variant=variant, **kw), seed=11)
    j_save_npz(str(tmp_path / "j.npz"), jstate, 0)
    ref = _jax_arrays(tmp_path / "j.npz")
    got = state_to_numpy(init_state(TCfg(n=23, m=17, k=5, variant=variant,
                                         **kw), seed=11, device="cpu"))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], key)


@pytest.mark.parametrize("variant,kw", VARIANTS)
def test_numpy_round_trip(tmp_path, variant, kw):
    """A JAX state (as numpy) loads into the port and comes back equal,
    and the port reads the JAX package's npz checkpoint."""
    jcfg = JCfg(n=9, m=7, k=3, variant=variant, **kw)
    tcfg = TCfg(n=9, m=7, k=3, variant=variant, **kw)
    j_save_npz(str(tmp_path / "j.npz"), j_init(jcfg, seed=2), 4)
    arrays = _jax_arrays(tmp_path / "j.npz")
    back = state_to_numpy(state_from_numpy(arrays, tcfg, "cpu"))
    for key in arrays:
        np.testing.assert_array_equal(back[key], arrays[key], key)
    state, it = t_load_npz(str(tmp_path / "j.npz"), tcfg, "cpu")
    assert it == 4
    np.testing.assert_array_equal(state.theta.elog.numpy(),
                                  arrays["theta.elog"])


def test_state_to_numpy_owns_its_copy():
    state = init_state(TCfg(n=4, m=3, k=2, variant="hpf"), seed=0,
                       device="cpu")
    snap = state_to_numpy(state)
    before = snap["theta.e"].copy()
    state.theta.e.add_(1.0)              # the step writes in place
    np.testing.assert_array_equal(snap["theta.e"], before)


def test_init_state_needs_a_device():
    """No silent CPU default: the caller names the device."""
    with pytest.raises(TypeError):
        init_state(TCfg(n=4, m=3, k=2, variant="hpf"), seed=0)


def test_expectations_match():
    """torch and XLA digamma differ in f32 by up to ~1.8e-4 absolute near
    x = 1.3e-3 (|psi| ~ 770), and relative error is meaningless near
    psi's root at 1.4616, so the bound needs both rtol and atol."""
    rng = np.random.default_rng(0)
    shape = np.concatenate([
        rng.uniform(1e-3, 2e-3, 50), rng.uniform(0.2, 3.0, 200),
        rng.uniform(1.4, 1.5, 50), rng.uniform(10, 5e3, 100),
        [0.0, -1.0, 0.5, 2.0]]).astype(np.float32).reshape(-1, 4)
    rate = rng.uniform(0.3, 50.0, 4).astype(np.float32)
    je, jl = j_expect(jnp.asarray(shape), jnp.asarray(rate))
    te, tl = expectations(torch.from_numpy(shape), torch.from_numpy(rate))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
