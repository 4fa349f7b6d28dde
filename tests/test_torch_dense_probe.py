"""The dense kernel's stage probe: each stage's plain version against the
TPU probe.

`scripts/dense_mfu_probe.py::run_variant` runs in the Pallas interpreter
at n = 512 users and 1024 items (one 512-row tile, two 512-item tiles) on
the same bf16-rounded factors and counts; the port's plain version of each
stage (`ops/dense_probe.py::dense_probe_reference`) is held to it at the
bf16 bound of tests/test_dense_pallas.py (2e-2 relative, floor 1e-3).
The stage kernels themselves run only on the card (marked `cuda`).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops import dense_fused as df
from hgaprec_tpu_torch.ops import dense_probe as dp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, K = 512, 1024, 100
BF16_REL = 2e-2
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_enable_xla_caches")


@pytest.fixture(scope="module")
def probe_module():
    """scripts/dense_mfu_probe.py, loaded from its path. Its import sets a
    persistent compilation cache; the settings and sys.path are restored
    right after."""
    saved = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "dense_mfu_probe", os.path.join(REPO, "scripts", "dense_mfu_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)
        sys.path[:] = path
    return mod


def _inputs(seed):
    """a f32 [N, K], b f32 [M, K] (bf16-exact), y u8 [N, M] with 1% of the
    counts 3 and some 1, as the TPU probe draws them."""
    rng = np.random.default_rng(seed)
    a, b = (rng.gamma(0.3, 1.0, (r, K)).astype(np.float32) + 0.01
            for r in (N, M))
    a, b = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for x in (a, b))
    u = rng.random((N, M))
    y = np.where(u < 0.01, 3, np.where(u < 0.05, 1, 0)).astype(np.uint8)
    return a, b, y


def _tpu_probe(mod, a, b, y, stage):
    """run_variant in the Pallas interpreter; factors zero-padded to the
    probe's 128 lanes."""
    a128, b128 = (jnp.asarray(np.pad(x, ((0, 0), (0, mod.KP - K))),
                              jnp.bfloat16) for x in (a, b))
    out = mod.run_variant(a128, b128, jnp.asarray(y), stage)
    return [np.asarray(o)[:, :K] for o in out]


def _reciprocal(x, *, approx=False):
    """1 / x in x's dtype. The interpreter lowers `pl.reciprocal` of a
    bf16 value to an f32 result that fails to verify, so the test stands
    in the reciprocal rounded to the input's dtype (what the TPU's
    approximate reciprocal returns, up to its approximation)."""
    return (1.0 / x.astype(jnp.float32)).astype(x.dtype)


@pytest.mark.parametrize("stage", sorted(dp.STAGES))
def test_plain_stage_matches_tpu_probe(monkeypatch, probe_module, stage):
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    monkeypatch.setattr(pallas, "reciprocal", _reciprocal)
    a, b, y = _inputs(3)
    want = _tpu_probe(probe_module, a, b, y, stage)
    got = dp.dense_probe_reference(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(y), stage)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        if stage == "mmonly":               # the outputs are S * 0
            assert not g.any() and not w.any()
            continue
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-3)
        assert rel.max() < BF16_REL, (stage, rel.max())


def test_prod_plain_is_the_production_plain():
    a, b, y = (torch.from_numpy(x) for x in _inputs(4))
    got = dp.dense_probe_reference(a, b, y, "prod", item_block=384)
    want = df.fused_dense_sweep_reference(a, b, y, bf16=True,
                                          item_block=384)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_stages_differ_where_they_drop_work():
    """Each stage computes what its name says: norecip W = Y, noyload
    W = 1 (plain versions, small shape)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((6, 4)).astype(np.float32) + 0.1)
    b = torch.from_numpy(rng.random((5, 4)).astype(np.float32) + 0.1)
    y = torch.from_numpy(rng.integers(0, 3, (6, 5)).astype(np.uint8))
    ab, bb = (x.to(torch.bfloat16).float() for x in (a, b))
    norecip = dp.dense_probe_reference(a, b, y, "norecip")
    noyload = dp.dense_probe_reference(a, b, y, "noyload")
    torch.testing.assert_close(norecip[0], y.float() @ bb)
    torch.testing.assert_close(norecip[1], y.float().T @ ab)
    torch.testing.assert_close(noyload[0], torch.ones(6, 5) @ bb)
    torch.testing.assert_close(noyload[1], torch.ones(5, 6) @ ab)


def test_cpu_tensor_never_builds(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")
    monkeypatch.setattr(build, "load_library", no_build)
    a, b, y = (torch.from_numpy(x) for x in _inputs(6))
    before = dp.dense_probe.launches
    for stage in dp.STAGES:
        got = dp.dense_probe(a, b, y, stage)
        want = dp.dense_probe_reference(a, b, y, stage)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dp.dense_probe.launches == before


def test_unknown_stage_and_no_card(capsys):
    a, b, y = (torch.from_numpy(x) for x in _inputs(7))
    with pytest.raises(ValueError, match="unknown stage"):
        dp.dense_probe(a, b, y, "nodiv")
    if not torch.cuda.is_available():
        assert dp.main(["1024"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(dp.STAGES))
def test_stage_kernel_matches_plain_on_card(stage):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    a, b, y = (torch.from_numpy(x).cuda() for x in _inputs(8))
    before = dp.dense_probe.launches
    got = dp.dense_probe(a, b, y, stage)
    torch.cuda.synchronize()
    assert dp.dense_probe.launches == before + 1
    want = dp.dense_probe_reference(a, b, y, stage)
    for g, w in zip(got, want):
        rel = (g - w).abs() / w.abs().clamp_min(1e-3)
        assert rel.max().item() < BF16_REL
    if stage == "prod":
        prod = dp.mma_sweep(a, b, y)
        assert all(torch.equal(g, p) for g, p in zip(got, prod))
