"""The dense kernels' stage probe: each stage's plain version against the
TPU probe, on both routes.

`scripts/dense_mfu_probe.py::run_variant` runs in the Pallas interpreter
at n = 512 users and 1024 items (one 512-row tile, two 512-item tiles) on
the same bf16-rounded factors and counts; the port's plain version of each
stage (`ops/dense_probe.py::dense_probe_reference`) is held to it at the
bf16 bound of tests/test_dense_pallas.py (2e-2 relative, floor 1e-3). The
f32 route's stages (no rounding) are held to it where W = Y and W = 1 are
the same in bf16 and f32 (norecip, noyload, mmonly, on those bf16-exact
inputs), and f32 prod to the JAX fused kernel in f32
(`hgaprec_tpu.ops.dense_pallas.fused_dense_sweep(bf16=False)`, the
interpreter), all at the f32 bound tests/test_dense_pallas.py pins
(rtol=2e-4, atol=1e-5). The stage kernels themselves run only on the card
(marked `cuda`).
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

from hgaprec_tpu.ops.dense_pallas import fused_dense_sweep as j_fused
from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops import dense_fused as df
from hgaprec_tpu_torch.ops import dense_probe as dp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, K = 512, 1024, 100
BF16_REL = 2e-2
F32 = dict(rtol=2e-4, atol=1e-5)
# (bf16, stage): every stage each route builds
ROUTE_CASES = [(bf16, s) for bf16 in (True, False)
               for s in dp.ROUTE_STAGES[dp.route_of(bf16)]]
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


@pytest.mark.parametrize("stage", dp.ROUTE_STAGES["f32"])
def test_f32_plain_stage_matches_jax(monkeypatch, probe_module, stage):
    """The f32 route's plain stages (nothing rounded) on bf16-exact
    inputs: prod against the JAX fused kernel in f32, the others against
    the TPU probe, whose W = bf16(Y) and W = 1 are exact."""
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    a, b, y = _inputs(9)
    if stage == "prod":
        want = [np.asarray(o) for o in j_fused(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(y), bf16=False,
            interpret=True)]
    else:
        want = _tpu_probe(probe_module, a, b, y, stage)
    got = dp.dense_probe_reference(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(y), stage, bf16=False)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if stage == "mmonly":               # the outputs are S * 0
            assert not g.numpy().any() and not w.any()
        np.testing.assert_allclose(g.numpy(), w, **F32)


def test_f32_prod_plain_is_the_production_plain():
    a, b, y = (torch.from_numpy(x) for x in _inputs(4))
    got = dp.dense_probe_reference(a, b, y, "prod", bf16=False,
                                   item_block=384)
    want = df.fused_dense_sweep_reference(a, b, y, item_block=384)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    routes = dict(dp.dense_probe.launches_by_route)
    for bf16, stage in ROUTE_CASES:
        got = dp.dense_probe(a, b, y, stage, bf16=bf16)
        want = dp.dense_probe_reference(a, b, y, stage, bf16=bf16)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dp.dense_probe.launches == before
    assert dp.dense_probe.launches_by_route == routes


def test_unknown_stage_and_no_card(capsys):
    a, b, y = (torch.from_numpy(x) for x in _inputs(7))
    with pytest.raises(ValueError, match="unknown stage"):
        dp.dense_probe(a, b, y, "nodiv")
    if not torch.cuda.is_available():
        assert dp.main(["1024"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert dp.main(["--f32", "1024", "mmonly"]) == 1


def test_stage_routing(monkeypatch):
    """bf16recip is a bf16 stage: the f32 route refuses it by name, on the
    CPU and before any build; an unknown stage is refused on both routes;
    each route's stage launches go to that route's probe entry."""
    a, b, y = (torch.from_numpy(x) for x in _inputs(7))
    with pytest.raises(ValueError, match="bf16recip.*f32"):
        dp.dense_probe(a, b, y, "bf16recip", bf16=False)
    with pytest.raises(ValueError, match="bf16recip.*f32"):
        dp.dense_probe_reference(a, b, y, "bf16recip", bf16=False)
    for bf16 in (True, False):
        with pytest.raises(ValueError, match="unknown stage"):
            dp.dense_probe(a, b, y, "nodiv", bf16=bf16)
    with pytest.raises(ValueError, match="bf16recip"):
        dp.main(["--f32", "1024", "bf16recip"])
    assert set(dp.ROUTE_STAGES["wgmma"]) == set(dp.STAGES)
    assert set(dp.ROUTE_STAGES["f32"]) == set(dp.STAGES) - {"bf16recip"}
    assert {r: df.KERNELS[r].probe for r in dp.ROUTE_STAGES} == {
        "wgmma": "hpf_dense_wgmma_probe_bf16",
        "f32": "hpf_dense_simt_probe_f32"}
    # past the stages' widths the wrapper refuses before any build
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail(
        "a row too wide for the probe reached the kernel build"))
    for kernel, k in (("wgmma", 113), ("f32", 105)):
        with pytest.raises(ValueError, match="at most"):
            df.launch_dense(torch.rand(6, k), torch.rand(5, k),
                            torch.zeros(6, 16, dtype=torch.uint8)[:, :5],
                            kernel=kernel, stage=dp.STAGES["prod"])


def test_sass_counts_per_route_and_stage(monkeypatch):
    """The per-route count parser on a synthetic listing: each stage's
    kernel is counted on its own, by mnemonic prefix (predicated
    instructions too); other kernels and other widths do not count."""
    sass = "\n".join([
        "Function : _ZN47_GLOBAL__N__5aa_14_dense_wgmma_cu_0718dense_wgmma_"
        "kernelILi112ELi0EEEv14CUtensorMap_stS1_S1_S1_PfS2_S2_S2_iiii",
        "  /*0a50*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "                   /* 0x000fe20008000818 */",
        "  /*0a60*/  HGMMA.64x112x16.F32.BF16 R88, R8, gdesc[UR8], R88 ;",
        "  /*0a70*/  @!P0 LDS.U16 R5, [R2+0x10] ;",
        "  /*0a80*/  UTMALDG.2D [UR8], [UR4] ;",
        "Function : _ZN47_GLOBAL__N__5aa_14_dense_wgmma_cu_0718dense_wgmma_"
        "kernelILi112ELi4EEEv14CUtensorMap_stS1_S1_S1_PfS2_S2_S2_iiii",
        "  /*0a50*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "  /*0a60*/  FFMA R1, R24, RZ, R1 ;",
        "Function : _ZN47_GLOBAL__N__5aa_14_dense_wgmma_cu_0718dense_wgmma_"
        "kernelILi128ELi0EEEv14CUtensorMap_stS1_S1_S1_PfS2_S2_S2_iiii",
        "  /*0a50*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "Function : _ZN46_GLOBAL__N__8188_13_dense_simt_cu_9e21dense_simt_"
        "f32_kernelILi64ELi2EEEvPKfS2_PKhPfS5_S5_S5_iiixiii",
        "  /*0100*/  FFMA R4, R5, R6, R4 ;",
        "  /*0110*/  FFMA.FTZ R4, R5, R6, R4 ;",
        "  /*0120*/  LDS.U8 R7, [R9] ;",
        "  /*0130*/  LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;",
        "Function : _ZN46_GLOBAL__N__8188_13_dense_simt_cu_9e21dense_simt_"
        "f32_kernelILi32ELi0EEEvPKfS2_PKhPfS5_S5_S5_iiixiii",
        "  /*0100*/  FFMA R4, R5, R6, R4 ;",
        "Function : _ZN46_GLOBAL__N__8188_13_dense_simt_cu_9e13reduce_"
        "splitsEPKfPfix",
        "  /*0100*/  FFMA R4, R5, R6, R4 ;"])
    counts = dp.sass_counts(["HGMMA.64x64x16", "HGMMA.64x112x16", "FFMA",
                             "LDS.U", "UTMALDG", "LDGSTS"], sass)
    assert counts["wgmma"] == {
        "prod": {"HGMMA.64x64x16": 1, "HGMMA.64x112x16": 1, "FFMA": 0,
                 "LDS.U": 1, "UTMALDG": 1, "LDGSTS": 0},
        "mmonly": {"HGMMA.64x64x16": 1, "HGMMA.64x112x16": 0, "FFMA": 1,
                   "LDS.U": 0, "UTMALDG": 0, "LDGSTS": 0}}
    assert counts["f32"] == {
        "norecip": {"HGMMA.64x64x16": 0, "HGMMA.64x112x16": 0, "FFMA": 2,
                    "LDS.U": 1, "UTMALDG": 0, "LDGSTS": 1}}
    monkeypatch.setattr(build, "sass", lambda: sass)
    assert dp.mma_counts() == {"wgmma": {"prod": 2, "mmonly": 1},
                               "f32": {"norecip": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16,stage", ROUTE_CASES,
                         ids=[f"{dp.route_of(b)}-{s}" for b, s in ROUTE_CASES])
def test_stage_kernel_matches_plain_on_card(bf16, stage):
    """Each stage's kernel within its plain version's bound (bf16 relative
    2e-2, clamp 1e-3; f32 rtol=2e-4, atol=1e-5), two launches bitwise
    equal, and prod bitwise the production route's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from hgaprec_tpu_torch.data.device import dense_count_matrix
    a, b, y_host = _inputs(8)
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    y = dense_count_matrix(N, M, "cuda")
    y[:, :M] = torch.from_numpy(y_host).cuda()
    before = dp.dense_probe.launches
    route = dp.dense_probe.launches_by_route[dp.route_of(bf16)]
    got = dp.dense_probe(a, b, y, stage, bf16=bf16)
    again = dp.dense_probe(a, b, y, stage, bf16=bf16)
    torch.cuda.synchronize()
    assert dp.dense_probe.launches == before + 2
    assert dp.dense_probe.launches_by_route[dp.route_of(bf16)] == route + 2
    want = dp.dense_probe_reference(a, b, y, stage, bf16=bf16)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        if bf16:
            rel = (g - w).abs() / w.abs().clamp_min(1e-3)
            assert rel.max().item() < BF16_REL
        else:
            torch.testing.assert_close(g, w, **F32)
    if stage == "prod":
        prod = df.fused_dense_sweep(a, b, y, bf16=bf16)
        assert all(torch.equal(g, p) for g, p in zip(got, prod))
