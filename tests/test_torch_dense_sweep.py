"""Port dense sweep == JAX dense sweeps; the kernel's build and dispatch.

The plain version (`fused_dense_sweep_reference`, which a CPU tensor
takes) is held against the JAX fused kernel in interpret mode at small
tiles and against the JAX XLA dense path, at the f32 bound the JAX tests
pin (tests/test_dense_pallas.py: rtol=2e-4, atol=1e-5). bf16 is held
against f32 at max |g - r| / max(|r|, 1e-3) < 2e-2. The CUDA kernel
itself runs only on the card (marked `cuda`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_synthetic
from hgaprec_tpu.data.device import build_device_data
from hgaprec_tpu.ops.dense_pallas import fused_dense_sweep as j_fused
from hgaprec_tpu.ops.sweep import sweep_dense as j_sweep_dense
from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops import dense_fused as df
from hgaprec_tpu_torch.ops.sweep import sweep_dense as t_sweep_dense

F32 = dict(rtol=2e-4, atol=1e-5)

# (n, m, k, coo pad, bias, extra Y rows, extra Y cols)
CASES = [
    (40, 30, 3, 16, False, 0, 0),
    (70, 33, 5, 16, False, 0, 0),
    (40, 30, 3, 64, False, 0, 19),   # Y wider than M
    (45, 29, 4, 16, True, 0, 0),     # bias slots
    (37, 22, 3, 16, False, 11, 0),   # Y rows padded past N (odd N)
]


def _inputs(rng, n, m, k, pad, bias, extra_rows, extra_cols):
    store, _, _ = make_synthetic(rng, n=n, m=m, density=0.3)
    y = np.asarray(build_device_data(store, pad_multiple=pad).dense_y)
    y = np.pad(y, ((0, extra_rows), (0, extra_cols)))
    shapes = [(store.n, k), (store.m, k)]
    if bias:
        shapes += [(store.n,), (store.m,)]
    elogs = [(rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes]
    return elogs, y


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(rng, case):
    elogs, y = _inputs(rng, *case)
    j_lin = [jnp.exp(jnp.asarray(e)) for e in elogs]
    t_lin = [torch.exp(torch.from_numpy(e)) for e in elogs]
    bias = len(elogs) == 4
    j_raw = j_fused(*j_lin[:2], jnp.asarray(y), *j_lin[2:], tile_u=8,
                    tile_c=16, interpret=True)
    t_raw = df.fused_dense_sweep(*t_lin[:2], torch.from_numpy(y),
                                 *t_lin[2:])
    assert len(t_raw) == (4 if bias else 2)
    for got, ref in zip(t_raw, j_raw):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    # the port's plain sweep_dense against the JAX XLA dense path
    ref = j_sweep_dense(*[jnp.asarray(e) for e in elogs[:2]],
                        *([jnp.asarray(e) for e in elogs[2:]] or
                          [None, None]),
                        jnp.asarray(y), item_block=16, user_block=16)
    got = t_sweep_dense(*[torch.from_numpy(e) for e in elogs[:2]],
                        *([torch.from_numpy(e) for e in elogs[2:]] or
                          [None, None]),
                        torch.from_numpy(y), item_block=16, user_block=8)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32)


@pytest.mark.parametrize("bias", [False, True])
def test_plain_bf16_close_to_f32(rng, bias):
    elogs, y = _inputs(rng, 45, 29, 4, 16, bias, 0, 0)
    lin = [torch.exp(torch.from_numpy(e)) for e in elogs]
    y = torch.from_numpy(y)
    f32 = df.fused_dense_sweep(*lin[:2], y, *lin[2:])
    bf = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=True)
    for r, g in zip(f32, bf):
        denom = torch.clamp_min(r.abs(), 1e-3)
        assert ((g - r).abs() / denom).max().item() < 2e-2


def test_cpu_tensor_never_builds(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")
    monkeypatch.setattr(build, "load_library", no_build)
    elogs, y = _inputs(rng, 20, 15, 3, 16, True, 0, 0)
    lin = [torch.exp(torch.from_numpy(e)) for e in elogs]
    df.fused_dense_sweep(*lin[:2], torch.from_numpy(y), *lin[2:])
    before = df.fused_dense_sweep.launches
    df.fused_dense_sweep(*lin[:2], torch.from_numpy(y), bf16=True)
    assert df.fused_dense_sweep.launches == before


def test_build_command_targets_sm90a_from_csrc(monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    srcs = []
    for src in build.sources():      # one compile per source, then a link
        cmd = build.compile_command(src, "x.o")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        srcs += [c for c in cmd if c.endswith((".cu", ".cuh", ".cpp", ".cc"))]
    assert srcs and srcs == build.sources()
    for src in srcs:
        assert src.startswith(build.CSRC_DIR + "/")
    link = build.link_command("out.so", ["x.o"])
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert build.library_path().startswith(build.BUILD_DIR + "/")


@pytest.mark.parametrize("n,m,want", [
    (6040, 3681, (4, 6)),        # ML-1M: 732 CTAs of 15-16 tiles
    (480189, 17770, (1, 2)),     # Netflix: long loops, item role halved
    (40, 30, (1, 1)),
])
def test_kernel_splits_fill_the_card(n, m, want):
    """The moving-loop chunks the wrapper asks for on a 132-SM H100."""
    split_a, split_b = df.splits_for(n, m, sms=132)
    assert (split_a, split_b) == want
    tiles_a, tiles_b = -(-n // df.TILE), -(-m // df.TILE)
    # enough CTAs for two per SM wherever chunks of MIN_CHUNK tiles allow
    ctas = tiles_a * split_a + tiles_b * split_b
    assert ctas >= min(2 * 132, 2 * tiles_a * tiles_b // df.MIN_CHUNK)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "ystride",
                                 "bias"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, b = torch.rand(6, 3), torch.rand(5, 3)
    y = torch.zeros(6, 5, dtype=torch.uint8)
    kw = {}
    if bad == "dtype":
        a = a.double()
    elif bad == "shape":
        y = y[:4]
    elif bad == "contig":
        a = torch.rand(3, 6).T
    elif bad == "ystride":
        y = torch.zeros(5, 6, dtype=torch.uint8).T
    else:
        kw = {"ba_lin": torch.rand(6)}
    with pytest.raises(ValueError):
        df.fused_dense_sweep(a, b, y, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(bias, bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    n, m, k = 1000, 777, 13
    lin = [torch.exp(0.3 * torch.randn(s, device="cuda", generator=g))
           for s in ([(n, k), (m, k)] + ([(n,), (m,)] if bias else []))]
    y = ((torch.rand(n + 24, m + 5, device="cuda", generator=g) < 0.05)
         * torch.randint(1, 6, (n + 24, m + 5), device="cuda",
                         generator=g)).to(torch.uint8)
    y[n:] = 0
    y[:, m:] = 0
    before = df.fused_dense_sweep.launches
    got = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
    torch.cuda.synchronize()
    assert df.fused_dense_sweep.launches == before + 1
    ref = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:])
    for gg, r in zip(got, ref):
        if bf16:
            assert ((gg - r).abs() / r.abs().clamp_min(1e-3)).max() < 2e-2
        else:
            torch.testing.assert_close(gg, r, **F32)
