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


@pytest.mark.parametrize("n,m,kernel,want", [
    (6040, 3681, "wgmma", (4, 6)),       # ML-1M: 366 CTAs of 7-8 tiles
    (480189, 17770, "wgmma", (1, 2)),    # Netflix: long loops, item role halved
    (40, 30, "wgmma", (1, 1)),
    (962399, 4096, "wgmma", (1, 9)),     # EchoNest head: 32 item tiles
    (480189, 17770, "f32", (1, 2)),      # f32: 128-row tiles, as wgmma
    (6040, 3681, "f32", (4, 6)),
    (962399, 4096, "f32", (1, 9)),
    (480189, 17770, "simt", (1, 2)),     # f32 past kq = 128: the same plan
    (6040, 3681, "simt", (4, 6)),
])
def test_kernel_splits_fill_the_card(n, m, kernel, want):
    """The moving-loop chunks the wrapper asks for on a 132-SM H100."""
    split_a, split_b = df.splits_for(n, m, sms=132, kernel=kernel)
    assert (split_a, split_b) == want
    spec = df.KERNELS[kernel]
    tiles_a, tiles_b = -(-n // spec.tile), -(-m // spec.tile)
    # enough CTAs to fill every resident slot wherever chunks of min_chunk
    # tiles allow
    ctas = tiles_a * split_a + tiles_b * split_b
    assert ctas >= min(spec.per_sm * 132,
                       2 * tiles_a * tiles_b // spec.min_chunk)


@pytest.mark.parametrize("kaug,kernel,want", [
    (100, "wgmma", 112),     # K = 100: two k-blocks, the second partial
    (102, "wgmma", 112),     # with bias
    (113, "wgmma", 128),
    (13, "wgmma", 64),
    (64, "wgmma", 64),
    (200, "wgmma", 256),
    (102, "f32", 112),       # the split kernel's widths are the wgmma ones
    (13, "f32", 64),
    (126, "f32", 128),       # K = 124 with bias: the widest it takes
    (102, "simt", 104),      # 16-byte chunks at the true width
    (13, "simt", 16),
    (200, "simt", 200),
])
def test_packed_width_per_kernel(kaug, kernel, want):
    assert df.packed_width(kaug, kernel) == want


@pytest.mark.parametrize("kernel", ["wgmma", "f32", "simt"])
def test_packed_width_rejects_wide_rows(kernel):
    with pytest.raises(ValueError):
        df.packed_width(257, kernel)


@pytest.mark.parametrize("kaug,want", [(13, "f32"), (102, "f32"),
                                       (128, "f32"), (129, "simt"),
                                       (202, "simt")])
def test_f32_route_takes_the_kernel_of_its_width(kaug, want):
    """Up to 128 packed values the f32 route runs the split-product wgmma
    kernel, above it dense_simt.cu; the split kernel refuses wider rows."""
    assert df.f32_kernel(kaug) == want
    if want == "simt":
        with pytest.raises(ValueError, match="128"):
            df.packed_width(kaug, "f32")


def test_tma_layout_check():
    """The bf16 route loads Y with TMA: a row stride and base that are
    multiples of 16 bytes pass, anything else raises ValueError."""
    from hgaprec_tpu_torch.data.device import dense_count_matrix
    df.check_tma_layout(dense_count_matrix(7, 29, "cpu"))       # stride 32
    df.check_tma_layout(torch.zeros(5, 48, dtype=torch.uint8))
    with pytest.raises(ValueError, match="16 bytes"):
        df.check_tma_layout(torch.zeros(5, 29, dtype=torch.uint8))
    with pytest.raises(ValueError, match="16 bytes"):   # base 1 byte in
        df.check_tma_layout(torch.zeros(5, 48, dtype=torch.uint8)[:, 1:30])


def test_wgmma_route_checks_y_before_building(monkeypatch):
    def no_build():
        raise AssertionError("an unaligned Y reached the kernel build")
    monkeypatch.setattr(build, "load_library", no_build)
    a, b = torch.rand(6, 3), torch.rand(5, 3)
    with pytest.raises(ValueError, match="TMA"):
        df.launch_dense(a, b, torch.zeros(6, 5, dtype=torch.uint8),
                        kernel="wgmma")


@pytest.mark.parametrize("k,bias", [(3, False), (100, True), (126, False)])
def test_f32_route_checks_y_before_building(monkeypatch, k, bias):
    """The f32 route up to kq = 128 loads Y by TMA too: an unaligned Y
    raises ValueError before any build; dense_simt.cu, past kq = 128,
    takes any stride."""
    def no_build():
        raise AssertionError("an unaligned Y reached the kernel build")
    monkeypatch.setattr(build, "load_library", no_build)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: type(
        "Props", (), {"multi_processor_count": 132})())
    a, b = torch.rand(6, k), torch.rand(5, k)
    extra = dict(ba_lin=torch.rand(6), bb_lin=torch.rand(5)) if bias else {}
    with pytest.raises(ValueError, match="TMA"):
        df.launch_dense(a, b, torch.zeros(6, 5, dtype=torch.uint8),
                        kernel="f32", **extra)
    with pytest.raises(AssertionError, match="reached the kernel build"):
        df.launch_dense(torch.rand(6, 130), torch.rand(5, 130),
                        torch.zeros(6, 5, dtype=torch.uint8), kernel="simt")


def test_f32_route_runs_the_simt_kernel():
    """`fused_dense_sweep(bf16=False)` launches the split-product wgmma
    kernel of csrc/dense_wgmma.cu up to kq = 128 and the register-tiled
    kernel of csrc/dense_simt.cu above it, bf16 the wgmma kernel of
    csrc/dense_wgmma.cu; the wgmma kernels' source also holds their stage
    probe's entries, dense_simt.cu none; the mma.sync design
    (csrc/dense_fused.cu) is gone."""
    for kernel, src in (("f32", "dense_wgmma.cu"), ("wgmma", "dense_wgmma.cu"),
                        ("simt", "dense_simt.cu")):
        with open(f"{build.CSRC_DIR}/{src}") as f:
            text = f.read()
        for entry in (df.KERNELS[kernel].entry, df.KERNELS[kernel].probe):
            if entry is not None:
                assert f'extern "C" int {entry}(' in text
    assert df.KERNELS["simt"].probe is None
    assert set(df.KERNELS) == {"wgmma", "f32", "simt"}
    assert build.CSRC_DIR + "/dense_fused.cu" not in build.sources()
    for src in build.sources() + build.headers():
        with open(src) as f:
            text = f.read()
        for gone in ("hpf_dense_fused_sweep_bf16", "hpf_dense_probe_bf16",
                     "hpf_dense_simt_probe_f32", "mma.sync.aligned",
                     "dense_fused.cu"):
            assert gone not in text, (src, gone)


def test_probe_stages_are_instantiations_of_the_production_kernels():
    """Each kernel takes the stage as a template parameter whose default
    is the production stage, and each probe entry launches that kernel
    (no copy of it); the stage enum is the one of ops/dense_probe.py."""
    from hgaprec_tpu_torch.ops import dense_probe as dp
    with open(f"{build.CSRC_DIR}/dense_roles.cuh") as f:
        roles = f.read()
    for name, value in dp.STAGES.items():
        const = "k" + {"prod": "Prod", "bf16recip": "Bf16Recip",
                       "norecip": "NoRecip", "noyload": "NoYLoad",
                       "mmonly": "MmOnly"}[name]
        assert f"{const} = {value}" in roles
    with open(f"{build.CSRC_DIR}/dense_wgmma.cu") as f:
        text = f.read()
    # both wgmma kernels, each with its stages
    assert text.count("__global__ void") == 2
    assert text.count("int kStage = kProd>\n__global__ void "
                      "__launch_bounds__") == 2
    for kernel in ("dense_wgmma_kernel", "dense_split_kernel"):
        assert f"auto kernel = {kernel}<" in text
    # dense_simt.cu is built only as the production kernel
    with open(f"{build.CSRC_DIR}/dense_simt.cu") as f:
        text = f.read()
    assert text.count("__global__ void") == 1 and "kStage" not in text
    assert "auto kernel = dense_simt_f32_kernel<" in text
    # a stage on a row wider than the probe's instantiations is refused,
    # and dense_simt.cu has none
    a, b = torch.rand(6, 120), torch.rand(5, 120)
    y = torch.zeros(6, 16, dtype=torch.uint8)[:, :5]
    for kernel in ("wgmma", "f32"):
        with pytest.raises(ValueError, match="probe"):
            df.launch_dense(a, b, y, kernel=kernel, stage=0)
    with pytest.raises(ValueError, match="no probe stages"):
        df.launch_dense(a[:, :8], b[:, :8], y, kernel="simt", stage=0)


def test_entries_are_typed_once(monkeypatch):
    """Each C entry of the dense kernels, production and probe, gets its
    argument types when first used, not per call."""
    loads = []

    class Lib:
        pass

    for name in df._ARGTYPES:
        setattr(Lib, name, type("Fn", (), {})())
    monkeypatch.setattr(build, "load_library",
                        lambda: loads.append(1) or Lib)
    df._entry.cache_clear()
    try:
        assert set(df._ARGTYPES) == {e for k in df.KERNELS.values()
                                     for e in (k.entry, k.probe) if e}
        for name, types in df._ARGTYPES.items():
            assert df._entry(name) is df._entry(name)
            assert df._entry(name).argtypes == types
            assert len(types) == 14 + (name.endswith(("probe_bf16",
                                                      "probe_f32")))
        assert len(loads) == len(df._ARGTYPES)
    finally:
        df._entry.cache_clear()


def test_hgmma_counts_per_instantiation(monkeypatch):
    """Each wgmma kernel's production instantiation at each packed width
    is counted on its own, so a width whose products were folded away
    shows zero; the probe's other stages and other kernels do not
    count."""
    sass = "\n".join([
        "Function : _Z18dense_wgmma_kernelILi112ELi0EEv14CUtensorMap_st",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "  HGMMA.64x112x16.F32.BF16 R88, R8, gdesc[UR8], R88 ;",
        "Function : _Z18dense_wgmma_kernelILi128ELi0EEv14CUtensorMap_st",
        "  FFMA R1, R2, R3, R4 ;",
        "Function : _Z18dense_wgmma_kernelILi112ELi4EEv14CUtensorMap_st",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "Function : _Z18dense_split_kernelILi112ELi0EEv14CUtensorMap_st",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR6], R24 ;",
        "  HGMMA.64x112x16.F32.BF16 R88, R8, gdesc[UR8], R88 ;",
        "Function : _Z18dense_split_kernelILi112ELi3EEv14CUtensorMap_st",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "Function : _Z18dense_split_kernelILi64ELi0EEv14CUtensorMap_st",
        "  LDS.U8 R1, [R2] ;",
        "Function : _Z21dense_simt_f32_kernelILi64EEvPKf",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;"])
    monkeypatch.setattr(build, "sass", lambda: sass)
    assert df.hgmma_counts() == {"wgmma": {112: 2, 128: 0},
                                 "f32": {112: 3, 64: 0}}


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


def _card_inputs(n, m, k, bias, aligned, seed=0):
    """Factors and a ragged Y on the card: rows past N and columns past M
    are zero; aligned=True gives the Trainer's 16-byte row stride (the
    bf16 route needs it), else contiguous rows of M + 5 bytes."""
    from hgaprec_tpu_torch.data.device import dense_count_matrix
    g = torch.Generator(device="cuda").manual_seed(seed)
    lin = [torch.exp(0.3 * torch.randn(s, device="cuda", generator=g))
           for s in ([(n, k), (m, k)] + ([(n,), (m,)] if bias else []))]
    y = (dense_count_matrix(n + 24, m, "cuda") if aligned else
         torch.zeros((n + 24, m + 5), dtype=torch.uint8, device="cuda"))
    y[:n, :m] = ((torch.rand(n, m, device="cuda", generator=g) < 0.05)
                 * torch.randint(1, 6, (n, m), device="cuda", generator=g))
    return lin, y


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(bias, bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # both routes load Y with TMA at this width
    lin, y = _card_inputs(1000, 777, 13, bias, aligned=True)
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k", [(1000, 777, 13), (333, 129, 100),
                                   (517, 300, 200), (64, 1, 7)])
@pytest.mark.parametrize("bias", [False, True])
def test_wgmma_kernel_matches_plain_and_repeats(n, m, k, bias):
    """The bf16 route (csrc/dense_wgmma.cu) on ragged shapes: within bf16
    relative 2e-2 of the plain version in bf16 (clamp 1e-3), and two
    launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    lin, y = _card_inputs(n, m, k, bias, aligned=True, seed=n + k)
    got = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=True)
    again = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=True)
    torch.cuda.synchronize()
    ref = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:], bf16=True)
    for gg, aa, r in zip(got, again, ref):
        assert torch.equal(gg, aa)
        assert ((gg - r).abs() / r.abs().clamp_min(1e-3)).max() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k", [(1000, 777, 13), (333, 129, 100),
                                   (517, 300, 200), (64, 1, 7)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("aligned", [False, True])
def test_f32_kernel_matches_plain_and_repeats(n, m, k, bias, aligned):
    """The f32 route on ragged shapes: up to kq = 128 the split-product
    wgmma kernel, which takes an aligned Y only (an unaligned one raises
    ValueError); K = 200 the kernel of csrc/dense_simt.cu, on an aligned
    Y (cp.async) and an unaligned one (byte loads), its rows wider than
    128 values contracted in two column windows. Within rtol=2e-4,
    atol=1e-5 of the plain version, and two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    lin, y = _card_inputs(n, m, k, bias, aligned=aligned, seed=n + k)
    kernel = df.f32_kernel(k + 2 * bias)
    if kernel == "f32" and not aligned:
        with pytest.raises(ValueError, match="TMA"):
            df.fused_dense_sweep(*lin[:2], y, *lin[2:])
        return
    before = df.fused_dense_sweep.launches
    by_kernel = df.fused_dense_sweep.launches_by_kernel[kernel]
    got = df.fused_dense_sweep(*lin[:2], y, *lin[2:])
    again = df.fused_dense_sweep(*lin[:2], y, *lin[2:])
    torch.cuda.synchronize()
    assert df.fused_dense_sweep.launches == before + 2
    assert df.fused_dense_sweep.launches_by_kernel[kernel] == by_kernel + 2
    ref = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:])
    for gg, aa, r in zip(got, again, ref):
        assert torch.equal(gg, aa)
        torch.testing.assert_close(gg, r, **F32)
