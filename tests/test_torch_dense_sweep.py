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


@pytest.mark.parametrize("k,bias", [(300, False), (255, True), (200, False),
                                    (130, True), (400, False),
                                    (2600, False), (2600, True)])
def test_plain_matches_jax_wide(rng, k, bias):
    """The widths of the wide routes: past 256 packed values (K = 300;
    K = 255 with bias, 257 values) the JAX fused kernel pads the rows to
    kp = 384, at K = 200 and K = 130 with bias (the f32 route's resident
    wide kernel at kq = 256 and 192) to 256, at K = 400 (the f32 route's
    cluster kernel, kq = 512 on two CTAs) to 512, at K = 2600 (the f32
    route's unfused kernels, kq = 2624) to 2688, and runs in the
    interpreter; the port's fused_dense_sweep on the CPU (the plain
    version the wide kernels are held to) agrees at the f32 bound, bias
    sums included."""
    elogs, y = _inputs(rng, 40, 30, k, 16, bias, 0, 0)
    j_lin = [jnp.exp(jnp.asarray(e)) for e in elogs]
    t_lin = [torch.exp(torch.from_numpy(e)) for e in elogs]
    j_raw = j_fused(*j_lin[:2], jnp.asarray(y), *j_lin[2:], tile_u=8,
                    tile_c=16, interpret=True)
    t_raw = df.fused_dense_sweep(*t_lin[:2], torch.from_numpy(y),
                                 *t_lin[2:])
    assert len(t_raw) == len(j_raw) == (4 if bias else 2)
    assert t_raw[0].shape == (40, k)
    for got, ref in zip(t_raw, j_raw):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("k,bias,kernel", [(640, False, "cluster"),
                                           (3100, False, "unfused"),
                                           (3100, True, "unfused")])
def test_plain_matches_jax_wide_bf16(rng, k, bias, kernel):
    """K = 640 in bf16 (the bf16 route's cluster kernel, kq = 640 on two
    CTAs) and K = 3100 with and without bias (its unfused kernels, kq =
    3136): the JAX fused kernel in bf16 mode in the interpreter and the
    port's plain version, both rounding A, B and W to bf16, agree at the
    bf16 bound (max |g - r| / max(|r|, 1e-3) < 2e-2), bias sums
    included."""
    elogs, y = _inputs(rng, 40, 30, k, 16, bias, 0, 0)
    j_lin = [jnp.exp(jnp.asarray(e)) for e in elogs]
    t_lin = [torch.exp(torch.from_numpy(e)) for e in elogs]
    j_raw = j_fused(*j_lin[:2], jnp.asarray(y), *j_lin[2:], bf16=True,
                    tile_u=8, tile_c=16, interpret=True)
    t_raw = df.fused_dense_sweep(*t_lin[:2], torch.from_numpy(y),
                                 *t_lin[2:], bf16=True)
    assert df.dense_kernel(k + 2 * bias, True) == kernel
    assert len(t_raw) == len(j_raw) == (4 if bias else 2)
    assert t_raw[0].shape == (40, k)
    for got, ref in zip(t_raw, j_raw):
        ref = torch.from_numpy(np.asarray(ref))
        assert ((got - ref).abs() / ref.abs().clamp_min(1e-3)).max() < 2e-2


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
    (480189, 17770, "simt", (1, 2)),     # dense_simt.cu: the same plan
    (6040, 3681, "simt", (4, 6)),
    # the resident wide kernel: 64-row stationary tiles, splits that end
    # the last wave soonest (ML-1M: 786 CTAs, 6.0 a slot, against 575 and
    # 4.4 of the four-per-slot rule), long loops at Netflix shape
    (6040, 3681, "wide_f32", (4, 7)),
    (6040, 3681, "wide", (4, 7)),
    (480189, 17770, "wide_f32", (1, 1)),
    (480189, 17770, "wide", (1, 1)),
    (962399, 4096, "wide_f32", (1, 5)),
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
    (257, "wide", 320),      # K = 255 with bias: whole k-blocks of 64
    (302, "wide_f32", 320),  # K = 300 with bias
    (321, "wide", 384),      # the resident kernel's widths: 320, 384 bf16
    (130, "wide_f32", 192),  # 192, 256, 320 f32
    (200, "wide_f32", 256),
    (1000, "wide_stream", 1024),
    (64, "wide_stream_f32", 64),    # the streamed kernels take any width
    # the cluster kernel: c = max(2, ceil(kq / 320 f32, 384 bf16)) equal
    # shares of whole k-blocks, 3-5 k-blocks a CTA f32, 4-6 bf16
    (321, "cluster_f32", 384),      # two CTAs of three k-blocks
    (300, "cluster_f32", 384),      # never narrower than two shares
    (400, "cluster_f32", 512),      # K = 400: 448 padded to two of four
    (640, "cluster_f32", 640),
    (641, "cluster_f32", 768),      # three CTAs of four
    (1000, "cluster_f32", 1024),    # four of four
    (2560, "cluster_f32", 2560),    # eight of five
    (385, "cluster", 512),          # two CTAs of four k-blocks
    (640, "cluster", 640),          # K = 640: two of five
    (704, "cluster", 768),          # two of six
    (1000, "cluster", 1152),        # three of six
    (3072, "cluster", 3072),        # eight of six
])
def test_packed_width_per_kernel(kaug, kernel, want):
    assert df.packed_width(kaug, kernel) == want


@pytest.mark.parametrize("kernel", ["wgmma", "f32", "simt"])
def test_packed_width_rejects_wide_rows(kernel):
    """A narrow kernel refuses 257 packed values (K = 255 with bias), naming
    the wide kernel its route takes there; the route takes that kernel,
    on rows of five k-blocks (320 values) in one window (the resident
    kernel), where the streamed kernel would run two (bf16) or three
    (f32). The resident kernel refuses rows past its widths the same
    way, naming the cluster kernel, and the cluster kernel rows past
    eight CTAs, naming the unfused route's kernel."""
    bf16 = kernel == "wgmma"
    wide = "wide" if bf16 else "wide_f32"
    with pytest.raises(ValueError, match=wide):
        df.packed_width(257, kernel)
    assert df.dense_kernel(257, bf16) == wide
    assert df.packed_width(257, wide) == 320
    assert df.windows(320, wide) == 1
    assert df.windows(320, wide.replace("wide", "wide_stream")) == \
        (2 if bf16 else 3)
    with pytest.raises(ValueError, match="cluster"):
        df.packed_width(385 if bf16 else 321, wide)
    with pytest.raises(ValueError, match="unfused"):
        df.packed_width(3073 if bf16 else 2561,
                        wide.replace("wide", "cluster"))


@pytest.mark.parametrize("kaug,want", [(13, "f32"), (102, "f32"),
                                       (128, "f32"), (129, "wide_f32"),
                                       (202, "wide_f32"), (256, "wide_f32"),
                                       (257, "wide_f32"), (302, "wide_f32"),
                                       (320, "wide_f32"),
                                       (321, "cluster_f32"),
                                       (960, "cluster_f32"),
                                       (961, "unfused_f32"),
                                       (2560, "unfused_f32"),
                                       (2561, "unfused_f32")])
def test_f32_route_takes_the_kernel_of_its_width(kaug, want):
    """Up to 128 packed values the f32 route runs the split-product wgmma
    kernel, up to 320 the resident wide kernel's f32 route (rows padded
    to 192, 256 or 320), up to 960 the cluster kernel's, from 961 (1024
    padded) the unfused route's; the split kernel and the resident
    kernel refuse wider rows, the cluster kernel rows past 2560, and
    dense_simt.cu, on no route now, still takes up to 256."""
    assert df.f32_kernel(kaug) == want
    if want != "f32":
        with pytest.raises(ValueError, match="128"):
            df.packed_width(kaug, "f32")
    if want == "wide_f32":
        assert df.packed_width(kaug, "wide_f32") in (192, 256, 320)
    if want in ("cluster_f32", "unfused_f32"):
        with pytest.raises(ValueError, match=want):
            df.packed_width(kaug, "wide_f32")
    if kaug > 2560:
        with pytest.raises(ValueError, match="unfused_f32"):
            df.packed_width(kaug, "cluster_f32")
    if kaug <= 256:
        assert df.packed_width(kaug, "simt") == -(-kaug // 4) * 4


@pytest.mark.parametrize("kaug", [257, 320, 1024, 2560, 2561, 3072, 3073])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_routing(kaug, bf16):
    """Past 256 packed values both precisions take a wide kernel, rows
    padded to whole k-blocks of 64: up to 320 (f32) or 384 (bf16) the
    resident one, one window, 64-row stationary tiles; past them, below
    1024 values (UNFUSED_FROM), the cluster kernel, the same tiles in
    clusters of c CTAs, rows padded to c equal shares; the CTAs fill the
    card (at ML-1M shape, 132 SMs). From there the unfused route, in one
    window and, at ML-1M shape, one slab of 128-row tiles
    (tests/test_torch_dense_unfused.py holds its plan)."""
    kernel = df.dense_kernel(kaug, bf16)
    resident = kaug <= 320
    cluster = not resident and -(-kaug // 64) * 64 < df.UNFUSED_FROM
    assert kernel == ("wide" if resident else "cluster" if cluster else
                      "unfused") + ("" if bf16 else "_f32")
    kq = df.packed_width(kaug, kernel)
    c = df.cluster_size(kq, kernel)
    assert kq % 64 == 0 and kaug <= kq < kaug + 64 * c
    assert df.KERNELS[kernel].window == 0 and df.windows(kq, kernel) == 1
    tile = df.KERNELS[kernel].tile
    if kernel in df.UNFUSED_KERNELS:
        assert c == 1 and tile == (192 if bf16 else 128)
        assert len(df.unfused_plan(6040, 3681, kq, kernel)["slabs"]) == 1
        return
    assert tile == 64
    split_a, split_b = df.splits_for(6040, 3681, 132, kernel, 1, kq)
    ctas = c * (-(-6040 // tile) * split_a + -(-3681 // tile) * split_b)
    assert 2 * 132 <= ctas <= (16 if cluster else 8) * 132


@pytest.mark.parametrize("kaug,bf16", [(300, False), (300, True),
                                       (200, False)])
def test_wide_plan_stages_each_operand_once(kaug, bf16):
    """At Netflix shape the resident wide kernel forms S once per tile
    (8 N M kq products, x 6 bf16 on the f32 route) and stages into shared
    memory at most a third of the bytes the streamed kernel would (which
    restages the stationary k-blocks per moving tile and the moving tile
    per window): the figures chip_smoke.py prints beside its times."""
    n, m = 480189, 17770
    kernel = df.dense_kernel(kaug, bf16)
    res = df.wide_plan(n, m, kaug, kernel)
    stream = df.wide_plan(n, m, kaug, kernel.replace("wide", "wide_stream"))
    pieces = 1 if bf16 else 6
    assert res["kq"] == stream["kq"] == -(-kaug // 64) * 64
    assert (res["windows"], res["s_forms"]) == (1, 1)
    assert res["issued"] == 8 * n * m * res["kq"] * pieces
    assert stream["issued"] == \
        4 * n * m * stream["kq"] * (stream["windows"] + 1) * pieces
    assert 3 * res["staged"] <= stream["staged"]
    # per role: X once a CTA, then each (stationary, moving) pair's moving
    # tile (all pieces) and Y tile
    x, z = df.KERNELS[kernel].tile, df.KERNELS[kernel].moving
    p = 1 if bf16 else 3
    assert res["staged"] == sum(
        -(-nx // x) * p * x * res["kq"] * 2 +
        -(-nx // x) * -(-nz // z) * (p * z * res["kq"] * 2 + x * z)
        for nx, nz in ((n, m), (m, n)))


@pytest.mark.parametrize("kaug,bf16,c,kb", [
    (321, False, 2, 3), (448, False, 2, 4), (1024, False, 4, 4),
    (2560, False, 8, 5), (385, True, 2, 4), (704, True, 2, 6),
    (1088, True, 3, 6), (3072, True, 8, 6)])
def test_cluster_routing(kaug, bf16, c, kb):
    """The cluster kernel takes rows up to eight CTAs of at most five
    (f32) or six (bf16) k-blocks: c = max(2, ceil(kq / 320 or 384)) CTAs
    of equal shares, the packed row zero-padded to c shares, by less than
    a k-block a CTA. Past the resident kernel's widths both routes take
    it below UNFUSED_FROM (1024) packed values, the unfused route's
    kernels from there on and one past its widest row."""
    kernel = "cluster" if bf16 else "cluster_f32"
    assert df.dense_kernel(kaug, bf16) == (
        kernel if -(-kaug // 64) * 64 < df.UNFUSED_FROM else
        "unfused" + kernel[7:])
    kq = df.packed_width(kaug, kernel)
    fewest, most = df.CLUSTER_SHARES[kernel]
    assert df.cluster_shape(kaug, kernel) == (c, kb)
    assert df.cluster_shape(kq, kernel) == (c, kb)
    assert df.cluster_size(kq, kernel) == c and kq == 64 * c * kb
    assert fewest <= kb <= most
    assert kaug <= kq and kq // 64 - -(-kaug // 64) < c
    wider = 3073 if bf16 else 2561
    assert df.dense_kernel(wider, bf16) == \
        ("unfused" if bf16 else "unfused_f32")


@pytest.mark.parametrize("n,m", [(6040, 3681), (480189, 17770),
                                 (962399, 4096), (40, 30)])
@pytest.mark.parametrize("kaug,bf16", [(400, False), (1024, False),
                                       (2560, False), (640, True),
                                       (3072, True)])
def test_cluster_splits_fill_the_card_in_whole_clusters(n, m, kaug, bf16):
    """The cluster kernel's splits plan in clusters: 132 // c clusters of
    c CTAs fit the card at once, and each role block is one cluster, so
    the launch is c CTAs for every role block and fills at least two
    waves of clusters where the chunks of eight moving tiles allow (at
    every width it is built for, routed or not)."""
    kernel = "cluster" if bf16 else "cluster_f32"
    kq = df.packed_width(kaug, kernel)
    c = df.cluster_size(kq, kernel)
    spec = df.KERNELS[kernel]
    split_a, split_b = df.splits_for(n, m, 132, kernel, 1, kq)
    tiles_a, tiles_b = -(-n // spec.tile), -(-m // spec.tile)
    blocks = tiles_a * split_a + tiles_b * split_b
    slots = 132 // c
    assert blocks >= min(2 * slots, 2 * tiles_a * tiles_b //
                         (spec.min_chunk * spec.tile // spec.moving))
    # the resident kernel's rule on a card of 132 // c SMs
    assert (split_a, split_b) == df.splits_for(
        n, m, slots, "wide" if bf16 else "wide_f32")


@pytest.mark.parametrize("kaug,bf16,c", [(400, False, 2), (640, True, 2),
                                         (1000, False, 4), (2560, False, 8)])
def test_cluster_plan_stages_each_operand_once(kaug, bf16, c):
    """At Netflix shape the cluster kernel forms S once per tile (8 N M kq
    products, x 6 bf16 on the f32 route) and stages each factor once, a
    stationary tile's k-blocks split across its cluster and each moving
    tile's share staged by its CTA, and the Y tile once per CTA; the
    streamed kernel on the same rows restages the stationary k-blocks per
    moving tile and the moving tile per window."""
    n, m = 480189, 17770
    kernel = "cluster" if bf16 else "cluster_f32"
    plan = df.wide_plan(n, m, kaug, kernel)
    stream = df.wide_plan(n, m, kaug,
                          "wide_stream" if bf16 else "wide_stream_f32")
    pieces = 1 if bf16 else 6
    kq = df.packed_width(kaug, kernel)
    assert (plan["kq"], plan["cluster"]) == (kq, c)
    assert (plan["windows"], plan["s_forms"]) == (1, 1)
    assert plan["issued"] == 8 * n * m * kq * pieces
    x, z = df.KERNELS[kernel].tile, df.KERNELS[kernel].moving
    p = 1 if bf16 else 3
    assert plan["staged"] == sum(
        -(-nx // x) * p * x * kq * 2 +
        -(-nx // x) * -(-nz // z) * (p * z * kq * 2 + c * x * z)
        for nx, nz in ((n, m), (m, n)))
    assert plan["issued"] < stream["issued"]
    assert 2 * plan["staged"] < stream["staged"]


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


@pytest.mark.parametrize("k,bias", [(3, False), (100, True), (126, False),
                                    (200, False)])
def test_f32_route_checks_y_before_building(monkeypatch, k, bias):
    """Every kernel of the f32 route loads Y by TMA: an unaligned Y raises
    ValueError before any build (up to kq = 128 the split kernel, at
    K = 200 the resident wide kernel); dense_simt.cu, the yardstick,
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
                        kernel=df.f32_kernel(k + 2 * bias), **extra)
    with pytest.raises(AssertionError, match="reached the kernel build"):
        df.launch_dense(torch.rand(6, 130), torch.rand(5, 130),
                        torch.zeros(6, 5, dtype=torch.uint8), kernel="simt")


def test_f32_route_runs_the_simt_kernel():
    """`fused_dense_sweep(bf16=False)` launches the split-product wgmma
    kernel of csrc/dense_wgmma.cu up to kq = 128 and its resident wide
    kernel above it; the register-tiled kernel of csrc/dense_simt.cu
    stays built as the f32 routes' yardstick, on no route. bf16 runs the
    wgmma kernel of csrc/dense_wgmma.cu; the wgmma kernels' source also
    holds their stage probe's entries, dense_simt.cu none; the mma.sync
    design (csrc/dense_fused.cu) is gone."""
    assert {df.f32_kernel(k) for k in range(1, 321)} == {"f32", "wide_f32"}
    assert {df.f32_kernel(k) for k in range(321, 961)} == {"cluster_f32"}
    assert {df.f32_kernel(k) for k in range(961, 2700)} == {"unfused_f32"}
    for kernel, src in (("f32", "dense_wgmma.cu"), ("wgmma", "dense_wgmma.cu"),
                        ("simt", "dense_simt.cu")):
        with open(f"{build.CSRC_DIR}/{src}") as f:
            text = f.read()
        for entry in (df.KERNELS[kernel].entry, df.KERNELS[kernel].probe):
            if entry is not None:
                assert f'extern "C" int {entry}(' in text
    assert df.KERNELS["simt"].probe is None
    assert set(df.KERNELS) == {"wgmma", "f32", "simt", "wide", "wide_f32",
                               "cluster", "cluster_f32", "wide_stream",
                               "wide_stream_f32", "unfused", "unfused_f32"}
    with open(f"{build.CSRC_DIR}/dense_wgmma.cu") as f:
        text = f.read()
    for kernel in ("wide", "wide_f32", "cluster", "cluster_f32",
                   "wide_stream", "wide_stream_f32"):
        # the wide kernels, no stages
        assert df.KERNELS[kernel].probe is None
        assert f'extern "C" int {df.KERNELS[kernel].entry}(' in text
    # the unfused route's kernels have a source of their own, no stages
    with open(f"{build.CSRC_DIR}/dense_unfused.cu") as f:
        text = f.read()
    for kernel in df.UNFUSED_KERNELS:
        assert df.KERNELS[kernel].probe is None
        assert f'extern "C" int {df.KERNELS[kernel].entry}(' in text
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
    # both wgmma kernels, each with its stages, and the three wide
    # kernels, which have none
    assert text.count("__global__ void") == 5
    assert text.count("int kStage = kProd>\n__global__ void "
                      "__launch_bounds__") == 2
    assert "auto kernel = dense_wide_kernel<kP, kWn>;" in text
    assert "auto kernel = dense_res_kernel<kP, kKb, kTm>;" in text
    assert "auto kernel = dense_cluster_kernel<kP, kKb, kTm>;" in text
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
            # the unfused entries take W's slab, its rows and its stride
            # in place of the splits and their scratch
            assert len(types) == (13 if "unfused" in name else
                                  14 + name.endswith(("probe_bf16",
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
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "Function : _Z17dense_wide_kernelILi1ELi256EEv14CUtensorMap_st",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "Function : _Z17dense_wide_kernelILi3ELi128EEv14CUtensorMap_st",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "  HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR6], R24 ;",
        "Function : _Z16dense_res_kernelILi1ELi5ELi64EEv14CUtensorMap_st",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "Function : _Z16dense_res_kernelILi3ELi4ELi32EEv14CUtensorMap_st",
        "  HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "  HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR6], R24 ;",
        "  HGMMA.64x32x16.F32.BF16 R24, R8, gdesc[UR6], R24 ;",
        "Function : _Z16dense_res_kernelILi3ELi5ELi32EEv14CUtensorMap_st",
        "  FFMA R1, R2, R3, R4 ;",
        "Function : _Z20dense_cluster_kernelILi1ELi6ELi64EEv14CUtensorMap_s",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "Function : _Z20dense_cluster_kernelILi3ELi3ELi32EEv14CUtensorMap_s",
        "  HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "  HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR6], R24 ;",
        "Function : _Z14dense_w_kernelILi1ELi3EEv14CUtensorMap_stS0_PKhP",
        "  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "Function : _Z21dense_contract_kernelILi1ELi3ELi1EEv14CUtensorMap",
        "  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;",
        "Function : _Z21dense_contract_kernelILi3ELi2ELi0EEv14CUtensorMap",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR6], R24 ;"])
    monkeypatch.setattr(build, "sass", lambda: sass)
    assert df.hgmma_counts() == {"wgmma": {112: 2, 128: 0},
                                 "f32": {112: 3, 64: 0},
                                 "wide": {320: 1},
                                 "wide_f32": {256: 3, 320: 0},
                                 "cluster": {384: 1},
                                 "cluster_f32": {192: 2},
                                 "wide_stream": {256: 1},
                                 "wide_stream_f32": {128: 2},
                                 "unfused": {0: 1, 2: 1},
                                 "unfused_f32": {1: 2}}


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
    wgmma kernel, K = 200 the resident wide kernel (kq = 256), both on an
    aligned Y only (an unaligned one raises ValueError). Within
    rtol=2e-4, atol=1e-5 of the plain version, and two launches bitwise
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    lin, y = _card_inputs(n, m, k, bias, aligned=aligned, seed=n + k)
    kernel = df.f32_kernel(k + 2 * bias)
    if not aligned:
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


WIDE_CARD = [  # (n, m, k, bias, bf16): the wide kernel each route takes
    (1000, 777, 300, False, False), (1000, 777, 300, False, True),
    (333, 129, 255, True, False), (333, 129, 255, True, True),
    (517, 300, 640, False, False), (517, 300, 640, False, True),
    (64, 1, 1000, True, False), (64, 1, 1000, True, True),
    (1000, 777, 130, False, False),      # f32 resident, kq = 192
    (517, 300, 200, False, False),       # kq = 256
    (333, 129, 254, True, False),        # 256 packed values
    (300, 200, 330, False, True),        # bf16 resident, kq = 384
    (300, 200, 330, False, False),       # f32 past 320: the cluster kernel
    (64, 1, 2600, False, False),         # past 2560 f32: the unfused route
    (300, 200, 3100, False, True),       # past 3072 bf16
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,bias,bf16", WIDE_CARD)
def test_wide_kernel_matches_plain_and_repeats(n, m, k, bias, bf16):
    """The wide kernels (resident up to 320 f32 / 384 bf16 packed values,
    the cluster kernel up to 960, the unfused route from 1024 padded):
    on ragged shapes within rtol=2e-4, atol=1e-5
    (f32) or bf16 relative 2e-2 (clamp 1e-3) of the plain version, two
    launches bitwise equal, each counted under its kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    lin, y = _card_inputs(n, m, k, bias, aligned=True, seed=n + k)
    kernel = df.dense_kernel(k + 2 * bias, bf16)
    kaug = k + 2 * bias
    wide = "wide" if bf16 else "wide_f32"
    assert kernel == (wide if kaug <= (384 if bf16 else 320) else
                      wide.replace("wide", "cluster")
                      if -(-kaug // 64) * 64 < df.UNFUSED_FROM else
                      "unfused" + wide[4:])
    by_kernel = df.fused_dense_sweep.launches_by_kernel[kernel]
    got = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
    again = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
    torch.cuda.synchronize()
    assert df.fused_dense_sweep.launches_by_kernel[kernel] == by_kernel + 2
    ref = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:], bf16=bf16)
    for gg, aa, r in zip(got, again, ref):
        assert torch.equal(gg, aa)
        if bf16:
            assert ((gg - r).abs() / r.abs().clamp_min(1e-3)).max() < 2e-2
        else:
            torch.testing.assert_close(gg, r, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("kaug,bf16", [(384, False), (448, False),
                                       (448, True), (704, False),
                                       (704, True), (2560, False),
                                       (2560, True)])
def test_cluster_kernel_matches_plain_and_repeats(kaug, bf16):
    """The cluster kernel (csrc/dense_wgmma.cu, dense_cluster_kernel) at
    two, three, seven and eight CTAs a cluster, on a ragged shape with
    bias slots: within rtol=2e-4, atol=1e-5 (f32) or bf16 relative 2e-2
    (clamp 1e-3) of the plain version, two launches bitwise equal, each
    counted under its kernel where the route takes it (below 1024 packed
    values; wider rows, which the unfused route takes, launched as the
    cluster kernel directly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    lin, y = _card_inputs(517, 300, kaug - 2, True, aligned=True, seed=kaug)
    kernel = "cluster" if bf16 else "cluster_f32"
    if df.dense_kernel(kaug, bf16) == kernel:
        by_kernel = df.fused_dense_sweep.launches_by_kernel[kernel]
        got = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
        again = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
        assert df.fused_dense_sweep.launches_by_kernel[kernel] == \
            by_kernel + 2
    else:
        def call():
            return df._unpack(*df.launch_dense(*lin[:2], y, *lin[2:],
                                               kernel=kernel), kaug - 2, True)
        got, again = call(), call()
    torch.cuda.synchronize()
    ref = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:], bf16=bf16)
    for gg, aa, r in zip(got, again, ref):
        assert torch.equal(gg, aa)
        if bf16:
            assert ((gg - r).abs() / r.abs().clamp_min(1e-3)).max() < 2e-2
        else:
            torch.testing.assert_close(gg, r, **F32)
