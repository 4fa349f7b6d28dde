"""Kernel #1's unfused route (csrc/dense_unfused.cu): its slab plan and
routing on the CPU, its kernels against the plain version on the card.

From 1024 packed values (UNFUSED_FROM; the cluster kernel's below) the
dense sweep runs per slab of users: dense_w_kernel forms
S and W into an HBM slab, dense_contract_kernel forms W B and adds
W^T A. The plain version it is held to is `fused_dense_sweep_reference`
(held to the JAX package's fused kernel at K = 2600 f32 and K = 3100
bf16 in tests/test_torch_dense_sweep.py). Tolerances: f32 rtol=2e-4,
atol=1e-5 (tests/test_dense_pallas.py); bf16 max |g - r| / max(|r|,
1e-3) < 2e-2. The card tests carry the `cuda` marker and skip here.
"""

import pytest
import torch

from hgaprec_tpu_torch.ops import dense_fused as df

F32 = dict(rtol=2e-4, atol=1e-5)
ML1M, NETFLIX = (6040, 3681), (480189, 17770)


@pytest.mark.parametrize("n,m,kaug,kernel,slabs", [
    (*ML1M, 2600, "unfused_f32", 1),
    (*ML1M, 3100, "unfused", 1),
    (*NETFLIX, 2600, "unfused_f32", 24),
    (*NETFLIX, 3100, "unfused", 8),
    (40, 30, 2561, "unfused_f32", 1),
])
def test_unfused_plan_covers_the_users_in_order(n, m, kaug, kernel, slabs):
    """The slabs cover the users in order with no gap, each a whole number
    of 128 rows but the last and W's slab within the fixed budget (its
    three pieces on the f32 route): one slab at ML-1M shape, 24 (f32) and
    8 (bf16) at Netflix shape. The plan issues the function's own
    6 N M kq products (x 6 bf16 products on the f32 route), writes W once
    and reads it twice."""
    kq = df.packed_width(kaug, kernel)
    assert kq == -(-kaug // 64) * 64
    plan = df.unfused_plan(n, m, kq, kernel)
    pieces = 3 if kernel == "unfused_f32" else 1
    rows = plan["slab_rows"]
    assert rows % 128 == 0 and plan["ldw"] == -(-m // 8) * 8
    assert pieces * rows * plan["ldw"] * 2 <= df.UNFUSED_W_BYTES
    assert len(plan["slabs"]) == slabs
    ends = [0] + [u1 for _, u1 in plan["slabs"]]
    assert [u0 for u0, _ in plan["slabs"]] == ends[:-1] and ends[-1] == n
    assert all(u1 - u0 == rows for u0, u1 in plan["slabs"][:-1])
    assert 0 < plan["slabs"][-1][1] - plan["slabs"][-1][0] <= rows
    assert plan["issued"] == 6 * n * m * kq * (6 if pieces == 3 else 1)
    assert plan["w_written"] == pieces * n * m * 2
    assert plan["w_read"] == 2 * plan["w_written"]
    assert set(plan["staged"]) == {"w", "contract_a", "contract_b"}
    assert all(v > 0 for v in plan["staged"].values())


@pytest.mark.parametrize("slab_rows,want", [(128, 3), (256, 2), (384, 1),
                                            (1024, 1)])
def test_unfused_plan_takes_forced_slabs(slab_rows, want):
    """`slab_rows` (the tests' and chip_smoke.py's lever) cuts 300 users
    into slabs of that many rows, never more than the users need."""
    plan = df.unfused_plan(300, 200, 2624, "unfused_f32", slab_rows)
    assert len(plan["slabs"]) == want
    assert plan["slab_rows"] == min(slab_rows, 384)
    assert plan["slabs"][-1][1] == 300


@pytest.mark.parametrize("slab_rows", [0, 100, 129])
def test_unfused_plan_refuses_ragged_slabs(slab_rows):
    with pytest.raises(ValueError, match="128"):
        df.unfused_plan(300, 200, 2624, "unfused", slab_rows)


@pytest.mark.parametrize("kaug,bf16,want", [
    (960, False, "cluster_f32"), (961, False, "unfused_f32"),
    (960, True, "cluster"), (961, True, "unfused"),
    (1024, True, "unfused"), (2560, False, "unfused_f32"),
    (2561, False, "unfused_f32"), (3072, True, "unfused"),
    (3073, True, "unfused"), (5000, True, "unfused")])
def test_unfused_routing(kaug, bf16, want):
    """From UNFUSED_FROM (1024 packed values, once padded to whole k-blocks
    of 64) both routes take the unfused kernels, where they measured
    faster than the cluster kernel, and past the cluster kernel's widest
    row (2560 f32, 3072 bf16); the streamed kernel is on no route."""
    kernel = df.dense_kernel(kaug, bf16)
    assert kernel == want
    if want in df.UNFUSED_KERNELS:
        assert df.packed_width(kaug, kernel) == -(-kaug // 64) * 64
    assert "wide_stream" not in {df.dense_kernel(k, b)
                                 for k in (kaug - 1, kaug, kaug + 1)
                                 for b in (False, True)}


@pytest.mark.parametrize("kaug,bf16", [(2600, False), (3100, True)])
def test_wide_plan_of_the_unfused_route(kaug, bf16):
    """`wide_plan` gives the unfused route the keys it gives every wide
    kernel: one window, S formed once, the function's own issued work
    (the streamed kernel issues 4 N M kq (windows + 1)) and the three
    passes' staged bytes."""
    n, m = NETFLIX
    kernel = df.dense_kernel(kaug, bf16)
    plan = df.wide_plan(n, m, kaug, kernel)
    stream = df.wide_plan(n, m, kaug,
                          "wide_stream" if bf16 else "wide_stream_f32")
    assert set(plan) == set(stream)
    kq = df.packed_width(kaug, kernel)
    assert (plan["kq"], plan["cluster"], plan["windows"],
            plan["s_forms"]) == (kq, 1, 1, 1)
    assert plan["issued"] == 6 * n * m * kq * (1 if bf16 else 6)
    assert plan["staged"] == sum(
        df.unfused_plan(n, m, kq, kernel)["staged"].values())
    assert 9 * plan["issued"] < stream["issued"]


def test_cpu_tensor_takes_the_plain_version():
    """On a CPU tensor the route's width runs the plain version and builds
    nothing; its launch count does not move."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(9, 2561, generator=g), torch.rand(7, 2561, generator=g)
    y = torch.randint(0, 3, (9, 7), dtype=torch.uint8, generator=g)
    before = dict(df.fused_dense_sweep.launches_by_kernel)
    got = df.fused_dense_sweep(a, b, y)
    ref = df.fused_dense_sweep_reference(a, b, y)
    assert df.fused_dense_sweep.launches_by_kernel == before
    for gg, r in zip(got, ref):
        assert torch.equal(gg, r)


def _card_inputs(n, m, k, bias, seed):
    """Factors and a ragged Y on the card in the Trainer's layout (16-byte
    row stride), rows past N zero."""
    from hgaprec_tpu_torch.data.device import dense_count_matrix
    g = torch.Generator(device="cuda").manual_seed(seed)
    lin = [torch.exp(0.3 * torch.randn(s, device="cuda", generator=g))
           for s in ([(n, k), (m, k)] + ([(n,), (m,)] if bias else []))]
    y = dense_count_matrix(n + 24, m, "cuda")
    y[:n, :m] = ((torch.rand(n, m, device="cuda", generator=g) < 0.05)
                 * torch.randint(1, 6, (n, m), device="cuda", generator=g))
    return lin, y


def _close(got, ref, bf16):
    for gg, r in zip(got, ref):
        assert torch.isfinite(gg).all()
        if bf16:
            assert ((gg - r).abs() / r.abs().clamp_min(1e-3)).max() < 2e-2
        else:
            torch.testing.assert_close(gg, r, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("slab_rows", [None, 128])
@pytest.mark.parametrize("k,bf16", [(2600, False), (3100, True)])
def test_unfused_matches_plain_and_repeats(k, bf16, slab_rows):
    """On a ragged 300 x 200 shape with bias, in one slab (the route as a
    sweep takes it, counted once a call under its key) and in three
    (slab_rows = 128): within the stated tolerance of the plain version,
    two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    lin, y = _card_inputs(300, 200, k, True, seed=k)
    kernel = df.dense_kernel(k + 2, bf16)
    assert kernel == ("unfused" if bf16 else "unfused_f32")
    kq = df.packed_width(k + 2, kernel)
    slabs = len(df.unfused_plan(300, 200, kq, kernel, slab_rows)["slabs"])
    assert slabs == (3 if slab_rows else 1)
    if slab_rows is None:
        before = df.fused_dense_sweep.launches_by_kernel[kernel]
        got = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
        again = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
        assert df.fused_dense_sweep.launches_by_kernel[kernel] == before + 2
    else:
        def call():
            return df._unpack(*df.launch_dense(
                *lin[:2], y, *lin[2:], kernel=kernel, slab_rows=slab_rows),
                k, True)
        got, again = call(), call()
    torch.cuda.synchronize()
    ref = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:], bf16=bf16)
    for gg, aa in zip(got, again):
        assert torch.equal(gg, aa)
    _close(got, ref, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("k,bf16", [(2600, False), (3100, True)])
def test_unfused_replays_in_a_captured_graph(k, bf16):
    """The route runs inside a captured CUDA graph (no host
    synchronisation; W's slab from the graph's pool, here in two slabs),
    and the replay is bitwise the eager call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    lin, y = _card_inputs(300, 200, k, False, seed=k + 1)
    kernel = df.dense_kernel(k, bf16)

    def call():
        return df.launch_dense(*lin, y, kernel=kernel, slab_rows=256)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()                      # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    for e, o in zip(eager, out):
        assert torch.equal(e, o)
