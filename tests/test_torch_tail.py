"""Port tail sweep == JAX tail sweeps; the tail kernel's build and wrapper.

The plain version (`ops/tail.py::tail_sweep_reference`, which a CPU
tensor takes) is held against the JAX MXU tail (`mxu_tail_sweep`) and
the Pallas tail kernel in interpret mode, both in f32, at the bound
tests/test_pallas_tail.py pins (rtol=2e-5, atol=1e-6), on that file's
adversarial layouts plus an empty tail and untouched rows. bf16 mode is
held against JAX's bf16 MXU tail at 2e-2 relative (the bf16 bound of
tests/test_pallas_tail.py::test_bf16_tail_vs_f32_mxu). The f32 route on
the card is the CSR sweep's two passes over the tail: the tail laid out
as that sweep's COO, through its plain version
(`ops/segment.py::segment_sweep_reference`), is held against both JAX
tails at the same f32 bound. The CUDA kernels run only on the card
(marked `cuda`).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgaprec_tpu.ops.mxu_tail import build_tail_compact, mxu_tail_sweep
from hgaprec_tpu.ops.pallas_tail import CHUNK, pallas_tail_sweep
from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops import segment_fused as sf
from hgaprec_tpu_torch.ops import tail_fused as tf
from hgaprec_tpu_torch.ops.segment import segment_sweep_reference
from hgaprec_tpu_torch.ops.tail import (build_tail_stream,
                                        half_sweep_reference, tail_tables,
                                        tail_sweep_reference)

F32 = dict(rtol=2e-5, atol=1e-6)


def _rand_coo(rng, n, m, nnz, gap_users=False):
    """tests/test_pallas_tail.py::_rand_coo (duplicates kept)."""
    u = rng.integers(0, n, nnz).astype(np.int32)
    if gap_users:
        u = np.where(u % 3 == 0, u, (u * 997) % n).astype(np.int32)
    i = rng.integers(0, m, nnz).astype(np.int32)
    order = np.lexsort((i, u))
    u, i = u[order], i[order]
    y = rng.integers(1, 5, nnz).astype(np.float32)
    return u, i, y


def _layout(name, rng):
    """(n, m, u, i, y) for each adversarial layout."""
    if name in ("random", "gaps"):
        n, m = 5000, 900
        return (n, m) + _rand_coo(rng, n, m, 3300, gap_users=name == "gaps")
    if name == "every_user":      # identity-primary regime of the TPU tail
        n, m = 700, 300
        u = np.repeat(np.arange(n, dtype=np.int32), 4)
        i = rng.integers(0, m, u.size).astype(np.int32)
        order = np.lexsort((i, u))
        return n, m, u[order], i[order], \
            rng.integers(1, 4, u.size).astype(np.float32)[order]
    if name == "single_chunk":
        return (200, 50) + _rand_coo(rng, 200, 50, CHUNK // 2)
    if name == "long_rows":       # rows far longer than a warp's range
        n, m = 40, 3000
        u = np.repeat(np.arange(0, n, 3, dtype=np.int32), 700)
        i = rng.integers(0, m, u.size).astype(np.int32)
        order = np.lexsort((i, u))
        return n, m, u[order], i[order], \
            rng.integers(1, 6, u.size).astype(np.float32)
    raise ValueError(name)


LAYOUTS = ["random", "gaps", "every_user", "single_chunk", "long_rows"]


def _tables(rng, n, m, k, bias):
    a = rng.random((n, k)).astype(np.float32) + 0.1
    b = rng.random((m, k)).astype(np.float32) + 0.1
    if not bias:
        return a, b, None, None
    return (a, b, rng.random(n).astype(np.float32) + 0.05,
            rng.random(m).astype(np.float32) + 0.05)


def _port(tables, u, i, y, bf16=False):
    stream = build_tail_stream(u, i, y, "cpu")
    t = [None if x is None else torch.from_numpy(x) for x in tables]
    return tail_sweep_reference(*t, stream, bf16=bf16)


def _jax(tables, tc, impl, bf16=False):
    j = [None if x is None else jnp.asarray(x) for x in tables]
    if impl == "mxu":
        return mxu_tail_sweep(*j, tc, bf16=bf16)
    return pallas_tail_sweep(*j, tc, bf16=bf16, interpret=True)


def _assert_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("impl", ["mxu", "pallas"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", LAYOUTS)
def test_plain_matches_jax_f32(name, bias, impl):
    rng = np.random.default_rng(LAYOUTS.index(name) + 10 * bias)
    n, m, u, i, y = _layout(name, rng)
    tables = _tables(rng, n, m, 12, bias)
    tc = build_tail_compact(u, i, y, n_users=n if name == "every_user"
                            else 0)
    _assert_close(_port(tables, u, i, y), _jax(tables, tc, impl), **F32)


@pytest.mark.parametrize("k,bias", [(300, False), (255, True),
                                    (1100, False)])
def test_plain_matches_jax_wide(k, bias):
    """Past 256 packed values (K = 300; K = 255 with bias, 257 values; K =
    1100, which the card's kernels cut into two column windows) the
    Pallas tail kernel pads the rows to a multiple of 128 and runs in the
    interpreter; the port's tail on the CPU (the plain version both wide
    routes are held to) and the tail laid out as the CSR sweep's COO
    through its plain version (the f32 route's function) agree with it
    at the f32 bound."""
    rng = np.random.default_rng(k)
    n, m, u, i, y = _layout("random", rng)
    tables = _tables(rng, n, m, k, bias)
    tc = build_tail_compact(u, i, y, n_users=0)
    want = _jax(tables, tc, "pallas")
    _assert_close(_port(tables, u, i, y), want, **F32)
    stream = build_tail_stream(u, i, y, "cpu")
    a_t, b_t = tail_tables(*[None if x is None else torch.from_numpy(x)
                             for x in tables], bf16=False)
    assert a_t.shape[1] == (k + 2 * bias + 3) // 4 * 4
    acc_a, acc_b = segment_sweep_reference(a_t, b_t, _as_csr(stream))
    got = (acc_a[:, :k], acc_b[:, :k]) + (
        (acc_a[:, k], acc_b[:, k + 1]) if bias else (None, None))
    _assert_close(got, want, **F32)


@pytest.mark.parametrize("name", LAYOUTS)
def test_stream_order_maps_item_sorted_onto_user_sorted(name):
    """TailStream.order is the user-sorted position of each item-sorted
    entry, the index through which the f32 route's item pass reads the
    user pass's weights."""
    rng = np.random.default_rng(20 + LAYOUTS.index(name))
    n, m, u, i, y = _layout(name, rng)
    s = build_tail_stream(u, i, y, "cpu")
    order = s.order.numpy()
    assert s.order.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(u.size))
    np.testing.assert_array_equal(s.u.numpy()[order], s.u_by_item.numpy())
    np.testing.assert_array_equal(s.i.numpy()[order], s.i_by_item.numpy())
    np.testing.assert_array_equal(s.y.numpy()[order], s.y_by_item.numpy())


def _as_csr(stream):
    """The tail laid out as the CSR sweep's dual-sorted COO (unpadded)."""
    return DeviceData(u_ids=stream.u, i_ids=stream.i, y=stream.y,
                      item_order=stream.order, i_ids_sorted=stream.i_by_item,
                      u_ids_by_item=stream.u_by_item, dense_y=None)


@pytest.mark.parametrize("impl", ["mxu", "pallas"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", LAYOUTS)
def test_tail_as_csr_sweep_matches_jax_f32(name, bias, impl):
    """The f32 route's function: the CSR sweep's plain version over the
    tail, one weight per nonzero found in the user pass and read again in
    the item pass, gives JAX's four tail sums."""
    rng = np.random.default_rng(30 + LAYOUTS.index(name) + 10 * bias)
    n, m, u, i, y = _layout(name, rng)
    tables = _tables(rng, n, m, 12, bias)
    t = [None if x is None else torch.from_numpy(x) for x in tables]
    out_a, out_b = segment_sweep_reference(
        *tail_tables(*t, bf16=False), _as_csr(build_tail_stream(u, i, y,
                                                                "cpu")))
    got = (out_a[:, :12], out_b[:, :12]) + \
        ((out_a[:, 12], out_b[:, 13]) if bias else (None, None))
    tc = build_tail_compact(u, i, y, n_users=n if name == "every_user"
                            else 0)
    _assert_close(got, _jax(tables, tc, impl), **F32)


def test_untouched_rows_read_zero():
    rng = np.random.default_rng(3)
    n, m = 900, 400
    u, i, y = _rand_coo(rng, 600, 300, 2000)   # users >= 600, items >= 300
    tables = _tables(rng, n, m, 8, True)       # absent from the stream
    acc_a, acc_b, acc_ba, acc_bb = _port(tables, u, i, y)
    assert acc_a.shape == (n, 8) and acc_b.shape == (m, 8)
    for t, first in ((acc_a, 600), (acc_b, 300), (acc_ba, 600),
                     (acc_bb, 300)):
        assert torch.count_nonzero(t[first:]) == 0
        assert torch.count_nonzero(t[:first]) > 0
    want = mxu_tail_sweep(*[jnp.asarray(x) for x in tables],
                          build_tail_compact(u, i, y), bf16=False)
    _assert_close((acc_a, acc_b, acc_ba, acc_bb), want, **F32)


@pytest.mark.parametrize("bias", [False, True])
def test_empty_tail_is_zero_and_launches_nothing(bias, monkeypatch):
    def no_half(*args, **kw):
        raise AssertionError("an empty tail ran a half-sweep")
    monkeypatch.setattr(tf, "fused_half_sweep", no_half)
    rng = np.random.default_rng(4)
    tables = [None if x is None else torch.from_numpy(x)
              for x in _tables(rng, 30, 20, 5, bias)]
    empty = np.zeros(0, np.int32)
    stream = build_tail_stream(empty, empty, np.zeros(0, np.float32), "cpu")
    out = tf.tail_sweep(*tables, stream, bf16=False)
    assert out[0].shape == (30, 5) and out[1].shape == (20, 5)
    assert all((t is None) == (not bias) for t in out[2:])
    for t in out:
        if t is not None:
            assert torch.count_nonzero(t) == 0


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", ["random", "long_rows"])
def test_plain_bf16_matches_jax_bf16(name, bias):
    rng = np.random.default_rng(41 + bias)
    n, m, u, i, y = _layout(name, rng)
    tables = _tables(rng, n, m, 16, bias)
    got = _port(tables, u, i, y, bf16=True)
    want = _jax(tables, build_tail_compact(u, i, y), "mxu", bf16=True)
    for g, w in zip(got, want):
        if w is None:
            continue
        w = np.asarray(w)
        denom = np.maximum(np.abs(w), 1e-3)
        assert np.max(np.abs(g.numpy() - w) / denom) < 2e-2


def test_stream_orders_and_tables():
    rng = np.random.default_rng(5)
    n, m, u, i, y = _layout("gaps", rng)
    s = build_tail_stream(u, i, y, "cpu")
    tc = build_tail_compact(u, i, y)
    users, items = np.asarray(tc.users), np.asarray(tc.items)
    nnz = u.size
    np.testing.assert_array_equal(s.u.numpy(), users[np.asarray(tc.cu)][:nnz])
    np.testing.assert_array_equal(s.i.numpy(), items[np.asarray(tc.ci)][:nnz])
    np.testing.assert_array_equal(
        s.i_by_item.numpy(), items[np.asarray(tc.ci_i)][:nnz])
    np.testing.assert_array_equal(
        s.u_by_item.numpy(), users[np.asarray(tc.cu_i)][:nnz])
    np.testing.assert_array_equal(s.y_by_item.numpy(),
                                  np.asarray(tc.y_i)[:nnz])
    assert s.u.dtype == torch.int32 and s.y.dtype == torch.float32
    # [A | ba | 1] and [B | 1 | bb] at 16-byte rows
    from hgaprec_tpu_torch.ops.tail import tail_tables
    a, b = torch.rand(4, 5), torch.rand(3, 5)
    ba, bb = torch.rand(4), torch.rand(3)
    at, bt = tail_tables(a, b, ba, bb, bf16=True)
    assert at.dtype == torch.bfloat16 and at.shape == (4, 8)
    assert bt.shape == (3, 8) and at.stride(0) * 2 % 16 == 0
    a32, b32 = tail_tables(a, b, ba, bb, bf16=False)
    assert a32.shape == (4, 8) and torch.equal(a32[:, 5], ba)
    assert torch.equal(a32[:, 6], torch.ones(4))
    assert torch.equal(b32[:, 5], torch.ones(3))
    assert torch.equal(b32[:, 6], bb) and torch.count_nonzero(a32[:, 7]) == 0


def test_cpu_tensor_never_builds(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")
    monkeypatch.setattr(build, "load_library", no_build)
    rng = np.random.default_rng(6)
    n, m, u, i, y = _layout("random", rng)
    tables = [torch.from_numpy(x) for x in _tables(rng, n, m, 6, False)[:2]]
    stream = build_tail_stream(u, i, y, "cpu")
    before = tf.fused_half_sweep.launches
    for bf16 in (False, True):
        got = tf.tail_sweep(*tables, None, None, stream, bf16=bf16)
        want = tail_sweep_reference(*tables, None, None, stream, bf16=bf16)
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w)
    assert tf.fused_half_sweep.launches == before


def test_build_command_names_the_tail_source(monkeypatch):
    """The bf16 route is tail_bf16.cu; the f32 route is the CSR sweep's
    segment_sweep.cu. The old f32 source and its row sweep are gone:
    row_sweep.cuh keeps only what both kernels share (the fix-up)."""
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    srcs = build.sources()
    for route in ("tail_bf16.cu", "segment_sweep.cu"):
        assert build.CSRC_DIR + "/" + route in srcs
        cmd = build.compile_command(build.CSRC_DIR + "/" + route, "t.o")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[-1] == build.CSRC_DIR + "/" + route
    assert build.CSRC_DIR + "/tail_fused.cu" not in srcs
    assert build.CSRC_DIR + "/dense_fused.cu" not in srcs
    assert build.CSRC_DIR + "/row_sweep.cuh" in build.headers()
    with open(build.CSRC_DIR + "/tail_bf16.cu") as f:
        src = f.read()
    assert "hpf_tail_half_sweep_bf16" in src and "cp.async" in src
    with open(build.CSRC_DIR + "/segment_sweep.cu") as f:
        src = f.read()
    assert "hpf_segment_user_pass_f32" in src
    assert "hpf_segment_item_pass_f32" in src
    with open(build.CSRC_DIR + "/row_sweep.cuh") as f:
        src = f.read()
    for gone in ("row_sweep_kernel", "launch_row_sweep", "kDotStore",
                 "tail_fused.cu", "segment_fused.cu"):
        assert gone not in src
    assert "row_fixup_kernel" in src and "launch_row_fixup" in src


# (lanes, chunks a lane, windows) of each route's half at each width: up
# to 256 values the narrow kernels' groups; past 256 the wide passes' (K =
# 255 with bias is 264 values, K = 300 is 304 in bf16 and f32, K = 330 is
# 336); past 1024 two column windows, the weights found first
SHAPES = {8: ((8, 1, 1), (4, 2, 1)), 16: ((8, 1, 1), (4, 2, 1)),
          64: ((8, 1, 1), (8, 2, 1)), 72: ((16, 1, 1), (16, 2, 1)),
          104: ((16, 1, 1), (16, 2, 1)), 128: ((16, 1, 1), (16, 2, 1)),
          136: ((32, 1, 1), (32, 2, 1)), 200: ((32, 1, 1), (32, 2, 1)),
          256: ((32, 1, 1), (32, 2, 1)), 264: ((16, 3, 1), (16, 5, 1)),
          304: ((16, 3, 1), (16, 5, 1)), 320: ((16, 3, 1), (16, 5, 1)),
          336: ((16, 3, 1), (32, 3, 1)), 640: ((32, 3, 1), (32, 5, 1)),
          1000: ((32, 4, 1), (32, 8, 1)), 1024: ((32, 4, 1), (32, 8, 1)),
          1104: ((32, 3, 2), (32, 5, 2)), 2048: ((32, 4, 2), (32, 8, 2))}


@pytest.mark.parametrize("kq", sorted(SHAPES))
def test_plan_picks_the_entry_and_group_by_width(kq):
    """Up to 256 values one 16-byte chunk a lane (bf16) or two (f32) in
    the fewest lanes; past 256 the wide passes' shape: groups of 16 or 32
    lanes of at most 32 values a lane each, as many column windows as
    that takes, the shape that covers the row with the fewest idle chunk
    slots, less than one a lane."""
    for bf16, want in zip((True, False), SHAPES[kq]):
        name, shape = tf.plan(bf16, kq)
        assert name == ("hpf_tail_half_sweep_bf16" if bf16 else
                        "hpf_segment_user_pass_f32")
        assert name in sf._ARGTYPES or bf16
        assert shape == sf.pass_plan(kq, bf16)
        assert (shape.lanes, shape.chunks, shape.windows) == want
        assert shape.weights == (shape.windows > 1)
        per = 8 if bf16 else 4
        lanes = shape.lanes * shape.windows    # lanes on one range
        # the chunks cover the row, less than one chunk a lane idle
        assert per * lanes * shape.chunks >= kq
        assert lanes * shape.chunks - kq // per < lanes or kq <= 256
        if kq <= 256:   # the narrow kernels: the fewest lanes
            assert shape.lanes == (8 if bf16 else 4) or \
                per * shape.chunks * shape.lanes // 2 < kq
        else:           # a lane holds at most 32 values
            assert per * shape.chunks <= sf.WIDE_CAP


def test_weights_scratch_follows_the_kernels_rule():
    """Past one window (32 lanes of WIDE_CAP values) a dot sweep keeps its
    weights, and the bf16 wrapper sizes bacc for them: the bound is
    row_sweep.cuh's kOneWindowMax, the bf16 entry keeps the weights by
    that bound alone, and the plan starts a second window exactly there."""
    with open(build.CSRC_DIR + "/row_sweep.cuh") as f:
        bound = re.search(r"constexpr int kOneWindowMax = (\d+);", f.read())
    assert bound and int(bound.group(1)) == sf.ONE_WINDOW_MAX
    with open(build.CSRC_DIR + "/tail_bf16.cu") as f:
        assert "float* w = kq > kOneWindowMax ?" in f.read()
    for kq in range(264, 4104, 8):
        for bf16 in (False, True):
            shape = sf.pass_plan(kq, bf16)
            assert shape.weights == (shape.windows > 1) == \
                (kq > sf.ONE_WINDOW_MAX), (kq, bf16)


def test_dot_pass_takes_32_lanes_where_the_ranges_do_not_fill_the_card():
    """A dot pass (the tail, the CSR user pass) over fewer ranges than the
    card holds 16-lane groups (row_sweep.cuh's kFillGroupsPerSm an SM)
    takes 32 lanes covering the row: the bf16 tail at ML-1M K = 300 (1,442
    ranges on 132 SMs); 16 lanes at EchoNest's 33,558. The item pass (no
    dot) and the 32-lane widths keep the width's plan."""
    with open(build.CSRC_DIR + "/row_sweep.cuh") as f:
        fill = re.search(r"constexpr int kFillGroupsPerSm = (\d+);", f.read())
    assert fill and int(fill.group(1)) == sf.FILL_GROUPS_PER_SM
    sms = 132
    full = sms * sf.FILL_GROUPS_PER_SM
    assert sf.pass_plan(304, True, ranges=1442, sms=sms) == sf.Plan(32, 2)
    assert sf.pass_plan(304, True, ranges=33558, sms=sms) == sf.Plan(16, 3)
    assert sf.pass_plan(304, ranges=2884, sms=sms) == sf.Plan(32, 3)
    assert sf.pass_plan(304, dot=False, ranges=2884, sms=sms) == \
        sf.Plan(16, 5)
    for kq in range(264, 4104, 8):
        for bf16 in (False, True):
            per = 8 if bf16 else 4
            wide = sf.pass_plan(kq, bf16)
            for ranges in (1, full - 1, full):
                got = sf.pass_plan(kq, bf16, ranges=ranges, sms=sms)
                if wide.lanes == 32 or ranges >= full:
                    assert got == wide, (kq, bf16, ranges)
                else:
                    assert got.lanes == 32 and got.windows == 1
                    # covers the row, less than one chunk a lane idle
                    assert 0 <= 32 * got.chunks - kq // per < 32
                    assert per * got.chunks <= sf.WIDE_CAP


@pytest.mark.parametrize("nnz", [1, 31, 33, tf.RANGE - 1, tf.RANGE,
                                 tf.RANGE + 1, 8590764])
def test_scratch_holds_two_slots_per_range(nnz):
    """Per route's range: 256 nonzeros in bf16, the CSR sweep's 128 in
    f32."""
    for bf16, span in ((True, tf.RANGE), (False, sf.RANGE)):
        ranges = -(-nnz // span)
        assert tf.scratch_rows(nnz, bf16) == 2 * ranges
        # every nonzero lies in a range, and no range is empty
        assert (ranges - 1) * span < nnz <= ranges * span
    assert (tf.RANGE, sf.RANGE) == (256, 128)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "width", "shape",
                                 "ids", "contig", "rows", "device",
                                 "bf16_width", "bf16_wide"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p_tab, o_tab = torch.rand(6, 8), torch.rand(5, 8)
    p = torch.tensor([0, 0, 2, 5], dtype=torch.int32)
    o = torch.tensor([1, 4, 0, 3], dtype=torch.int32)
    y = torch.ones(4)
    rows = 6
    if bad == "dtype":
        p_tab, o_tab = p_tab.double(), o_tab.double()
    elif bad == "mixed":
        p_tab = p_tab.bfloat16()
    elif bad == "width":
        p_tab, o_tab = p_tab[:, :6].contiguous(), o_tab[:, :6].contiguous()
    elif bad == "shape":
        y = torch.ones(3)
    elif bad == "ids":
        o = o.long()
    elif bad == "contig":
        p_tab = torch.rand(8, 6).T
    elif bad == "rows":
        rows = 7
    elif bad == "bf16_width":      # 12 bf16 values: not whole 16-byte rows
        p_tab = torch.rand(6, 12).bfloat16()
        o_tab = torch.rand(5, 12).bfloat16()
    elif bad == "bf16_wide":
        # 264 values take 16 lanes of three 16-byte chunks; past four
        # chunks for each of 32 lanes (1024 values) the row is cut into
        # column windows: the plain version (a CPU tensor) takes the row,
        # and a tensor bound for a kernel passes every check of the
        # wrapper (a meta tensor, which stands for one, is refused only
        # for its device)
        assert tf.plan(True, 264)[1][:3] == (16, 3, 1)
        assert tf.plan(True, 1032)[1][:3] == (32, 3, 2)
        p_tab = torch.rand(6, 1032).bfloat16()
        o_tab = torch.rand(5, 1032).bfloat16()
        assert tf.fused_half_sweep(p_tab, o_tab, p, o, y, rows).shape == \
            (rows, 1032)
        p_tab, o_tab, p, o, y = (t.to("meta") for t in (p_tab, o_tab, p, o,
                                                         y))
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tf.fused_half_sweep(p_tab, o_tab, p, o, y, rows)
        return
    else:
        y = torch.ones(4, device="meta")
    with pytest.raises(ValueError):
        tf.fused_half_sweep(p_tab, o_tab, p, o, y, rows)


def test_half_sweep_reference_is_the_per_nonzero_loop():
    rng = np.random.default_rng(8)
    p_tab = torch.from_numpy(rng.random((7, 4)).astype(np.float32))
    o_tab = torch.from_numpy(rng.random((5, 4)).astype(np.float32))
    p = torch.tensor([0, 0, 3, 3, 3, 6], dtype=torch.int32)
    o = torch.tensor([4, 1, 0, 2, 4, 3], dtype=torch.int32)
    y = torch.tensor([1.0, 2.0, 3.0, 1.0, 4.0, 2.0])
    want = torch.zeros(7, 4, dtype=torch.float64)
    for j in range(6):
        pr = p_tab[p[j]].double() * o_tab[o[j]].double()
        want[p[j]] += y[j].double() / pr.sum() * pr
    got = half_sweep_reference(p_tab, o_tab, p, o, y, 7, block=4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [13, 300, 1100])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(bias, bf16, k):
    """Both routes on rows far longer than a range, at a narrow width and
    in the wide passes' shapes (K = 300: one window; K = 1100: two, the
    weights found first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(9)
    n, m, u, i, y = _layout("long_rows", rng)
    tables = [None if x is None else torch.from_numpy(x).cuda()
              for x in _tables(rng, n, m, k, bias)]
    stream = build_tail_stream(u, i, y, "cuda")
    before = tf.fused_half_sweep.launches
    got = tf.tail_sweep(*tables, stream, bf16=bf16)
    again = tf.tail_sweep(*tables, stream, bf16=bf16)
    torch.cuda.synchronize()
    assert tf.fused_half_sweep.launches == before + 4
    want = tail_sweep_reference(*tables, stream, bf16=bf16)
    for g, a, w in zip(got, again, want):
        if w is None:
            continue
        assert torch.equal(g, a)                # deterministic
        torch.testing.assert_close(g, w, **F32)


def _partition_layouts(rng):
    """(name, n, m, u, i, y) that stress the bf16 kernel's partition into
    lane groups of RANGE nonzeros: streams of a few nonzeros and of one
    range give or take one, one nonzero per row (every nonzero starts a run
    whose P row is copied ahead), a row spanning many ranges between short
    rows, and runs of lengths that cut the id batches (8, 16, 32 nonzeros)
    and the ranges anywhere."""
    r = tf.RANGE
    out = []
    for nnz in (1, 31, 33, r - 1, r + 1):
        out.append((f"nnz={nnz}", 300, 200) + _rand_coo(rng, 300, 200, nnz))
    n, m = 3 * r + 5, 500
    out.append(("one per row", n, m, np.arange(n, dtype=np.int32),
                rng.integers(0, m, n).astype(np.int32),
                rng.integers(1, 5, n).astype(np.float32)))
    u = np.concatenate([np.arange(5), np.full(9 * r + 7, 5),
                        np.repeat(np.arange(6, 40), 3)]).astype(np.int32)
    out.append(("row over ten ranges", 40, 700, u,
                rng.integers(0, 700, u.size).astype(np.int32),
                rng.integers(1, 5, u.size).astype(np.float32)))
    lengths = rng.choice([1, 2, 7, 9, 15, 17, 31, 33, 63], 400)
    u = np.repeat(np.arange(0, 2 * lengths.size, 2), lengths).astype(np.int32)
    out.append(("runs across batches", 2 * lengths.size, 900, u,
                rng.integers(0, 900, u.size).astype(np.int32),
                rng.integers(1, 300, u.size).astype(np.float32)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k", [13, 100, 200, 255, 300, 1000])
def test_bf16_kernel_partition_on_card(k, bias):
    """The bf16 route (csrc/tail_bf16.cu) at 8-, 16- and 32-lane groups,
    and past 256 values in the wide passes' shapes (16 lanes of 3 chunks,
    32 of 4): two launches bitwise
    equal and the plain bf16 version's result at the f32 bound. The last
    layout's counts reach 299, past the divide's fast range, so both of
    its paths run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(k + bias)
    for name, n, m, u, i, y in _partition_layouts(rng):
        tables = [None if x is None else torch.from_numpy(x).cuda()
                  for x in _tables(rng, n, m, k, bias)]
        stream = build_tail_stream(u, i, y, "cuda")
        got = tf.tail_sweep(*tables, stream, bf16=True)
        again = tf.tail_sweep(*tables, stream, bf16=True)
        want = tail_sweep_reference(*tables, stream, bf16=True)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            if w is None:
                continue
            assert torch.equal(g, a), name
            torch.testing.assert_close(g, w, **F32, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k", [13, 100, 200, 255, 300, 1000])
def test_f32_route_partition_on_card(k, bias):
    """The f32 route (the CSR sweep's user pass, then its item pass over
    the tail's slab stream) at 4-, 16- and 32-lane groups, and past 256
    values in the wide passes' shapes (16 lanes of 5 chunks, 32 of 8), on
    the partition layouts with every other item absent from the tail (as the
    head's items are), its item half in one slab, in a few and in one per
    user (most items then lead in item order): two launches bitwise
    equal, the plain f32 version's result at the f32 bound, and the absent
    items' rows zero (the hybrid adds the head into them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(50 + k + bias)
    for name, n, m, u, i, y in _partition_layouts(rng):
        tables = [None if x is None else torch.from_numpy(x).cuda()
                  for x in _tables(rng, n, 2 * m, k, bias)]
        stream = build_tail_stream(u, 2 * i, y, "cuda")
        a_t, b_t = tail_tables(*tables, bf16=False)
        kq = a_t.shape[1]
        want = tail_sweep_reference(*tables, stream)
        users = np.unique(u).size
        for slab_bytes in (tf.SLAB_BYTES, 4 * kq * 16, 1):
            before = tf.fused_half_sweep.launches
            got = tf.tail_halves(a_t, b_t, stream, slab_bytes)
            again = tf.tail_halves(a_t, b_t, stream, slab_bytes)
            torch.cuda.synchronize()
            assert tf.fused_half_sweep.launches == before + 4
            st = tf.tail_slabs(stream, n, 2 * m, kq, slab_bytes)
            if slab_bytes == tf.SLAB_BYTES:
                assert (st.slabs, st.cold) == (1, 0), name
            assert st.slabs <= users, name
            msg = f"{name}: {st.cold} entries first, {st.slabs} slabs"
            for g, a in zip(got, again):
                assert torch.equal(g, a), msg       # deterministic
            assert got[1][1::2].abs().max().item() == 0, msg
            sums = (got[0][:, :k], got[1][:, :k]) + \
                ((got[0][:, k], got[1][:, k + 1]) if bias else (None, None))
            for g, w in zip(sums, want):
                if w is not None:
                    torch.testing.assert_close(g, w, **F32, msg=msg)
        # one half alone: the user pass's kernel on either half's stream,
        # its untouched rows zeroed by the kernel
        for args in ((a_t, b_t, stream.u, stream.i, stream.y, n),
                     (b_t, a_t, stream.i_by_item, stream.u_by_item,
                      stream.y_by_item, 2 * m)):
            torch.testing.assert_close(tf.fused_half_sweep(*args),
                                       half_sweep_reference(*args), **F32,
                                       msg=name)
