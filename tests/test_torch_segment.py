"""The segment sweeps and the CSR sweep kernel's plain version against the
JAX package.

The port's `sweep_segment`, `sweep_segment_chunked` and the CSR kernel's
plain version (`ops/segment.py::segment_sweep_reference`, which a CPU
tensor takes) are held to the JAX `sweep_segment` and the naive
per-nonzero loop of tests/test_sweep.py at that file's bound (rtol=2e-4,
atol=1e-5), the chunked form to the one-shot form at 1e-5/1e-6
(tests/test_sweep.py:115-118), and the plain kernel to the TPU design
kernel `sweep_pallas` run by the Pallas interpreter (no bias, which the
design kernel lacks). The item pass's slab stream is checked for its
order, and a plain walk of the kernel's passes over it (slab by slab,
through the pair rows) against the JAX `sweep_segment`. The CUDA kernel
itself runs only on the card (marked `cuda`).
"""

import functools
import importlib.util
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from hgaprec_tpu.data.device import build_device_data as j_build
from hgaprec_tpu.ops import sweep as j_sweep
from hgaprec_tpu_torch.data.device import DeviceData, sorted_coo
from hgaprec_tpu_torch.data.device import build_device_data as t_build
from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops import segment_fused as sf
from hgaprec_tpu_torch.ops import sweep as t_sweep
from hgaprec_tpu_torch.ops import tail_fused as tf
from hgaprec_tpu_torch.ops.segment import segment_sweep_reference
from hgaprec_tpu_torch.ops.tail import build_tail_stream, tail_tables
from test_sweep import _setup, naive_sweep
from test_torch_step import port_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=2e-4, atol=1e-5)


def _plain_kernel(*elogs_and_data):
    """The kernel's sweep on a CPU tensor: its plain version."""
    *elogs, data = elogs_and_data
    return sf.segment_sweep(*[None if e is None else torch.exp(e)
                              for e in elogs], data)


SWEEPS = {
    "segment": t_sweep.sweep_segment,
    "chunked": functools.partial(t_sweep.sweep_segment_chunked, chunk=48),
    "kernel_plain": _plain_kernel,
}


def _both(rng, bias, **kw):
    """JAX store/data, the port's data on the CPU, and the inputs as f32
    numpy (None for absent biases)."""
    store, jdata, *elogs = _setup(rng, bias, **kw)
    elogs = [None if e is None else np.asarray(e, np.float32) for e in elogs]
    return store, jdata, t_build(port_store(store), "cpu", pad_multiple=64), \
        elogs


def _t(elogs):
    return [None if e is None else torch.from_numpy(e) for e in elogs]


def _j(elogs):
    return [None if e is None else jnp.asarray(e) for e in elogs]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("fn", sorted(SWEEPS))
def test_segment_sweeps_match_jax_and_naive(rng, fn, bias):
    store, jdata, tdata, elogs = _both(rng, bias)
    ref = naive_sweep(*[None if e is None else e.astype(np.float64)
                        for e in elogs], store.coo_u, store.coo_i,
                      store.coo_y)
    want = j_sweep.sweep_segment(*_j(elogs), jdata)
    got = SWEEPS[fn](*_t(elogs), tdata)
    for g, w, r in zip(got, want, ref):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
        np.testing.assert_allclose(g.numpy(), r, **F32)


@pytest.mark.parametrize("k,bias", [(300, False), (255, True),
                                    (1100, False)])
@pytest.mark.parametrize("fn", sorted(SWEEPS))
def test_segment_sweeps_match_jax_wide(rng, fn, bias, k):
    """Past 256 packed values (K = 300; K = 255 with bias, 257 values; K =
    1100, two column windows on the card): the port's segment sweeps and
    the CSR kernel's plain version (the function the wide passes are held
    to on the card) against the JAX segment sweep and the naive loop, at
    the f32 bound."""
    store, jdata, tdata, elogs = _both(rng, bias, k=k)
    ref = naive_sweep(*[None if e is None else e.astype(np.float64)
                        for e in elogs], store.coo_u, store.coo_i,
                      store.coo_y)
    want = j_sweep.sweep_segment(*_j(elogs), jdata)
    got = SWEEPS[fn](*_t(elogs), tdata)
    assert got[0].shape == (store.n, k)
    for g, w, r in zip(got, want, ref):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
        np.testing.assert_allclose(g.numpy(), r, **F32)


@pytest.mark.parametrize("kq", [8, 32, 64, 104, 128, 256, 260, 304, 336,
                                640, 1004, 1024, 1028, 1104, 2048, 4100])
@pytest.mark.parametrize("item", [False, True])
def test_pass_plan_covers_the_row(kq, item):
    """The CSR passes' shapes (`csrc/segment_sweep.cu::pass_by_width` and
    `csrc/row_sweep.cuh::wide_plan`): up to 256 floats two chunks a lane of
    the fewest lanes; past them groups of 16 or 32 lanes, at most eight
    chunks a lane, in as many column windows as that takes, covering the
    row with less than one idle chunk a lane; the user pass (it finds the
    weights from a dot) finds them first where a row takes two windows or
    more, the item pass (it reads them) never."""
    plan = sf.pass_plan(kq, dot=not item)
    chunks = kq // 4
    lanes = plan.lanes * plan.windows
    assert 4 * plan.chunks * lanes >= kq
    if kq <= 256:
        assert (plan.chunks, plan.windows) == (2, 1)
        assert plan.lanes == 4 or 8 * plan.lanes // 2 < kq
    else:
        assert plan.lanes in (16, 32) and plan.chunks <= sf.WIDE_CAP // 4
        assert lanes * plan.chunks - chunks < lanes
        # the fewest windows: one fewer would need more than 8 chunks a lane
        assert plan.windows == 1 or 32 * 8 * (plan.windows - 1) < chunks
    assert plan.weights == (not item and plan.windows > 1)
    # bf16 rows (the tail's route) are planned the same way in 8-value
    # chunks, at most four a lane
    if kq % 8 == 0:
        bf = sf.pass_plan(kq, bf16=True)
        assert 8 * bf.chunks * bf.lanes * bf.windows >= kq
        assert kq <= 256 or bf.chunks <= sf.WIDE_CAP // 8


@pytest.mark.parametrize("kq", [104, 320, 1024])
def test_slab_budget_follows_the_row_width(kq):
    """The item pass's user slabs are sized from kq: a user costs its A row
    (4 kq bytes) and its weights, and a slab takes the users whose running
    cost starts inside its budget, so wider rows give proportionally more
    slabs under the same budget."""
    counts = torch.full((20000,), 3, dtype=torch.int64)
    u_ids = torch.repeat_interleave(torch.arange(20000), counts).int()
    budget = 1 << 20
    slab = sf.user_slabs(u_ids, 20000, kq, budget)
    cost = 4 * kq + 4 * 3
    assert torch.equal(slab, torch.arange(20000) * cost // budget)
    assert int(slab.max()) + 1 == -(-20000 * cost // budget)


@pytest.mark.parametrize("bias", [False, True])
def test_chunked_equals_one_shot(rng, bias):
    _, _, tdata, elogs = _both(rng, bias, n=23, m=19, nnz=130)
    one = t_sweep.sweep_segment(*_t(elogs), tdata)
    chunked = t_sweep.sweep_segment_chunked(*_t(elogs), tdata, chunk=48)
    for c, o in zip(chunked, one):
        if o is not None:
            np.testing.assert_allclose(c.numpy(), o.numpy(), rtol=1e-5,
                                       atol=1e-6)


def _design_module():
    path = os.path.join(REPO, "docs", "design", "pallas_csr_sweep.py")
    spec = importlib.util.spec_from_file_location("pallas_csr_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_kernel_matches_sweep_pallas(monkeypatch, seed):
    """The TPU design kernel in the Pallas interpreter, 8-row tiles and
    64-nonzero chunks (several tiles and chunks per pass)."""
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    design = _design_module()
    store, _, tdata, elogs = _both(np.random.default_rng(seed), False, n=40,
                                   m=30, nnz=200)
    want = design.sweep_pallas(*_j(elogs[:2]),
                               design.build_pallas_csr(store, rows=8,
                                                       chunk=64),
                               rows=8, chunk=64)
    got = _plain_kernel(*_t(elogs), tdata)
    for g, w in zip(got[:2], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("fn", sorted(SWEEPS))
def test_padding_contributes_nothing(rng, fn):
    store, _, _, elogs = _both(rng, True)
    ts = port_store(store)
    small = SWEEPS[fn](*_t(elogs), t_build(ts, "cpu", pad_multiple=64))
    big = SWEEPS[fn](*_t(elogs), t_build(ts, "cpu", pad_multiple=256))
    for s, b in zip(small, big):
        np.testing.assert_allclose(s.numpy(), b.numpy(), rtol=1e-6)


@pytest.mark.parametrize("above", [False, True])
@pytest.mark.parametrize("mode", ["segment", "segment-chunked"])
def test_cpu_dispatch_equals_jax_rule(rng, monkeypatch, mode, above):
    """Both packages pick the same segment function for the mode and the
    padded nonzero count against SEGMENT_CHUNK_THRESHOLD."""
    _, jdata, tdata, elogs = _both(rng, False)
    p = tdata.nnz_padded
    assert jdata.u_ids.shape[0] == p
    picked = {}
    for mod, inputs, data in ((j_sweep, _j(elogs), jdata),
                              (t_sweep, _t(elogs), tdata)):
        monkeypatch.setattr(mod, "SEGMENT_CHUNK_THRESHOLD",
                            p - 1 if above else p)
        for name in ("sweep_segment", "sweep_segment_chunked"):
            monkeypatch.setattr(mod, name, functools.partial(
                lambda name, mod, *a, **kw: picked.setdefault(mod, name),
                name, mod))
        mod.sweep(*inputs, data, mode)
    want = ("sweep_segment_chunked" if mode == "segment-chunked" or above
            else "sweep_segment")
    assert picked == {j_sweep: want, t_sweep: want}


def test_cpu_tensor_never_builds(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")
    monkeypatch.setattr(build, "load_library", no_build)
    _, _, tdata, elogs = _both(rng, True)
    before = sf.fused_segment_sweep.launches
    for mode in ("segment", "segment-chunked"):
        t_sweep.sweep(*_t(elogs), tdata, mode)
    tables = tail_tables(*[torch.exp(e) for e in _t(elogs)], bf16=False)
    got = sf.fused_segment_sweep(*tables, tdata)
    want = segment_sweep_reference(*tables, tdata)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sf.fused_segment_sweep.launches == before


def test_reference_is_the_per_nonzero_loop():
    """Both passes of the plain kernel against a literal f64 loop, on a
    layout with padding, an untouched user and an untouched item."""
    rng = np.random.default_rng(8)
    u = np.array([0, 0, 2, 2, 2, 5], np.int32)
    i = np.array([4, 1, 0, 2, 4, 3], np.int32)
    y = np.array([1.0, 2.0, 3.0, 1.0, 4.0, 2.0], np.float32)
    n, m = 7, 6
    data = DeviceData(**sorted_coo(u, i, y, n, m, "cpu", 8), dense_y=None)
    a_tab = torch.from_numpy(rng.random((n, 4)).astype(np.float32))
    b_tab = torch.from_numpy(rng.random((m, 4)).astype(np.float32))
    want_a = torch.zeros(n, 4, dtype=torch.float64)
    want_b = torch.zeros(m, 4, dtype=torch.float64)
    for j in range(u.size):
        pr = a_tab[u[j]].double() * b_tab[i[j]].double()
        want_a[u[j]] += float(y[j]) / pr.sum() * pr
        want_b[i[j]] += float(y[j]) / pr.sum() * pr
    got_a, got_b = segment_sweep_reference(a_tab, b_tab, data, block=4)
    np.testing.assert_allclose(got_a.numpy(), want_a.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), want_b.numpy(), rtol=1e-6)
    assert not got_a[[1, 3, 4, 6]].any() and not got_b[5].any()


# slab budgets: one slab, a few, and one user per slab (every user's cost
# of kq * 4 + 4 * count bytes exceeds 1)
SLAB_SIZES = [1 << 40, 600, 1]


def _assert_slab_order(st, u_ids, i_ids, item_order, n, m, kq, slab_bytes):
    """The item pass's stream `st` of the dual-sorted COO (u_ids, i_ids,
    item_order) is a permutation of item_order in (slab, item, user)
    order; its pairs number the (slab, item) runs in that order, and each
    item lists its pairs in slab order."""
    order, pair, u = st.order.numpy(), st.pair.numpy(), st.u.numpy()
    assert np.array_equal(np.sort(order), np.sort(item_order.numpy()))
    i = st.pair_item.numpy()[pair]
    np.testing.assert_array_equal(i, i_ids.numpy()[order])
    np.testing.assert_array_equal(u, u_ids.numpy()[order])
    user_slab = sf.user_slabs(u_ids, n, kq, slab_bytes).numpy()
    assert (np.diff(user_slab) >= 0).all()
    slab = user_slab[u]
    keys = np.stack([slab, i, u, order], 1)
    for a, b in zip(keys[:-1], keys[1:]):
        assert tuple(a) < tuple(b)
    new = np.r_[True, (slab[1:] != slab[:-1]) | (i[1:] != i[:-1])]
    np.testing.assert_array_equal(pair, np.cumsum(new) - 1)
    assert st.pairs == new.sum() and st.slabs == np.unique(slab).size
    start, pairs = st.item_start.numpy(), st.item_pairs.numpy()
    for item in range(m):
        mine = pairs[start[item]:start[item + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(
            st.pair_item.numpy() == item))
    present = np.unique(u_ids.numpy())
    if slab_bytes == SLAB_SIZES[0]:
        assert st.slabs == 1
    elif slab_bytes == 1:
        assert st.slabs == present.size
    else:
        assert 1 < st.slabs < present.size


@pytest.mark.parametrize("slab_bytes", SLAB_SIZES + [150])
def test_slab_stream_orders_by_slab_item_user(rng, slab_bytes):
    """`DeviceData`'s COO: the CSR sweep's own item-pass stream."""
    store, _, tdata, _ = _both(rng, False, n=40, m=30, nnz=200)
    n, m, kq = store.n, store.m, 8
    st = sf.data_slabs(tdata, n, m, kq, slab_bytes)
    assert sf.data_slabs(tdata, n, m, kq, slab_bytes) is st  # built once
    assert tdata.slab_cache == {(n, m, kq, slab_bytes, 0): st}
    _assert_slab_order(st, tdata.u_ids, tdata.i_ids, tdata.item_order, n, m,
                       kq, slab_bytes)


@pytest.mark.parametrize("slab_bytes", SLAB_SIZES + [150])
def test_tail_slab_stream_orders_by_slab_item_user(rng, slab_bytes):
    """A `TailStream`: the f32 tail route's item-pass stream, built from
    the tail's own fields through `TailStream.order` and kept in its own
    cache; with every item in slab order (fill 0)."""
    store, _, _, _ = _both(rng, False, n=40, m=30, nnz=200)
    n, m, kq = store.n, store.m, 8
    s = build_tail_stream(store.coo_u, store.coo_i, store.coo_y, "cpu")
    st = tf.tail_slabs(s, n, m, kq, slab_bytes, 0)
    assert tf.tail_slabs(s, n, m, kq, slab_bytes, 0) is st   # built once
    assert s.slab_cache == {(n, m, kq, slab_bytes, 0): st} and st.cold == 0
    _assert_slab_order(st, s.u, s.i, s.order, n, m, kq, slab_bytes)


@pytest.mark.parametrize("fill", [1, tf.SLAB_FILL, 1000])
@pytest.mark.parametrize("slab_bytes", SLAB_SIZES + [150])
def test_slab_stream_puts_sparse_items_first(rng, slab_bytes, fill):
    """With a fill, the items whose entries do not outnumber fill times
    their extra pair rows lead the stream in (item, user) order, one pair
    each; the rest follow in (slab, item, user) order. Every entry of
    item_order appears once, and each item's pairs are listed in stream
    order."""
    store, _, _, _ = _both(rng, False, n=40, m=30, nnz=200)
    n, m, kq = store.n, store.m, 8
    s = build_tail_stream(store.coo_u, store.coo_i, store.coo_y, "cpu")
    st = tf.tail_slabs(s, n, m, kq, slab_bytes, fill)
    assert tf.tail_slabs(s, n, m, kq, slab_bytes, fill) is st
    plain = tf.tail_slabs(s, n, m, kq, slab_bytes, 0)
    user_slab = sf.user_slabs(s.u, n, kq, slab_bytes).numpy()
    u_all, i_all = s.u.numpy(), s.i.numpy()
    deg = np.bincount(i_all, minlength=m)
    spans = np.array([np.unique(user_slab[u_all[i_all == it]]).size
                      for it in range(m)])
    hot = deg > fill * (spans - 1)
    order, pair, u = st.order.numpy(), st.pair.numpy(), st.u.numpy()
    i = st.pair_item.numpy()[pair]
    np.testing.assert_array_equal(np.sort(order), np.arange(u_all.size))
    np.testing.assert_array_equal(i, i_all[order])
    np.testing.assert_array_equal(u, u_all[order])
    cold = ~hot[i]
    assert st.cold == cold.sum() and not cold[st.cold:].any()
    assert cold[:st.cold].all()
    key = np.where(cold, 0, user_slab[u] + 1)
    rows = np.stack([key, i, u, order], 1)
    for a, b in zip(rows[:-1], rows[1:]):
        assert tuple(a) < tuple(b)
    new = np.r_[True, (key[1:] != key[:-1]) | (i[1:] != i[:-1])]
    np.testing.assert_array_equal(pair, np.cumsum(new) - 1)
    assert st.slabs == np.unique(key[st.cold:]).size
    start, pairs = st.item_start.numpy(), st.item_pairs.numpy()
    for item in range(m):
        np.testing.assert_array_equal(pairs[start[item]:start[item + 1]],
                                      np.flatnonzero(st.pair_item.numpy()
                                                     == item))
        # a sparse item has one pair, a dense one its plain slab spans
        want = 1 if not hot[item] else spans[item]
        assert start[item + 1] - start[item] == (want if deg[item] else 0)
    assert st.pairs <= plain.pairs
    if slab_bytes == SLAB_SIZES[0]:
        assert st.cold == 0 and st.pairs == plain.pairs


def _slab_walk(a_tab, b_tab, data, slab_bytes):
    """The kernel's two passes as a plain f32 loop: the user pass in user
    order, then the item pass in the slab stream's order, each (slab,
    item) run summing w A[u] into its pair row, each item adding its pair
    rows in slab order and multiplying by B[i]."""
    a, b = a_tab.numpy(), b_tab.numpy()
    u, i, y = (x.numpy() for x in (data.u_ids, data.i_ids, data.y))
    w = np.empty(u.size, np.float32)
    acc_a = np.zeros_like(a)
    for j in range(u.size):
        dot = np.float32((a[u[j]] * b[i[j]]).sum(dtype=np.float32))
        w[j] = y[j] / max(dot, np.float32(1e-30))
        acc_a[u[j]] += w[j] * b[i[j]] * a[u[j]]
    st = sf.data_slabs(data, a.shape[0], b.shape[0], a.shape[1],
                       slab_bytes)
    pacc = np.zeros((st.pairs, a.shape[1]), np.float32)
    for pr, su, so in zip(st.pair.numpy(), st.u.numpy(), st.order.numpy()):
        pacc[pr] += w[so] * a[su]
    acc_b = np.zeros_like(b)
    start, pairs = st.item_start.numpy(), st.item_pairs.numpy()
    for item in range(b.shape[0]):
        for pr in pairs[start[item]:start[item + 1]]:
            acc_b[item] += pacc[pr]
        acc_b[item] *= b[item]
    return acc_a, acc_b


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("slab_bytes", SLAB_SIZES)
def test_slab_walk_matches_jax(rng, slab_bytes, bias):
    """The item pass walked slab by slab reproduces the JAX
    `sweep_segment` (and the user pass with it)."""
    _, jdata, tdata, elogs = _both(rng, bias, n=40, m=30, nnz=200)
    k = elogs[0].shape[1]
    a_t, b_t = tail_tables(*[None if e is None else torch.exp(e)
                             for e in _t(elogs)], bf16=False)
    acc_a, acc_b = _slab_walk(a_t, b_t, tdata, slab_bytes)
    want = j_sweep.sweep_segment(*_j(elogs), jdata)
    got = [acc_a[:, :k], acc_b[:, :k]] + \
        ([acc_a[:, k], acc_b[:, k + 1]] if bias else [None, None])
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g, np.asarray(w), **F32)


def test_entries_are_typed_once(monkeypatch):
    """Each C entry gets its argument types when first used, not per
    call."""
    loads = []

    class Lib:
        hpf_segment_user_pass_f32 = type("Fn", (), {})()
        hpf_segment_item_pass_f32 = type("Fn", (), {})()

    monkeypatch.setattr(build, "load_library",
                        lambda: loads.append(1) or Lib)
    sf._entry.cache_clear()
    try:
        for name in sf._ARGTYPES:
            assert sf._entry(name) is sf._entry(name)
            assert sf._entry(name).argtypes == sf._ARGTYPES[name]
        assert len(loads) == len(sf._ARGTYPES)
    finally:
        sf._entry.cache_clear()


@pytest.mark.parametrize("bad", ["dtype", "width", "mixed", "ids", "length",
                                 "contig", "device", "slab", "too_wide"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    u = np.array([0, 1, 1], np.int32)
    i = np.array([2, 0, 1], np.int32)
    fields = sorted_coo(u, i, np.ones(3, np.float32), 3, 4, "cpu", 4)
    a_tab, b_tab = torch.rand(3, 8), torch.rand(4, 8)
    kw = {}
    if bad == "slab":
        kw["slab_bytes"] = 0
    elif bad == "dtype":
        a_tab, b_tab = a_tab.double(), b_tab.double()
    elif bad == "width":
        a_tab, b_tab = a_tab[:, :6].contiguous(), b_tab[:, :6].contiguous()
    elif bad == "too_wide":     # past eight 16-byte chunks a lane of 32
        # the plain version (a CPU tensor) takes the row, and a tensor
        # bound for a kernel passes every check of the wrapper: a meta
        # tensor, which stands for one, is refused only for its device
        # (the kernel takes the row in two column windows)
        a_tab, b_tab = torch.rand(3, 1028), torch.rand(4, 1028)
        out_a, _ = sf.fused_segment_sweep(a_tab, b_tab, DeviceData(
            **fields, dense_y=None))
        assert out_a.shape == (3, 1028)
        assert sf.pass_plan(1028).windows == 2
        a_tab, b_tab = a_tab.to("meta"), b_tab.to("meta")
        fields = {k: v.to("meta") for k, v in fields.items()}
        with pytest.raises(ValueError, match="no kernel for device meta"):
            sf.fused_segment_sweep(a_tab, b_tab, DeviceData(**fields,
                                                            dense_y=None))
        return
    elif bad == "mixed":
        b_tab = torch.rand(4, 4)
    elif bad == "ids":
        fields["i_ids"] = fields["i_ids"].long()
    elif bad == "length":
        fields["y"] = fields["y"][:3]
    elif bad == "contig":
        a_tab = torch.rand(8, 3).T
    else:
        fields["y"] = torch.ones(4, device="meta")
    with pytest.raises(ValueError):
        sf.fused_segment_sweep(a_tab, b_tab, DeviceData(**fields,
                                                        dense_y=None), **kw)


@pytest.mark.parametrize("bias", [False, True])
def test_nonzero_logsumexp_sum_matches_jax(rng, bias):
    _, jdata, tdata, elogs = _both(rng, bias)
    wts = rng.random(tdata.nnz_padded).astype(np.float32)
    want = j_sweep.nonzero_logsumexp_sum(*_j(elogs), jdata, jnp.asarray(wts))
    got = t_sweep.nonzero_logsumexp_sum(*_t(elogs), tdata,
                                        torch.from_numpy(wts), chunk=50)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """A changed shared header must build a new library, not load a stale
    one."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    assert [os.path.basename(h) for h in build.headers()] == [
        "dense_roles.cuh", "row_sweep.cuh", "wgmma_common.cuh"]
    for header in ("dense_roles.cuh", "row_sweep.cuh", "wgmma_common.cuh"):
        before = build.library_path()
        with open(csrc / header, "a") as f:
            f.write("// changed\n")
        assert build.library_path() != before, header


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k,slab_bytes", [(13, sf.SLAB_BYTES), (13, 4096),
                                          (100, 20000), (200, 30000),
                                          (255, sf.SLAB_BYTES),
                                          (300, 40000), (640, 80000),
                                          (1000, 120000), (1100, 150000)])
def test_kernel_matches_plain_on_card(bias, k, slab_bytes):
    """One slab, and several (the item pass adds each slab's rows onto
    the last), at widths of one group size each (kq 16, 100 or 104, 200
    or 204), and past 256 floats in the wide passes' shapes (kq 256 or
    260: 32 lanes of 2 / 16 of 5 chunks; 300 or 304: 16 of 5; 640 or 644:
    32 of 5 and 6; 1000 or 1004: 32 of 8; 1100 or 1104: two windows of 32
    lanes of 5 chunks, the user pass's weights found first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(9)
    n, m = 900, 400
    u = np.repeat(np.arange(0, n, 7, dtype=np.int32), 40)
    i = rng.integers(0, m, u.size).astype(np.int32)
    o = np.lexsort((i, u))
    data = DeviceData(**sorted_coo(u[o], i[o], rng.integers(
        1, 5, u.size).astype(np.float32), n, m, "cuda", 1000), dense_y=None)
    lin = [torch.exp(0.3 * torch.randn(s, device="cuda")) for s in
           [(n, k), (m, k)] + ([(n,), (m,)] if bias else [])]
    lin += [None, None] * (not bias)
    tables = tail_tables(*lin, bf16=False)
    slabs = sf.data_slabs(data, n, m, tables[0].shape[1], slab_bytes).slabs
    assert (slabs == 1) == (slab_bytes == sf.SLAB_BYTES)
    before = sf.fused_segment_sweep.launches
    got = sf.fused_segment_sweep(*tables, data, slab_bytes)
    again = sf.fused_segment_sweep(*tables, data, slab_bytes)
    torch.cuda.synchronize()
    assert sf.fused_segment_sweep.launches == before + 2
    want = segment_sweep_reference(*tables, data)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                # deterministic
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-6)
