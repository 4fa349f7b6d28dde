"""The hybrid slice as a whole: the port's head/tail layout, sweep, mode
rule and Trainer against the JAX package's.

The JAX reference runs its tail with `tail_impl="mxu"` in f32: its TPU
tail runs bf16 tables even under "highest" (ROADMAP queue 3), while the
port's tail follows the precision flag, so the strict-f32 reference is
the one to hold the port to. Bounds: the sweep at the f32 bound of
tests/test_dense_pallas.py (rtol=2e-4, atol=1e-5), the Trainers at the
bounds of tests/test_torch_engine.py (validation ll rtol=1e-4; state
rtol=1e-4, atol=1e-7).
"""

import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_synthetic
from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.config import RunConfig as JRun
from hgaprec_tpu.data.device import build_device_data as j_build
from hgaprec_tpu.data.ratings import RatingsStore as JStore
from hgaprec_tpu.models.engine import Trainer as JTrainer
from hgaprec_tpu.models.step import _resolve_mode as j_resolve
from hgaprec_tpu.ops.sweep import sweep_hybrid as j_sweep_hybrid
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.config import RunConfig as TRun
from hgaprec_tpu_torch import trace
from hgaprec_tpu_torch.data import device as device_mod
from hgaprec_tpu_torch.data.device import build_device_data as t_build
from hgaprec_tpu_torch.data.device import card_head_width, head_width
from hgaprec_tpu_torch.models.engine import Trainer as TTrainer
from hgaprec_tpu_torch.models.step import _resolve_mode as t_resolve
from hgaprec_tpu_torch.ops import tail_fused as tf
from hgaprec_tpu_torch.ops.dense_fused import dense_kernel
from hgaprec_tpu_torch.models import engine
from hgaprec_tpu_torch.ops.sweep import (sweep, sweep_hybrid,
                                         sweep_segment_chunked)
from test_torch_step import port_store

F32 = dict(rtol=2e-4, atol=1e-5)


def _power_law_store(n, m, nnz, seed):
    """A JAX store with skewed item degrees, every item present."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, nnz)
    i = np.minimum(rng.zipf(1.3, nnz) - 1, m - 1)
    u = np.concatenate([u, rng.integers(0, n, m)])
    i = np.concatenate([i, np.arange(m)])
    key = np.unique(u * m + i)
    u, i = key // m, key % m
    y = rng.integers(1, 6, u.size)
    js = JStore(n, m)
    js.add_training(u + 1, i + 1, y)
    js.finalize()
    return js


def _assert_hybrid_equal(jd, td, nnz_tail):
    np.testing.assert_array_equal(td.head_items.numpy(),
                                  np.asarray(jd.head_items))
    assert td.head_dense_y.dtype == torch.uint8
    assert td.head_dense_y.stride(0) % 16 == 0
    np.testing.assert_array_equal(td.head_dense_y.numpy(),
                                  np.asarray(jd.head_dense_y))
    tc = jd.tail_compact
    users, items = np.asarray(tc.users), np.asarray(tc.items)
    s = td.tail
    assert s.nnz == nnz_tail
    for got, ids, comp in ((s.u, users, tc.cu), (s.i, items, tc.ci),
                           (s.i_by_item, items, tc.ci_i),
                           (s.u_by_item, users, tc.cu_i)):
        np.testing.assert_array_equal(got.numpy(),
                                      ids[np.asarray(comp)][:nnz_tail])
    np.testing.assert_array_equal(s.y.numpy(), np.asarray(tc.y)[:nnz_tail])
    np.testing.assert_array_equal(s.y_by_item.numpy(),
                                  np.asarray(tc.y_i)[:nnz_tail])
    # the raw tail COO the JAX package also keeps
    np.testing.assert_array_equal(s.u.numpy(),
                                  np.asarray(jd.u_ids_tail)[:nnz_tail])
    np.testing.assert_array_equal(s.i.numpy(),
                                  np.asarray(jd.i_ids_tail)[:nnz_tail])


@pytest.mark.parametrize("head,limit,want_t", [
    (8, 4 << 30, 8),             # a narrow head below 512 columns
    (1024, 4 << 30, 1024),
    (1024, 512 * 700, 512),      # budget 700 columns: clipped to 512
    (1024, 512 * 100, 0),        # budget < 512 columns: no head
])
def test_hybrid_layout_equals_jax(head, limit, want_t):
    js = _power_law_store(100, 1500, 6000, seed=head + limit % 97)
    ts = port_store(js)
    jd = j_build(js, pad_multiple=64, hybrid_head_items=head,
                 head_limit_bytes=limit, dense_limit_bytes=64)
    td = t_build(ts, "cpu", pad_multiple=64, hybrid_head_items=head,
                 head_limit_bytes=limit, dense_limit_bytes=64)
    assert head_width(ts.n, ts.m, head, limit) == want_t
    assert td.dense_y is None and jd.dense_y is None
    for f in ("u_ids", "i_ids", "y", "item_order", "i_ids_sorted",
              "u_ids_by_item"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), f)
    if want_t == 0:
        assert jd.head_dense_y is None and td.head_dense_y is None
        assert td.head_items is None and td.tail is None
        return
    assert td.head_dense_y.shape == (512, want_t)
    in_head = np.isin(ts.coo_i, td.head_items.numpy())
    # the head holds the top-T items by degree
    deg = np.bincount(ts.coo_i, minlength=ts.m)
    assert deg[td.head_items.numpy()].min() >= \
        np.delete(deg, td.head_items.numpy()).max()
    _assert_hybrid_equal(jd, td, int((~in_head).sum()))


def test_hybrid_keeps_dense_y_when_the_catalog_densifies(rng):
    js, _, _ = make_synthetic(rng, n=40, m=30)
    jd = j_build(js, pad_multiple=64, hybrid_head_items=8)
    td = t_build(port_store(js), "cpu", pad_multiple=64, hybrid_head_items=8)
    np.testing.assert_array_equal(td.dense_y.numpy(), np.asarray(jd.dense_y))
    _assert_hybrid_equal(jd, td, td.tail.nnz)
    assert td.head_dense_y.shape == (512, 8)


def _elogs(rng, n, m, k, bias):
    shapes = [(n, k), (m, k)] + ([(n,), (m,)] if bias else [])
    return [(rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("head", [8, 512])
def test_sweep_hybrid_matches_jax_mxu_tail(bias, head):
    js = _power_law_store(90, 1100, 5000, seed=7 + bias)
    jd = j_build(js, pad_multiple=64, hybrid_head_items=head,
                 dense_limit_bytes=64)
    td = t_build(port_store(js), "cpu", pad_multiple=64,
                 hybrid_head_items=head, dense_limit_bytes=64)
    assert td.tail.nnz > 0
    rng = np.random.default_rng(11)
    elogs = _elogs(rng, js.n, js.m, 6, bias)
    je = [jnp.asarray(e) for e in elogs] + [None, None] * (not bias)
    te = [torch.from_numpy(e) for e in elogs] + [None, None] * (not bias)
    want = j_sweep_hybrid(*je, jd, tail_impl="mxu", interpret=True)
    got = sweep_hybrid(*te, td, precision="highest")
    assert sweep(*te, td, "hybrid").acc_a.shape == got.acc_a.shape
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    # "default": bf16 head and tail tables, close to f32
    bf = sweep_hybrid(*te, td, precision="default")
    for g, w in zip(bf, got):
        if w is not None:
            denom = torch.clamp_min(w.abs(), 1e-3)
            assert ((g - w).abs() / denom).max().item() < 2e-2


SWEEPS = ("auto", "dense", "dense-pallas", "hybrid", "segment",
          "segment-chunked")


@pytest.mark.parametrize("m", [300, 70000])
@pytest.mark.parametrize("sweep_mode", SWEEPS)
def test_resolve_mode_equals_jax(sweep_mode, m):
    for dense_y, head in itertools.product((None, "y"), (None, "h")):
        data = types.SimpleNamespace(dense_y=dense_y, head_dense_y=head)
        jm = j_resolve(JCfg(n=50, m=m, k=3, sweep=sweep_mode), data)
        tm = t_resolve(TCfg(n=50, m=m, k=3, sweep=sweep_mode), data)
        assert tm == jm, (sweep_mode, m, dense_y, head)


def _hybrid_trainers(tmp_path, bias):
    """tests/test_engine_hybrid.py's configuration in both packages."""
    rng = np.random.default_rng(42)
    js, val, test = make_synthetic(rng, n=60, m=45, density=0.25)
    kw = dict(variant="hpf", bias=bias, sweep="hybrid", hybrid_head_items=8,
              dense_limit_bytes=64)
    run = dict(datdir=str(tmp_path), rfreq=3, max_iterations=9, seed=1,
               enforce_max_iterations=True)
    jtr = JTrainer(js, val, test, JCfg(n=js.n, m=js.m, k=4, tail_impl="mxu",
                                       **kw),
                   JRun(outdir=str(tmp_path / "jax"), **run))
    ttr = TTrainer(port_store(js), val, test,
                   TCfg(n=js.n, m=js.m, k=4, **kw),
                   TRun(outdir=str(tmp_path / "torch"), **run),
                   device="cpu")
    return jtr, ttr


def _ll(path):
    with open(path) as f:
        return [(int(r.split("\t")[0]), float(r.split("\t")[2]))
                for r in f if r.strip()]


@pytest.mark.parametrize("bias", [False, True])
def test_hybrid_trainer_matches_jax(tmp_path, bias):
    jtr, ttr = _hybrid_trainers(tmp_path, bias)
    assert ttr.data.dense_y is None and ttr.data.head_dense_y is not None
    assert ttr.data.head_dense_y.shape[1] == 8 and ttr.data.tail.nnz > 0
    assert t_resolve(ttr.mcfg, ttr.data) == "hybrid"
    jstate = jtr.run()
    jtr.close()
    tstate = ttr.run()
    ttr.close()
    jl, tl = _ll(tmp_path / "jax" / "validation.txt"), \
        _ll(tmp_path / "torch" / "validation.txt")
    assert len(tl) >= 3 and [r[0] for r in tl] == [r[0] for r in jl]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                               rtol=1e-4)
    for f in ("theta", "beta"):
        np.testing.assert_allclose(getattr(tstate, f).e.numpy(),
                                   np.asarray(getattr(jstate, f).e),
                                   rtol=1e-4, atol=1e-7, err_msg=f)
    for name in ("precision.txt", "htheta.tsv", "hbeta.tsv", "model.npz"):
        assert (tmp_path / "torch" / name).exists(), name


def test_auto_builds_the_hybrid_for_a_wide_catalog(tmp_path, monkeypatch):
    """auto + a catalog that does not densify -> head block, no dense_y,
    hybrid mode, and a step that goes through the tail (the EchoNest
    path at test scale)."""
    js, val, test = make_synthetic(np.random.default_rng(5), n=60, m=45,
                                   density=0.25)
    ttr = TTrainer(port_store(js), val, test,
                   TCfg(n=js.n, m=js.m, k=3, variant="hpf",
                        hybrid_head_items=8, dense_limit_bytes=64),
                   TRun(outdir=str(tmp_path / "o"), rfreq=2,
                        max_iterations=2), device="cpu")
    assert ttr.data.dense_y is None and ttr.data.head_dense_y is not None
    assert t_resolve(ttr.mcfg, ttr.data) == "hybrid"
    calls = []
    real = tf.fused_half_sweep

    def spy(*args):
        calls.append(args[-1])
        return real(*args)
    monkeypatch.setattr(tf, "fused_half_sweep", spy)
    ttr.run()
    ttr.close()
    assert calls[:2] == [js.n, js.m]      # one user-sorted, one item-sorted
    assert len(calls) == 2 * 3            # iterations 0, 1, 2


# --- the card's head width (data/device.py::card_head_width) -------------

G = device_mod.HEAD_GROUP
# the head block's rows in the synthetic cases: many, so that a group's
# break-even is hundreds of nonzeros an item
NPAD = 1 << 24


def _pays(precision, npad, kaug=0):
    """The nonzeros at which a group of G columns over npad rows costs the
    sparse passes as much as the dense kernel."""
    route = dense_kernel(kaug, precision == "default")
    return device_mod.BREAK_EVEN_DENSITY[route] * npad * G


def _degrees(group_sums, rest, seed=0):
    """Item degrees whose groups of G (in descending order) sum to about
    `group_sums`, then `rest` items of degree 1, in a shuffled id order."""
    deg = np.concatenate([np.full(G, int(round(s / G))) for s in
                          group_sums] + [np.ones(rest, np.int64)])
    return np.random.default_rng(seed).permutation(deg)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("paying", [1, 2, 3])
def test_card_head_width_keeps_groups_while_they_pay(precision, paying):
    npad = NPAD
    g = _pays(precision, npad)
    # `paying` groups above the break-even, falling, then groups just
    # below it: the walk stops at the first that does not pay
    sums = [g * (4.0 - j) for j in range(paying - 1)] + [1.05 * g] + \
        [0.95 * g, 0.9 * g]
    deg = _degrees(sums, 3000)
    assert card_head_width(deg, npad, 4096, precision) == paying * G


@pytest.mark.parametrize("t_max", [100, 128, 300, 512])
def test_card_head_width_never_passes_t_max(t_max):
    npad = NPAD
    deg = _degrees([10 * _pays("highest", npad)] * 5, 100)
    assert card_head_width(deg, npad, t_max, "highest") == t_max
    assert card_head_width(deg, npad, 0, "highest") == 0
    # a group cut short by the cap still costs the kernel a whole tile:
    # one item holding 10/128 of a group's break-even does not pay for it
    assert card_head_width(deg, npad, 1, "highest") == 0


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_card_head_width_is_zero_when_no_group_pays(precision):
    npad = NPAD
    deg = _degrees([0.95 * _pays(precision, npad)] * 4, 5000)
    assert card_head_width(deg, npad, 4096, precision) == 0
    assert card_head_width(np.zeros(0, np.int64), npad, 4096,
                           precision) == 0


def test_card_head_width_is_wider_in_bf16():
    npad = NPAD
    hi, lo = _pays("highest", npad), _pays("default", npad)
    assert lo < hi                      # a cell costs less in bf16
    deg = _degrees([3 * hi, (hi + lo) / 2, lo / 2], 2000)
    assert card_head_width(deg, npad, 4096, "highest") == G
    assert card_head_width(deg, npad, 4096, "default") == 2 * G


@pytest.mark.parametrize("precision,route", [("highest", "wide_f32"),
                                             ("default", "wide")])
def test_card_head_width_takes_the_costs_of_its_route(precision, route):
    """K = 300 runs kernel #1's resident wide kernel and the sparse wide
    lanes, whose break-even lies above the narrow routes' at K = 100: a
    group between the two pays at K = 100 and not at K = 300."""
    npad = NPAD
    assert dense_kernel(300, precision == "default") == route
    narrow, wide = _pays(precision, npad, 100), _pays(precision, npad, 300)
    assert narrow < wide
    deg = _degrees([3 * wide, (narrow + wide) / 2, narrow / 2], 2000)
    assert card_head_width(deg, npad, 4096, precision, 100) == 2 * G
    assert card_head_width(deg, npad, 4096, precision, 300) == G
    # with bias the head's packed row is K + 2 values: K = 300 + bias
    # is still the resident kernel's, K = 126 + bias the narrow route's
    assert card_head_width(deg, npad, 4096, precision, 302) == G
    assert card_head_width(deg, npad, 4096, precision, 128) == 2 * G


@pytest.mark.parametrize("precision,kaug", [("highest", 400),
                                            ("highest", 2600),
                                            ("default", 640),
                                            ("default", 3100)])
def test_card_head_width_keeps_t_max_where_no_cost_was_measured(precision,
                                                                 kaug):
    """The cluster kernel's and the unfused route's widths have no
    measured costs: there the head keeps the JAX width."""
    assert dense_kernel(kaug, precision == "default") not in \
        device_mod.BREAK_EVEN_DENSITY
    deg = _degrees([0.5 * _pays(precision, NPAD)] * 4, 5000)
    assert card_head_width(deg, NPAD, 512, precision, kaug) == 512
    assert card_head_width(deg, NPAD, 512, precision) == 0


def test_card_head_width_from_per_rank_degrees():
    """A sharded build all-reduces each rank's item degrees: the sum is
    the whole store's degrees, so every rank finds the same T."""
    js = _power_law_store(3000, 2000, 200000, seed=3)
    ts = port_store(js)
    whole = np.bincount(ts.coo_i, minlength=ts.m)
    ranks = np.array_split(np.arange(ts.coo_u.size), 4)
    summed = sum(np.bincount(ts.coo_i[r], minlength=ts.m) for r in ranks)
    np.testing.assert_array_equal(summed, whole)
    npad = 3072
    for precision in ("highest", "default"):
        t = card_head_width(whole, npad, 1024, precision)
        assert card_head_width(summed, npad, 1024, precision) == t


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_cpu_layout_keeps_the_jax_head_width(monkeypatch, precision):
    """On the CPU the head is the JAX package's width at either precision:
    the card's rule is not asked, and the notes give T and its share."""
    js = _power_law_store(100, 1500, 6000, seed=17)
    ts = port_store(js)
    monkeypatch.setattr(device_mod, "card_head_width",
                        lambda *a, **k: pytest.fail("card rule on the CPU"))
    trace.reset()
    td = t_build(ts, "cpu", pad_multiple=64, hybrid_head_items=1024,
                 dense_limit_bytes=64, precision=precision)
    t = head_width(ts.n, ts.m, 1024, 4 << 30)
    assert t == 1024 and td.head_dense_y.shape == (512, t)
    jd = j_build(js, pad_multiple=64, hybrid_head_items=1024,
                 dense_limit_bytes=64)
    _assert_hybrid_equal(jd, td, td.tail.nnz)
    notes = trace.snapshot()["notes"]
    assert notes["layout.head_items"] == t
    assert notes["layout.head_share"] == pytest.approx(
        1 - td.tail.nnz / ts.coo_u.size)
    t_build(ts, "cpu", pad_multiple=64, dense_limit_bytes=64)
    assert trace.snapshot()["notes"] == {"layout.head_items": 0,
                                         "layout.head_share": 0.0}


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_trainer_builds_the_layout_at_its_precision(tmp_path, monkeypatch,
                                                   precision):
    seen = []
    real = engine.build_device_data

    def spy(*args, **kw):
        seen.append((kw["precision"], kw["kaug"]))
        return real(*args, **kw)
    monkeypatch.setattr(engine, "build_device_data", spy)
    js, val, test = make_synthetic(np.random.default_rng(5), n=60, m=45,
                                   density=0.25)
    ttr = TTrainer(port_store(js), val, test,
                   TCfg(n=js.n, m=js.m, k=3, variant="hpf",
                        matmul_precision=precision, hybrid_head_items=8,
                        dense_limit_bytes=64),
                   TRun(outdir=str(tmp_path / "o"), rfreq=2,
                        max_iterations=2), device="cpu")
    ttr.close()
    assert seen == [(precision, 3)]


def test_trainer_builds_the_layout_at_its_packed_width(tmp_path,
                                                       monkeypatch):
    """With bias the head's packed row holds K + 2 values, the width that
    picks kernel #1's route and so the card rule's costs."""
    seen = []
    real = engine.build_device_data

    def spy(*args, **kw):
        seen.append(kw["kaug"])
        return real(*args, **kw)
    monkeypatch.setattr(engine, "build_device_data", spy)
    js, val, test = make_synthetic(np.random.default_rng(6), n=60, m=45,
                                   density=0.25)
    ttr = TTrainer(port_store(js), val, test,
                   TCfg(n=js.n, m=js.m, k=4, variant="bpf", bias=True,
                        hybrid_head_items=8, dense_limit_bytes=64),
                   TRun(outdir=str(tmp_path / "o"), rfreq=2,
                        max_iterations=2), device="cpu")
    ttr.close()
    assert seen == [6]


def _card_store(seed):
    """20,000 users x 3,000 items: 128 items at 20% density, 128 at 2%,
    the rest at 0.1%, every item present."""
    rng = np.random.default_rng(seed)
    n, m = 20000, 3000
    keys = []
    for lo, hi, density in ((0, 128, 0.2), (128, 256, 0.02),
                            (256, m, 0.001)):
        cells = n * (hi - lo)
        flat = rng.choice(cells, int(cells * density), replace=False)
        keys.append((flat % n) * m + lo + flat // n)
    keys.append(rng.integers(0, n, m) * m + np.arange(m))
    key = np.unique(np.concatenate(keys))
    perm = rng.permutation(m)             # degree order is not id order
    u, i = key // m, perm[key % m]
    js = JStore(n, m)
    js.add_training(u + 1, i + 1, rng.integers(1, 6, u.size))
    js.finalize()
    return port_store(js)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_card_layout_takes_the_card_head_width(precision):
    """On the card the head is card_head_width's, narrower than the JAX
    width here, and the hybrid sweep at that width ("highest") matches
    the port's plain sweep, run on the CPU in float64 over the COO, at
    the f32 bound, as does the CSR sweep on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the layout rule and the CUDA "
                    "kernels run only on a card")
    ts = _card_store(23)
    t_max = head_width(ts.n, ts.m, 1024, 4 << 30)
    trace.reset()
    td = t_build(ts, "cuda", hybrid_head_items=1024, dense_limit_bytes=64,
                 precision=precision, kaug=100)
    npad = -(-ts.n // 512) * 512
    t = card_head_width(np.bincount(ts.coo_i, minlength=ts.m), npad, t_max,
                        precision, 100)
    assert 0 < t < t_max
    assert td.head_dense_y.shape == (npad, t)
    assert trace.snapshot()["notes"]["layout.head_items"] == t
    if precision != "highest":
        return
    elogs = _elogs(np.random.default_rng(29), ts.n, ts.m, 100, False)
    te = [torch.from_numpy(e).cuda() for e in elogs] + [None, None]
    got = sweep(*te, td, "hybrid", precision=precision)
    csr = sweep(*te, td, "segment-chunked")
    want = sweep_segment_chunked(
        *[torch.from_numpy(e).double() for e in elogs], None, None,
        t_build(ts, "cpu", dense_limit_bytes=64))
    torch.cuda.synchronize()
    for g, c, w in zip(got[:2], csr[:2], want[:2]):
        torch.testing.assert_close(g.cpu().double(), w, **F32)
        torch.testing.assert_close(c.cpu().double(), w, **F32)
