"""The port's sharded run (parallel/sharded.py) against the JAX package's.

Two gloo worlds of CPU ranks (tests/_torch_dist_worker.py), 2 and 3
ranks, are started once for the module; each runs its tasks and writes
the gathered results. Here they are held to the JAX package's sharded
run on the 8-device CPU mesh of tests/conftest.py and to its
single-device step, on the stores of tests/test_sharded.py and
tests/test_sharded_hybrid.py made from the same seed:

  * the six step cases at rtol=2e-4, atol=1e-6 (tests/test_sharded.py:44);
  * the hybrid at the JAX `tail_impl="mxu"` in f32 (the JAX TPU tail runs
    bf16 under "highest", ROADMAP queue 3), rtol=2e-4, atol=1e-5
    (tests/test_torch_hybrid.py:39): three variants, ragged shards and
    multi_step;
  * uneven rows masked, worlds of 2 and 3;
  * a rank whose whole row block is padding (4 users on 3 ranks) under
    MLE-user on the `segment` sweep: finite, and the single-device run's
    state at the sharded bound (rtol 1e-4, atol 1e-7);
  * the item-sharded top-k against the port's streamed top-k (also at
    world size 1) and the JAX sharded top-k;
  * a report of the Trainer's sharded loop issues the same collectives,
    in the same order, on the primary and on the other rank.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import make_synthetic
from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.data.device import build_device_data as j_build
from hgaprec_tpu.data.ratings import RatingsStore as JStore
from hgaprec_tpu.eval.ranking import EvalIndex as JIndex
from hgaprec_tpu.eval.score import scorer_from_state as j_scorer
from hgaprec_tpu.models.state import init_state as j_init
from hgaprec_tpu.models.step import make_step as j_make_step
from hgaprec_tpu.parallel.sharded import build_sharded_run as j_sharded
from hgaprec_tpu.parallel.sharded import make_mesh
from hgaprec_tpu.parallel.sharded import sharded_masked_topk as j_topk
from hgaprec_tpu_torch.eval.ranking import EvalIndex
from hgaprec_tpu_torch.eval.score import Scorer
from hgaprec_tpu_torch.eval.topk import masked_topk
from test_torch_step import port_store

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STEP = dict(rtol=2e-4, atol=1e-6)
HYBRID = dict(rtol=2e-4, atol=1e-5)
SHARD = dict(rtol=1e-4, atol=1e-7)       # chip_smoke.py's SHARD_TOL

STEP_CASES = [("bpf", {}, True), ("bpf", {"bias": True}, False),
              ("hpf", {}, True), ("hpf", {}, False),
              ("mle_user", {}, True), ("canny", {}, False)]
HYBRID_CASES = [("hpf", {}), ("bpf", {"bias": True}), ("bpf", {})]
HYBRID_CFG = dict(k=4, sweep="hybrid", hybrid_head_items=8,
                  dense_limit_bytes=64)
TOPK_CASES = {"streamed": dict(n=37, m=61, k=7, variant="bpf", bias=False,
                               seed=3, steps=2, users=(0, 37, 3)),
              "bias_k_over_shard": dict(n=19, m=17, k=12, variant="bpf",
                                        bias=True, seed=9, steps=1,
                                        users=(0, 19, 1))}


def _rng():
    return np.random.default_rng(42)      # the JAX tests' `rng` fixture


def _ragged_store():
    """tests/test_sharded_hybrid.py::test_sharded_hybrid_ragged_shards."""
    rng = _rng()
    n, m, nnz = 64, 40, 300
    u = np.sort(rng.integers(0, 9, nnz)).astype(np.int64)
    i = rng.integers(0, m, nnz).astype(np.int64)
    y = rng.integers(1, 4, nnz).astype(np.float64)
    store = JStore(n, m)
    store.add_training(u + 1, i + 1, y)
    store.finalize()
    return store


STORES = {
    "s53": lambda: make_synthetic(_rng(), n=53, m=31, density=0.3),
    "s70": lambda: make_synthetic(_rng(), n=70, m=45, density=0.3),
    "s41": lambda: make_synthetic(_rng(), n=41, m=23, density=0.3),
    "ragged": lambda: (_ragged_store(), {}, {}),
    "streamed": lambda: make_synthetic(_rng(), n=37, m=61, density=0.25),
    "bias_k_over_shard": lambda: make_synthetic(_rng(), n=19, m=17,
                                                density=0.3),
    "pad4": lambda: make_synthetic(_rng(), n=4, m=15, density=0.8),
}


def _case_id(variant, kw, dense=None):
    return "-".join([variant, *kw] + ([] if dense is None else
                                      ["dense" if dense else "segment"]))


def _topk_inputs(name):
    """(JAX scorer, users, mask_cols, JAX store, validation, test) of a
    top-k case: the JAX state after a few dense steps, the mask of
    tests/test_sharded.py:103-110."""
    c = TOPK_CASES[name]
    store, validation, test = STORES[name]()
    cfg = JCfg(n=store.n, m=store.m, k=4 if not c["bias"] else 3,
               variant=c["variant"], bias=c["bias"])
    state = j_init(cfg, seed=c["seed"])
    step = j_make_step(cfg)
    data = j_build(store, pad_multiple=128)
    for _ in range(c["steps"]):
        state = step(state, data)
    sc = j_scorer(state, cfg)
    index = JIndex(validation, test)
    users = np.arange(*c["users"]).astype(np.int64)
    masks = [np.union1d(store.items_of_user(int(n)),
                        index.val_items(int(n))).astype(np.int64)
             for n in users]
    d = max(max((mk.size for mk in masks), default=1), 1)
    mask_cols = np.full((len(users), d), -(10 ** 9), np.int32)
    for r, mk in enumerate(masks):
        mask_cols[r, :mk.size] = mk
    return sc, users, mask_cols, store, validation, test


def _tasks():
    tasks = []
    for variant, kw, dense in STEP_CASES:
        tasks.append(dict(kind="step", name="step-" + _case_id(variant, kw,
                                                               dense),
                          store="s53", seed=11, steps=3,
                          cfg=dict(k=4, variant=variant,
                                   sweep="dense" if dense else "segment",
                                   **kw)))
    for variant, kw in HYBRID_CASES:
        tasks.append(dict(kind="step", name="hybrid-" + _case_id(variant,
                                                                 kw),
                          store="s70", seed=11, steps=3,
                          cfg=dict(variant=variant, **HYBRID_CFG, **kw)))
    tasks.append(dict(kind="step", name="hybrid-ragged", store="ragged",
                      seed=11, steps=2, cfg=dict(variant="hpf",
                                                 **HYBRID_CFG)))
    tasks.append(dict(kind="step", name="hybrid-multi", store="s70",
                      seed=11, steps=4, multi=True,
                      cfg=dict(variant="hpf", **HYBRID_CFG)))
    tasks.append(dict(kind="step", name="uneven", store="s41", seed=5,
                      steps=2, cfg=dict(k=3, variant="hpf")))
    tasks.append(dict(kind="step", name="padrank", store="pad4", seed=5,
                      steps=3, cfg=dict(k=3, variant="mle_user",
                                        sweep="segment")))
    for name, c in TOPK_CASES.items():
        tasks.append(dict(kind="topk", name=f"topk-{name}", k=c["k"]))
    _, validation, test = STORES["s53"]()
    tasks.append(dict(kind="report", name="report", store="s53", rfreq=2,
                      iters=4, cfg=dict(k=3, variant="hpf"),
                      validation=[[u, i, y] for (u, i), y in
                                  validation.items()],
                      test=[[u, i, y] for (u, i), y in test.items()]))
    return tasks


def _spawn(workdir, world, tasks, timeout=300):
    os.makedirs(workdir, exist_ok=True)
    for name in {t["store"] for t in tasks if "store" in t}:
        store = STORES[name]()[0]
        np.savez(os.path.join(workdir, f"{name}.npz"), n=store.n, m=store.m,
                 u=store.coo_u, i=store.coo_i, y=store.coo_y)
    for t in tasks:
        if t["kind"] == "topk":
            sc, users, mask, *_ = _topk_inputs(t["name"][len("topk-"):])
            arrays = dict(su=np.asarray(sc.su, np.float32),
                          sv=np.asarray(sc.sv, np.float32), users=users,
                          mask=mask)
            if sc.bias_u is not None:
                arrays.update(bu=np.asarray(sc.bias_u, np.float32),
                              bi=np.asarray(sc.bias_i, np.float32))
            np.savez(os.path.join(workdir, f"{t['name']}.in.npz"), **arrays)
    for t in tasks:
        if t["kind"] == "report":
            # ranked at the stop (gen_ranking_for_users, a collective);
            # the worker's stores map ids to themselves
            with open(os.path.join(workdir, "test_users.tsv"), "w") as f:
                f.write("".join(f"{u}\n" for u in
                                sorted({u for u, _, _ in t["test"]})))
    with open(os.path.join(workdir, "tasks.json"), "w") as f:
        json.dump(tasks, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
         str(r), str(world), workdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(world)]


def _wait(procs, timeout):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
            pytest.fail("a sharded worker hung; all ranks were killed")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: work directory} after both worlds ran their tasks."""
    base = tmp_path_factory.mktemp("sharded")
    dirs = {2: str(base / "w2"), 3: str(base / "w3")}
    procs = {2: _spawn(dirs[2], 2, _tasks()),
             3: _spawn(dirs[3], 3, [t for t in _tasks()
                                    if t["name"] in ("uneven", "padrank")])}
    for world in (2, 3):
        _wait(procs[world], timeout=300)
    return dirs


def _result(worlds, name, world=2, rank=0):
    with np.load(os.path.join(worlds[world], f"{name}.rank{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def _jax_single(store, cfg, steps, seed, **build):
    data = j_build(store, pad_multiple=128, **build)
    state = j_init(cfg, seed=seed)
    step = j_make_step(cfg)
    for _ in range(steps):
        state = step(state, data)
    return state


def _fields(variant, bias):
    out = []
    if variant != "mle_user":
        out += [("theta.e", "theta", "e"), ("theta.shape", "theta", "shape"),
                ("theta.rate", "theta", "rate")]
    if variant not in ("mle_item", "canny"):
        out.append(("beta.e", "beta", "e"))
    if variant == "hpf":
        out += [("theta_rate.e", "theta_rate", "e"),
                ("beta_rate.e", "beta_rate", "e")]
    if bias:
        out += [("theta_bias.e", "theta_bias", "e"),
                ("beta_bias.e", "beta_bias", "e")]
    if variant == "mle_user":
        out.append(("theta_mle", "theta_mle", None))
    if variant == "canny":
        out.append(("beta_mle", "beta_mle", None))
    return out


def _jax_leaf(state, family, part):
    v = getattr(state, family)
    return np.asarray(v if part is None else getattr(v, part))


@pytest.mark.parametrize("variant,kw,dense", STEP_CASES,
                         ids=[_case_id(*c) for c in STEP_CASES])
def test_sharded_matches_jax(worlds, variant, kw, dense):
    assert len(jax.devices()) == 8
    store = STORES["s53"]()[0]
    cfg = JCfg(n=store.n, m=store.m, k=4, variant=variant,
               sweep="dense" if dense else "segment", **kw)
    single = _jax_single(store, cfg, 3, 11)
    run = j_sharded(store, cfg, make_mesh(), seed=11, pad_multiple=128,
                    dense=dense)
    for _ in range(3):
        run.step()
    sharded = run.unsharded_state()
    got = _result(worlds, "step-" + _case_id(variant, kw, dense))
    assert bool(got["layout"][0]) == dense
    for key, family, part in _fields(variant, cfg.bias):
        for name, ref in (("jax single", single), ("jax sharded", sharded)):
            np.testing.assert_allclose(got[key], _jax_leaf(ref, family, part),
                                       **STEP, err_msg=f"{key} vs {name}")


@pytest.mark.parametrize("variant,kw", HYBRID_CASES,
                         ids=[_case_id(*c) for c in HYBRID_CASES])
def test_sharded_hybrid_matches_jax(worlds, variant, kw):
    store = STORES["s70"]()[0]
    cfg = JCfg(n=store.n, m=store.m, variant=variant, tail_impl="mxu",
               **HYBRID_CFG, **kw)
    single = _jax_single(store, cfg, 3, 11, hybrid_head_items=8,
                         dense_limit_bytes=64)
    run = j_sharded(store, cfg, make_mesh(), seed=11, pad_multiple=128)
    for _ in range(3):
        run.step()
    sharded = run.unsharded_state()
    got = _result(worlds, "hybrid-" + _case_id(variant, kw))
    # the head block and the tail stream were built, and the step took
    # the hybrid sweep
    assert got["layout"].tolist() == [False, True, True]
    assert str(got["mode"]) == "hybrid"
    for key, family, part in _fields(variant, cfg.bias):
        for name, ref in (("jax single", single), ("jax sharded", sharded)):
            np.testing.assert_allclose(got[key], _jax_leaf(ref, family, part),
                                       **HYBRID, err_msg=f"{key} vs {name}")


@pytest.mark.parametrize("name,steps", [("hybrid-ragged", 2),
                                        ("hybrid-multi", 4)],
                         ids=["ragged", "multi_step"])
def test_sharded_hybrid_against_single(worlds, name, steps):
    """Ragged shards (every user in the first rank's rows: the other
    rank's head block and tail are empty) and the multi-step dispatch."""
    store = STORES["ragged" if name == "hybrid-ragged" else "s70"]()[0]
    cfg = JCfg(n=store.n, m=store.m, variant="hpf", tail_impl="mxu",
               **HYBRID_CFG)
    single = _jax_single(store, cfg, steps, 11, hybrid_head_items=8,
                         dense_limit_bytes=64)
    got = _result(worlds, name)
    assert str(got["mode"]) == "hybrid"
    for key in ("theta.e", "beta.e"):
        np.testing.assert_allclose(
            got[key], _jax_leaf(single, key.split(".")[0], "e"), **HYBRID,
            err_msg=key)


@pytest.mark.parametrize("world", [2, 3])
def test_uneven_rows_masked(worlds, world):
    """n = 41 over 2 and 3 ranks: the padding rows of the last block
    leave the sums untouched."""
    store = STORES["s41"]()[0]
    cfg = JCfg(n=store.n, m=store.m, k=3, variant="hpf")
    single = _jax_single(store, cfg, 2, 5)
    got = _result(worlds, "uneven", world)
    assert int(got["n_local"]) * world > store.n     # padding rows exist
    for key in ("beta.e", "theta.e", "theta_rate.e"):
        family = key.split(".")[0]
        np.testing.assert_allclose(got[key], _jax_leaf(single, family, "e"),
                                   **STEP, err_msg=key)
        assert got[key].shape == _jax_leaf(single, family, "e").shape


def test_all_padding_rank_stays_finite(worlds):
    """4 users over 3 ranks: the third rank's two rows are both padding,
    so no real row of its own can carry its COO padding entries. Under
    MLE-user theta_mle is 0 on padding rows (Elog -inf), and the segment
    sweep's log-softmax must still give those entries a zero share: the
    gathered state is finite and the single-device run's."""
    store = STORES["pad4"]()[0]
    assert store.n == 4
    cfg = JCfg(n=store.n, m=store.m, k=3, variant="mle_user",
               sweep="segment")
    single = _jax_single(store, cfg, 3, 5)
    got = _result(worlds, "padrank", world=3)
    assert int(got["n_local"]) * 2 >= store.n        # rank 2: padding only
    assert not bool(got["layout"][0])                 # the segment layout
    for key, family, part in _fields("mle_user", False):
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], _jax_leaf(single, family, part),
                                   **SHARD, err_msg=key)


def _same_up_to_ties(ids, ref_ids, ref_vals):
    """ids equal where the scores are not tied: with a neighbour, or with
    the last kept score (an item past the cut may take its place)."""
    ties = np.isclose(ref_vals, np.roll(ref_vals, 1, axis=1))
    at_cut = np.isclose(ref_vals, ref_vals[:, -1:])
    return ((ids == ref_ids) | ties | np.roll(ties, -1, axis=1)
            | at_cut).all()


@pytest.mark.parametrize("name", list(TOPK_CASES))
def test_sharded_topk(worlds, name):
    """Against the port's streamed top-k (the world of 2, and a one-rank
    group) and against the JAX sharded top-k on 8 devices; k =
    12 > 9 items per rank in the bias case."""
    k = TOPK_CASES[name]["k"]
    sc, users, mask_cols, store, validation, test = _topk_inputs(name)
    tstore = port_store(store)
    tsc = Scorer(*(None if x is None else torch.tensor(
        np.asarray(x, np.float32)) for x in (sc.su, sc.sv, sc.bias_u,
                                             sc.bias_i)))
    v_ref, i_ref = masked_topk(tsc, tstore, EvalIndex(validation, test,
                                                      tstore), users, k=k)
    v_jax, i_jax = j_topk(sc, make_mesh(), users, mask_cols, k=k)
    got = _result(worlds, f"topk-{name}")
    other = _result(worlds, f"topk-{name}", rank=1)
    for vals, ids in ((got["vals"], got["ids"]),
                      (got["vals1"], got["ids1"])):
        np.testing.assert_allclose(vals, v_ref, rtol=1e-5, atol=1e-6)
        assert _same_up_to_ties(ids, i_ref, v_ref)
        np.testing.assert_allclose(vals, v_jax, rtol=1e-5, atol=1e-6)
        assert _same_up_to_ties(ids, np.asarray(i_jax), v_jax)
    # every rank holds the merged result
    np.testing.assert_array_equal(other["vals"], got["vals"])
    np.testing.assert_array_equal(other["ids"], got["ids"])


def test_report_collectives_match(worlds):
    """The Trainer's sharded loop on per-rank stores (HPF, reports at
    iterations 0, 2 and 4, the stop save): the primary and the other
    rank issue the same collectives with the same shapes in the same
    order, reports' gathers, the evaluated users' rows and the
    item-sharded top-k included (the JAX sharded loop's primary gathers
    other leaves than the rest, hgaprec_tpu/cli.py:606). Only the
    primary writes model.npz and the ranking files."""
    r0 = _result(worlds, "report", rank=0)
    r1 = _result(worlds, "report", rank=1)
    calls0, calls1 = r0["calls"].tolist(), r1["calls"].tolist()
    assert calls0 == calls1
    gathers = [c for c in calls0 if c.startswith("all_gather")]
    # 3 reports and the final gather of the full state, and the top-k's
    # candidate lists at each report
    assert len(gathers) >= 4 * 10 and len(calls0) > len(gathers)
    assert bool(r0["primary"]) and not bool(r1["primary"])
    out0, out1 = str(r0["outdir"]), str(r1["outdir"])
    assert out1 == os.path.join(out0, ".proc1")
    assert os.path.exists(os.path.join(out0, "model.npz"))
    assert os.path.exists(os.path.join(out0, "ranking.tsv"))
    assert os.path.exists(os.path.join(out0, "itemrank.tsv"))
    assert not os.path.exists(os.path.join(out1, "model.npz"))
    assert os.path.exists(os.path.join(out1, "validation.txt"))
