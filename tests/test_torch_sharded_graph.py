"""The sharded fused multi-step: `ShardedRun.multi_step` through the
group-aware `models/step.py::GraphMultiStep`, against the JAX package's
`ShardedRun.multi_step` (one `fori_loop` over the shard-mapped step) and
against the loop.

Two gloo worlds of CPU ranks (tests/_torch_dist_worker.py), 2 and 3
ranks, are started once for the module. Each rank drives its run's
runner with the worker's fake capture object (`capture` runs the step,
its collectives included, and puts the state back; `replay` runs it
again) and an injected predicate that stands for the card's NCCL check,
so the runner captures and replays over gloo here:

  * dense, hybrid and segment layouts, HPF, BPF with bias and Canny:
    the gathered state after 4 iterations (two calls of 2) equals the JAX
    sharded multi-step on the 8-device CPU mesh of tests/conftest.py at
    tests/test_torch_sharded.py::test_sharded_matches_jax's bound
    (rtol=2e-4, atol=1e-6; the JAX hybrid runs its `tail_impl="mxu"` in
    f32), and the loop's state bit for bit (MLE-user is not among them:
    the JAX sharded segment run diverges from its own single-device run
    there, ROADMAP.md queue 3);
  * each rank makes one eager step, one capture and 3 replays;
  * the run's default runner over gloo makes no graph (gloo's
    collectives cannot be captured): the loop;
  * a new row mask, group or state storage captures anew, `close()`
    drops the graph, and `Trainer.close` drops a sharded run's graph
    while it still holds the group.
"""

import os

import numpy as np
import pytest

from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.parallel.sharded import build_sharded_run as j_sharded
from hgaprec_tpu.parallel.sharded import make_mesh
from test_torch_sharded import (HYBRID_CFG, STEP, STORES, _fields,
                                _jax_leaf, _spawn, _wait)

STEPS = 4
LAYOUTS = {"dense": ("s53", dict(k=4, sweep="dense")),
           "segment": ("s53", dict(k=4, sweep="segment")),
           "hybrid": ("s70", HYBRID_CFG)}
VARIANTS = {"hpf": dict(variant="hpf"),
            "bpf-bias": dict(variant="bpf", bias=True),
            "canny": dict(variant="canny")}
CASES = [(layout, variant) for layout in LAYOUTS for variant in VARIANTS]
WORLDS = (2, 3)
KEYS_CFG = dict(k=3, variant="hpf", sweep="segment")


def _name(layout, variant):
    return f"graph-{layout}-{variant}"


def _tasks():
    tasks = [dict(kind="graph", name=_name(layout, variant),
                  store=LAYOUTS[layout][0], seed=11, steps=STEPS,
                  cfg=dict(**LAYOUTS[layout][1], **VARIANTS[variant]))
             for layout, variant in CASES]
    tasks.append(dict(kind="graph_keys", name="graph-keys", store="s41",
                      seed=5, cfg=KEYS_CFG))
    return tasks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: work directory} after both worlds ran their tasks."""
    base = tmp_path_factory.mktemp("sharded_graph")
    dirs = {w: str(base / f"w{w}") for w in WORLDS}
    procs = {w: _spawn(dirs[w], w, _tasks()) for w in WORLDS}
    for w in WORLDS:
        _wait(procs[w], timeout=300)
    return dirs


def _result(worlds, name, world, rank=0):
    with np.load(os.path.join(worlds[world], f"{name}.rank{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def _states(got, prefix):
    return {k[len(prefix):]: v for k, v in got.items()
            if k.startswith(prefix)}


_JAX = {}


def _jax_multi(layout, variant):
    """The JAX sharded multi-step's gathered state (cached per case)."""
    if (layout, variant) not in _JAX:
        store_name, kw = LAYOUTS[layout]
        store = STORES[store_name]()[0]
        cfg = JCfg(n=store.n, m=store.m, tail_impl="mxu", **kw,
                   **VARIANTS[variant])
        run = j_sharded(store, cfg, make_mesh(), seed=11, pad_multiple=128,
                        dense=layout == "dense")
        run.multi_step(STEPS)
        _JAX[layout, variant] = (run.unsharded_state(), cfg)
    return _JAX[layout, variant]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout,variant", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_sharded_replay_matches_jax(worlds, layout, variant, world):
    got = _result(worlds, _name(layout, variant), world)
    want = {"dense": [True, False, False], "segment": [False, False, False],
            "hybrid": [False, True, True]}[layout]
    assert got["layout"].tolist() == want
    assert str(got["mode"]) == layout
    state, cfg = _jax_multi(layout, variant)
    replay = _states(got, "replay:")
    for key, family, part in _fields(cfg.variant, cfg.bias):
        np.testing.assert_allclose(replay[key],
                                   _jax_leaf(state, family, part), **STEP,
                                   err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout,variant", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_sharded_replay_equals_loop(worlds, layout, variant, world):
    """Bit for bit on every rank, every leaf of the gathered state."""
    for rank in range(world):
        got = _result(worlds, _name(layout, variant), world, rank)
        replay, loop = _states(got, "replay:"), _states(got, "loop:")
        assert sorted(replay) == sorted(loop)
        for key, v in replay.items():
            np.testing.assert_array_equal(v, loop[key], key)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_replay_counts(worlds, world):
    """On each rank: one eager step, one capture and STEPS - 1 replays,
    all on one graph, and the graph dropped by close(); the run's
    default runner took the loop (gloo)."""
    for layout, variant in CASES:
        for rank in range(world):
            got = _result(worlds, _name(layout, variant), world, rank)
            assert got["counts"].tolist() == [1, 1, STEPS - 1]
            assert got["graphs"].tolist() == [1, STEPS - 1]
            assert got["loop_counts"].tolist() == [0, 0, 0]
            assert got["closed"].all()


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_group_takes_the_loop(worlds, world):
    """With no injected predicate a gloo group is not captured: no graph
    is made, every step is the loop's."""
    for rank in range(world):
        got = _result(worlds, "graph-keys", world, rank)
        assert got["gloo_replays_on"].tolist() == [False, False, True]
        assert got["gloo_counts"].tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("world", WORLDS)
def test_new_mask_group_or_storage_captures_anew(worlds, world):
    """A clone of the row mask, a new group over the same ranks and a
    state tensor at a new address each cost one more eager step and
    capture; close() drops the graph and the next call captures anew;
    the 7 iterations end bit for bit where the loop's 7 do."""
    for rank in range(world):
        got = _result(worlds, "graph-keys", world, rank)
        assert got["seen"].tolist() == [[1, 1, 1], [2, 2, 1], [3, 3, 2],
                                        [4, 4, 2], [5, 5, 2]]
        assert got["closed"].all()
        replay, loop = _states(got, "replay:"), _states(got, "loop:")
        assert sorted(replay) == sorted(loop)
        for key, v in replay.items():
            np.testing.assert_array_equal(v, loop[key], key)


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_drops_the_sharded_graph(worlds, world):
    """Trainer.run's sharded loop replays (5 iterations: one eager step,
    one capture, 4 replays), and close() drops the run's graph while the
    Trainer still holds the group, so the caller's destroy_process_group
    finds no live graph."""
    for rank in range(world):
        got = _result(worlds, "graph-keys", world, rank)
        assert got["trainer_counts"].tolist() == [1, 1, 4]
        assert got["close_dropped"].tolist() == [True, True]
