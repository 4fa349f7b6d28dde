"""The fused multi-step: the port's `make_multi_step` against the JAX
package's `cavi_multi_step`, and the CUDA-graph runner's bookkeeping.

Parity: both packages start from the same JAX init_state (carried over
with state_from_numpy) on the same data and take n_steps iterations in
one call, on the dense, hybrid and segment-chunked layouts, for HPF and
for BPF with bias, held at the bound of tests/test_torch_step.py
(rtol=5e-4, atol=1e-6; the JAX hybrid runs its strict-f32 MXU tail, as
tests/test_torch_hybrid.py holds it).

The runner (`GraphMultiStep`) is driven on the CPU with its capture
object injected as a fake: capture runs the step's Python, as a CUDA
capture does, and undoes its effect on the state (a capture runs no
kernel); replay runs the step. So the runner's state is held bitwise to
the loop's, and its counts of eager steps, captures, replays and kernel
launches are checked.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from conftest import make_synthetic
from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.data.device import build_device_data as j_build
from hgaprec_tpu.models.state import init_state as j_init
from hgaprec_tpu.models.step import make_multi_step as j_make_multi_step
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.config import RunConfig as TRun
from hgaprec_tpu_torch.data.device import build_device_data as t_build
from hgaprec_tpu_torch.models import step as step_mod
from hgaprec_tpu_torch.models.engine import Trainer as TTrainer
from hgaprec_tpu_torch.models.state import (init_state, state_from_numpy,
                                            state_to_numpy)
from hgaprec_tpu_torch.models.step import (GraphMultiStep, _resolve_mode,
                                           make_multi_step)
from hgaprec_tpu_torch.ops import dense_fused as df
from hgaprec_tpu_torch.ops import segment_fused as sf
from hgaprec_tpu_torch.ops import tail_fused as tf
from test_torch_step import _arrays, port_store

LAYOUTS = {"dense": dict(sweep="dense"),
           "hybrid": dict(sweep="hybrid", hybrid_head_items=8,
                          dense_limit_bytes=64),
           "segment-chunked": dict(sweep="segment-chunked")}
VARIANTS = {"hpf": dict(variant="hpf"),
            "bpf-bias": dict(variant="bpf", bias=True)}
_BUILD = ("hybrid_head_items", "dense_limit_bytes")
# on a card the head is data/device.py::card_head_width's: 8 columns of the
# card tests' 300 x 200 catalog do not pay for a tile of kernel #1, and
# its 128 densest do
CARD_LAYOUTS = {**LAYOUTS, "hybrid": dict(LAYOUTS["hybrid"],
                                          hybrid_head_items=128)}


def _case(rng, layout, variant):
    """(JAX store, port config, port data, JAX config, JAX data)."""
    js, _, _ = make_synthetic(rng, n=30, m=24, density=0.35)
    kw = {**LAYOUTS[layout], **VARIANTS[variant]}
    build = {k: kw[k] for k in _BUILD if k in kw}
    tcfg = TCfg(n=js.n, m=js.m, k=4, **kw)
    jcfg = JCfg(n=js.n, m=js.m, k=4, tail_impl="mxu", **kw)
    tdata = t_build(port_store(js), "cpu", pad_multiple=64, **build)
    jdata = j_build(js, pad_multiple=64, **build)
    assert _resolve_mode(tcfg, tdata) == layout
    return js, tcfg, tdata, jcfg, jdata


@pytest.mark.parametrize("n_steps", [1, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_multi_step_matches_jax(tmp_path, rng, layout, variant, n_steps):
    js, tcfg, tdata, jcfg, jdata = _case(rng, layout, variant)
    jstate = j_init(jcfg, seed=7)
    tstate = state_from_numpy(_arrays(tmp_path, jstate), tcfg, "cpu")
    jstate = j_make_multi_step(jcfg)(jstate, jdata, n_steps)
    tstate = make_multi_step(tcfg)(tstate, tdata, n_steps)
    want = _arrays(tmp_path, jstate)
    got = state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=5e-4,
                                   atol=1e-6, err_msg=key)


def _uncount(fn):
    """Run fn and take back the launches the kernel wrappers counted."""
    before = step_mod._launch_counts()
    fn()
    step_mod._add_launches(step_mod._launches_since(before), -1)


class FakeGraph:
    """A capture object: `capture` runs the step's Python (the kernel
    wrappers count their calls there, as under a CUDA capture) and puts
    the state back as it was; `replay` runs the step, which on the card
    runs no Python, so the wrappers' counts are taken back."""
    made = []

    def __init__(self, device):
        self.device = device
        self.fn = None
        self.replays = 0
        FakeGraph.made.append(self)

    def capture(self, fn):
        state = fn.args[0]
        saved = [t.clone() for _, t in step_mod.tensor_leaves(state)]
        fn()
        for (_, t), s in zip(step_mod.tensor_leaves(state), saved):
            t.copy_(s)
        self.fn = fn

    def replay(self):
        self.replays += 1
        _uncount(self.fn)


def _replaying(cfg):
    """A runner with the fake graph that replays on the CPU too."""
    FakeGraph.made = []
    return GraphMultiStep(cfg, new_graph=FakeGraph,
                          capturable=lambda state, group: True)


def _state(cfg):
    return init_state(cfg, seed=3, device="cpu")


def _assert_states_equal(a, b):
    want = state_to_numpy(b)
    for key, v in state_to_numpy(a).items():
        np.testing.assert_array_equal(v, want[key], key)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_replay_equals_loop(rng, layout, variant):
    """One eager step and one capture at the first call, replays only
    after it, and the loop's state bit for bit."""
    _, cfg, data, _, _ = _case(rng, layout, variant)
    runner = _replaying(cfg)
    got = runner(_state(cfg), data, 3)
    assert (runner.eager_steps, runner.captures, runner.replays) == (1, 1, 2)
    got = runner(got, data, 5)
    assert (runner.eager_steps, runner.captures, runner.replays) == (1, 1, 7)
    assert len(FakeGraph.made) == 1 and FakeGraph.made[0].replays == 7
    want = make_multi_step(cfg, graph=False)(_state(cfg), data, 8)
    _assert_states_equal(got, want)


def test_cpu_state_takes_the_loop(rng):
    _, cfg, data, _, _ = _case(rng, "dense", "hpf")
    FakeGraph.made = []
    runner = GraphMultiStep(cfg, new_graph=FakeGraph)
    got = runner(_state(cfg), data, 4)
    assert FakeGraph.made == []
    assert (runner.eager_steps, runner.captures, runner.replays) == (0, 0, 0)
    _assert_states_equal(got, make_multi_step(cfg, graph=False)(
        _state(cfg), data, 4))


def test_zero_steps_do_nothing(rng):
    _, cfg, data, _, _ = _case(rng, "dense", "hpf")
    runner = _replaying(cfg)
    state = _state(cfg)
    before = state_to_numpy(state)
    assert runner(state, data, 0) is state
    assert FakeGraph.made == [] and runner.graph is None
    assert (runner.eager_steps, runner.captures, runner.replays) == (0, 0, 0)
    for key, v in state_to_numpy(state).items():
        np.testing.assert_array_equal(v, before[key], key)


def test_new_state_or_data_is_captured_anew(rng):
    """A state tensor replaced (as a state read from the model TSVs is)
    or new data: one more eager step and capture, and the result is
    still the loop's."""
    js, cfg, data, _, _ = _case(rng, "segment-chunked", "hpf")
    runner = _replaying(cfg)
    state = runner(_state(cfg), data, 2)
    # one table swapped for a copy at another address
    theta = dataclasses.replace(state.theta, e=state.theta.e.clone())
    state = dataclasses.replace(state, theta=theta)
    state = runner(state, data, 2)
    assert (runner.eager_steps, runner.captures, runner.replays) == (2, 2, 2)
    data2 = t_build(port_store(js), "cpu", pad_multiple=64)
    state = runner(state, data2, 3)
    assert (runner.eager_steps, runner.captures, runner.replays) == (3, 3, 4)
    state = runner(state, data2, 1)
    assert (runner.eager_steps, runner.captures, runner.replays) == (3, 3, 5)
    want = make_multi_step(cfg, graph=False)(_state(cfg), data, 8)
    _assert_states_equal(state, want)
    runner.reset()
    assert runner.graph is None and runner._held is None


def test_replays_count_the_captured_launches(rng, monkeypatch):
    """A replay adds the launches its capture recorded to each kernel
    wrapper's counts; the capture adds none (it launches nothing)."""
    _, cfg, data, _, _ = _case(rng, "dense", "hpf")
    real = step_mod.cavi_step

    def counted(state, data, cfg, *args):
        # what the wrappers add on the card: two dense launches (one of
        # them the split kernel's), a tail half and a CSR sweep
        df.fused_dense_sweep.launches += 2
        df.fused_dense_sweep.launches_by_kernel["f32"] += 1
        df.fused_dense_sweep.launches_by_kernel["wgmma"] += 1
        tf.fused_half_sweep.launches += 1
        sf.fused_segment_sweep.launches += 1
        return real(state, data, cfg, *args)
    monkeypatch.setattr(step_mod, "cavi_step", counted)
    counters = (df.fused_dense_sweep, tf.fused_half_sweep,
                sf.fused_segment_sweep)
    monkeypatch.setattr(df.fused_dense_sweep, "launches_by_kernel",
                        {k: 0 for k in df.KERNELS})
    for w in counters:
        monkeypatch.setattr(w, "launches", 0)
    runner = _replaying(cfg)
    state = runner(_state(cfg), data, 1)
    assert [w.launches for w in counters] == [2, 1, 1]
    runner(state, data, 4)
    assert [w.launches for w in counters] == [10, 5, 5]
    by = df.fused_dense_sweep.launches_by_kernel
    assert (by["f32"], by["wgmma"], sum(by.values())) == (5, 5, 10)


def _trainer(tmp_path, name, rng_seed=5):
    js, val, test = make_synthetic(np.random.default_rng(rng_seed), n=40,
                                   m=30, density=0.3)
    return TTrainer(port_store(js), val, test,
                    TCfg(n=js.n, m=js.m, k=3, variant="hpf"),
                    TRun(datdir=str(tmp_path), outdir=str(tmp_path / name),
                         rfreq=3, max_iterations=9, seed=1,
                         enforce_max_iterations=True), device="cpu")


def _rows(path):
    with open(path) as f:
        return [r.split("\t") for r in f.read().splitlines() if r]


def test_trainer_replays_between_reports(tmp_path):
    """A Trainer whose multi-step replays reports at the loop's
    iterations with the loop's values (the chunks of `next_chunk` are
    unchanged): 10 iterations are one eager step and 9 replays. Reading
    a model back drops the graph, the next chunk captures anew, and
    close() frees it."""
    loop = _trainer(tmp_path, "loop")
    assert [loop.next_chunk(9)] == [(1, 0)]
    loop.run()
    loop.close()
    tr = _trainer(tmp_path, "replay")
    tr.multi_step = _replaying(tr.mcfg)
    tr.run()
    runner = tr.multi_step
    assert (runner.eager_steps, runner.captures, runner.replays) == (1, 1, 9)
    got = _rows(tmp_path / "replay" / "validation.txt")
    want = _rows(tmp_path / "loop" / "validation.txt")
    assert [r[0] for r in got] == [r[0] for r in want] == \
        ["0", "3", "6", "9"]
    assert [r[2] for r in got] == [r[2] for r in want]
    _assert_states_equal(tr.state, loop.state)
    tr.iteration = 10
    assert tr.next_chunk(12) == (3, 12)
    tr.load_model()
    assert runner.graph is None
    tr.run(12)
    assert (runner.eager_steps, runner.captures, runner.replays) == (2, 2, 11)
    tr.close()
    assert runner.graph is None
    assert os.path.exists(tmp_path / "replay" / "model.npz")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,precision", [
    ("dense", "highest"), ("dense", "default"), ("segment-chunked", "highest"),
    ("hybrid", "highest"), ("hybrid", "default")])
def test_card_replay_equals_loop(rng, layout, precision):
    """On the card: one eager step, one CUDA graph capture and replays
    after it; the state after 4 steps is the loop's bit for bit on the
    dense and segment layouts, and on the hybrid within the f32 bound of
    tests/test_dense_pallas.py (rtol=2e-4, atol=1e-5; its head adds with
    index_add_); each replay adds one step's launches to the counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have "
                    "no CPU mode")
    js, _, _ = make_synthetic(rng, n=300, m=200, density=0.2)
    kw = {**CARD_LAYOUTS[layout], "variant": "hpf",
          "matmul_precision": precision}
    build = {k: kw[k] for k in _BUILD if k in kw}
    cfg = TCfg(n=js.n, m=js.m, k=20, **kw)
    data = t_build(port_store(js), "cuda", pad_multiple=64, **build)
    assert _resolve_mode(cfg, data) == layout
    want = make_multi_step(cfg, graph=False)(
        init_state(cfg, seed=3, device="cuda"), data, 4)
    runner = make_multi_step(cfg)
    counters = (df.fused_dense_sweep, tf.fused_half_sweep,
                sf.fused_segment_sweep)
    before = [w.launches for w in counters]
    got = runner(init_state(cfg, seed=3, device="cuda"), data, 1)
    one = [w.launches - b for w, b in zip(counters, before)]
    got = runner(got, data, 3)
    torch.cuda.synchronize()
    assert (runner.eager_steps, runner.captures, runner.replays) == (1, 1, 3)
    assert [w.launches - b for w, b in zip(counters, before)] == \
        [4 * n for n in one] and sum(one) > 0
    for (name, g), (_, w) in zip(step_mod.tensor_leaves(got),
                                 step_mod.tensor_leaves(want)):
        if layout == "hybrid":
            torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-5,
                                       msg=name)
        else:
            assert torch.equal(g, w), name
    runner.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("layout,precision", [
    ("dense", "highest"), ("dense", "default"), ("segment-chunked", "highest"),
    ("hybrid", "highest"), ("hybrid", "default")])
def test_card_sharded_replay_equals_loop(tmp_path, rng, layout, precision):
    """On the card, a sharded run over a world of one joined through a
    file rendezvous (NCCL): ShardedRun.multi_step makes one eager step,
    captures one step with its all-reduces and replays it; after 4 steps
    the state is the loop's bit for bit, each replay adds one step's
    launches to the counts, and close() drops the graph before the group
    is destroyed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs, NCCL and the kernels "
                    "have no CPU mode")
    import torch.distributed as dist
    from hgaprec_tpu_torch.parallel import distributed
    from hgaprec_tpu_torch.parallel.sharded import build_sharded_run
    js, _, _ = make_synthetic(rng, n=300, m=200, density=0.2)
    cfg = TCfg(n=js.n, m=js.m, k=20, variant="hpf", matmul_precision=precision,
               **CARD_LAYOUTS[layout])
    store = port_store(js)
    distributed.initialize_from_env(
        "cuda", init_method="file://" + str(tmp_path / "pg"), world_size=1,
        rank=0)
    try:
        assert dist.get_backend() == "nccl"
        loop = build_sharded_run(store, cfg, dist.group.WORLD, "cuda", seed=3)
        loop.runner = make_multi_step(cfg, graph=False)
        run = build_sharded_run(store, cfg, dist.group.WORLD, "cuda", seed=3)
        assert _resolve_mode(run.cfg, run.data) == layout
        assert run.runner.replays_on(run.state, run.group)
        loop.multi_step(4)
        counters = (df.fused_dense_sweep, tf.fused_half_sweep,
                    sf.fused_segment_sweep)
        before = [w.launches for w in counters]
        run.multi_step(1)
        one = [w.launches - b for w, b in zip(counters, before)]
        run.multi_step(3)
        torch.cuda.synchronize()
        runner = run.runner
        assert (runner.eager_steps, runner.captures, runner.replays) == \
            (1, 1, 3)
        assert [w.launches - b for w, b in zip(counters, before)] == \
            [4 * n for n in one] and sum(one) > 0
        for (name, g), (_, w) in zip(step_mod.tensor_leaves(run.state),
                                     step_mod.tensor_leaves(loop.state)):
            assert torch.equal(g, w), name
        run.close()
        assert runner.graph is None
    finally:
        dist.destroy_process_group()
