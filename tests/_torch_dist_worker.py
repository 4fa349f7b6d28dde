"""One rank of the port's sharded tests (tests/test_torch_sharded.py,
tests/test_torch_sharded_graph.py).

    python _torch_dist_worker.py RANK WORLD WORKDIR

Joins a gloo process group through `WORKDIR/pg` (a file:// rendezvous),
runs every task of `WORKDIR/tasks.json` in order on the CPU and writes
each task's result as `WORKDIR/<name>.rank<RANK>.npz`. Stores come from
`WORKDIR/<store>.npz` (the COO of a seeded synthetic store, built by the
test with the JAX package's generator). Imports the port only.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from hgaprec_tpu_torch.config import ModelConfig, RunConfig
from hgaprec_tpu_torch.data.ratings import RatingsStore
from hgaprec_tpu_torch.eval.score import Scorer
from hgaprec_tpu_torch.models import step as step_mod
from hgaprec_tpu_torch.models.state import state_to_numpy
from hgaprec_tpu_torch.models.step import (GraphMultiStep, _resolve_mode,
                                           captures_collectives)
from hgaprec_tpu_torch.parallel import distributed
from hgaprec_tpu_torch.parallel.sharded import (build_sharded_run,
                                                sharded_masked_topk)


def load_store(workdir, name, per_rank=False):
    """The store of `WORKDIR/<name>.npz`; with `per_rank`, only this
    rank's user rows, as load_dataset(user_rows=host_user_rows) ingests
    them."""
    z = np.load(os.path.join(workdir, f"{name}.npz"))
    n, m = int(z["n"]), int(z["m"])
    store = RatingsStore(n, m)
    store.user2seq = {u: u for u in range(n)}
    store.seq2user = dict(store.user2seq)
    store.movie2seq = {i: i for i in range(m)}
    store.seq2movie = dict(store.movie2seq)
    store._u, store._i, store._y = (z["u"].tolist(), z["i"].tolist(),
                                    z["y"].tolist())
    if per_rank:
        store._restrict_users(distributed.host_user_rows)
    store.finalize()
    return store


def maps(rows):
    return {(int(u), int(i)): int(y) for u, i, y in rows}


def task_step(task, workdir):
    """build_sharded_run, `steps` steps (or one multi_step), then the
    gathered state."""
    store = load_store(workdir, task["store"])
    cfg = ModelConfig(n=store.n, m=store.m, **task["cfg"])
    run = build_sharded_run(store, cfg, dist.group.WORLD, "cpu",
                            seed=task["seed"])
    if task.get("multi"):
        run.multi_step(task["steps"])
    else:
        for _ in range(task["steps"]):
            run.step()
    out = state_to_numpy(run.unsharded_state())
    out["layout"] = np.asarray([run.data.dense_y is not None,
                                run.data.head_dense_y is not None,
                                run.data.tail is not None])
    out["mode"] = np.asarray(_resolve_mode(run.cfg, run.data))
    out["n_local"] = np.asarray(run.n_local)
    return out


def task_topk(task, workdir):
    """sharded_masked_topk over the world and over a one-rank group."""
    z = np.load(os.path.join(workdir, f"{task['name']}.in.npz"))
    bias = "bu" in z.files
    sc = Scorer(torch.from_numpy(z["su"]), torch.from_numpy(z["sv"]),
                torch.from_numpy(z["bu"]) if bias else None,
                torch.from_numpy(z["bi"]) if bias else None)
    vals, ids = sharded_masked_topk(sc, dist.group.WORLD, z["users"],
                                    z["mask"], k=task["k"])
    solo = dist.new_group([0])
    out = dict(vals=vals, ids=ids)
    if dist.get_rank() == 0:
        out["vals1"], out["ids1"] = sharded_masked_topk(
            sc, solo, z["users"], z["mask"], k=task["k"])
    return out


def task_elbo(task, workdir):
    """Trainer.logl on a sharded run after `steps` sharded steps (the
    report's collective), and the gathered state it was taken on."""
    from hgaprec_tpu_torch.models.engine import Trainer
    store = load_store(workdir, task["store"], per_rank=task["per_rank"])
    cfg = ModelConfig(n=store.n, m=store.m, **task["cfg"])
    rcfg = RunConfig(datdir=workdir,
                     outdir=os.path.join(workdir, task["name"]), logl=True)
    tr = Trainer(store, {}, {}, cfg, rcfg, device="cpu", build_data=False)
    try:
        tr.shard(dist.group.WORLD)
        tr.sharded.multi_step(task["steps"])
        tr.state = tr.sharded.unsharded_state()
        elbo = tr.logl()
    finally:
        tr.close()
    with open(os.path.join(tr.outdir, "logl.txt")) as f:
        logl_txt = f.read()
    return dict(state_to_numpy(tr.state), elbo=np.asarray(elbo),
                logl_txt=np.asarray(logl_txt))


def task_report(task, workdir):
    """The Trainer's sharded loop through reports on a per-rank store,
    with the training ELBO, and every collective call recorded (op and
    shapes) in order."""
    from hgaprec_tpu_torch.models.engine import Trainer
    store = load_store(workdir, task["store"], per_rank=True)
    cfg = ModelConfig(n=store.n, m=store.m, **task["cfg"])
    rcfg = RunConfig(datdir=workdir, outdir=os.path.join(workdir, "report"),
                     rfreq=task["rfreq"], max_iterations=task["iters"],
                     num_precision_users=10, logl=True)
    tr = Trainer(store, maps(task["validation"]), maps(task["test"]), cfg,
                 rcfg, device="cpu", build_data=False)
    calls = []
    real = {f: getattr(dist, f) for f in ("all_reduce", "all_gather")}

    def spy(name):
        def wrapped(*args, **kw):
            shapes = [tuple(a.shape) if torch.is_tensor(a) else
                      [tuple(t.shape) for t in a] for a in args]
            calls.append(f"{name}{shapes}")
            return real[name](*args, **kw)
        return wrapped

    for f in real:
        setattr(dist, f, spy(f))
    try:
        tr.shard(dist.group.WORLD)
        tr.run()
    finally:
        for f, fn in real.items():
            setattr(dist, f, fn)
        tr.close()
    return dict(calls=np.asarray(calls), primary=np.asarray(tr.primary),
                outdir=np.asarray(tr.outdir))


class FakeGraph:
    """A capture object for the CPU (tests/test_torch_multistep.py's):
    `capture` runs the step's Python, its collectives included, as a CUDA
    capture records them, and puts the state back (a capture runs no
    kernel); `replay` runs the step again and takes back the launches the
    kernel wrappers counted (a replay runs no Python)."""
    made = 0

    def __init__(self, device):
        self.fn = None
        self.replays = 0
        FakeGraph.made += 1

    def capture(self, fn):
        state = fn.args[0]
        leaves = [t for _, t in step_mod.tensor_leaves(state)]
        saved = [t.clone() for t in leaves]
        fn()
        for t, s in zip(leaves, saved):
            t.copy_(s)
        self.fn = fn

    def replay(self):
        self.replays += 1
        before = step_mod._launch_counts()
        self.fn()
        step_mod._add_launches(step_mod._launches_since(before), -1)


def replaying(cfg):
    """A runner with the fake graph whose injected predicate stands for
    the card's NCCL check: it replays over this gloo group on the CPU."""
    return GraphMultiStep(cfg, new_graph=FakeGraph,
                          capturable=lambda state, group: True)


def counts(runner):
    return np.asarray([runner.eager_steps, runner.captures, runner.replays])


def task_graph(task, workdir):
    """`steps` sharded iterations through ShardedRun.multi_step in two
    calls, replayed by the group-aware runner (fake graph, injected
    predicate), and the same steps on the run's default runner, which
    takes the loop here; both gathered states, the counts."""
    store = load_store(workdir, task["store"])
    cfg = ModelConfig(n=store.n, m=store.m, **task["cfg"])
    group = dist.group.WORLD
    steps, first = task["steps"], task["steps"] // 2
    loop = build_sharded_run(store, cfg, group, "cpu", seed=task["seed"])
    loop.multi_step(first)
    loop.multi_step(steps - first)
    FakeGraph.made = 0
    run = build_sharded_run(store, cfg, group, "cpu", seed=task["seed"])
    run.runner = replaying(run.cfg)
    run.multi_step(first)
    run.multi_step(steps - first)
    out = {f"replay:{k}": v
           for k, v in state_to_numpy(run.unsharded_state()).items()}
    out.update({f"loop:{k}": v
                for k, v in state_to_numpy(loop.unsharded_state()).items()})
    out["counts"] = counts(run.runner)
    out["loop_counts"] = counts(loop.runner)
    out["graphs"] = np.asarray([FakeGraph.made, run.runner.graph.replays])
    out["layout"] = np.asarray([run.data.dense_y is not None,
                                run.data.head_dense_y is not None,
                                run.data.tail is not None])
    out["mode"] = np.asarray(_resolve_mode(run.cfg, run.data))
    run.close()
    out["closed"] = np.asarray([run.runner.graph is None,
                                run.runner._held is None])
    return out


def task_graph_keys(task, workdir):
    """What makes the runner capture anew (a new row mask, a new group, a
    state tensor at a new address), what close() drops, that a gloo
    group with no injected predicate makes no graph, and that
    Trainer.close drops a sharded run's graph while the group is still
    held."""
    from hgaprec_tpu_torch.models.engine import Trainer
    store = load_store(workdir, task["store"])
    cfg = ModelConfig(n=store.n, m=store.m, **task["cfg"])
    world = dist.group.WORLD
    out = {}
    # the default runner over gloo: the loop, no graph
    FakeGraph.made = 0
    plain = build_sharded_run(store, cfg, world, "cpu", seed=task["seed"])
    plain.runner.new_graph = FakeGraph
    out["gloo_replays_on"] = np.asarray(
        [plain.runner.replays_on(plain.state, world),
         captures_collectives(world), captures_collectives(None)])
    plain.multi_step(7)
    out["gloo_counts"] = np.append(counts(plain.runner), FakeGraph.made)
    out.update({f"loop:{k}": v for k, v in
                state_to_numpy(plain.unsharded_state()).items()})
    # the replaying runner: a capture at each change of what it holds
    run = build_sharded_run(store, cfg, world, "cpu", seed=task["seed"])
    run.runner = replaying(run.cfg)
    seen = []
    run.multi_step(2)
    seen.append(counts(run.runner))
    run.row_mask = run.row_mask.clone()
    run.multi_step(1)
    seen.append(counts(run.runner))
    run.group = dist.new_group(list(range(dist.get_world_size())))
    run.multi_step(2)
    seen.append(counts(run.runner))
    theta = dataclasses.replace(run.state.theta, e=run.state.theta.e.clone())
    run.state = dataclasses.replace(run.state, theta=theta)
    run.multi_step(1)
    seen.append(counts(run.runner))
    run.close()
    out["closed"] = np.asarray([run.runner.graph is None,
                                run.runner._held is None])
    run.multi_step(1)
    seen.append(counts(run.runner))
    out["seen"] = np.stack(seen)
    out.update({f"replay:{k}": v for k, v in
                state_to_numpy(run.unsharded_state()).items()})
    run.close()
    # the Trainer: close() drops the graph while it still holds the group
    rcfg = RunConfig(datdir=workdir, outdir=os.path.join(workdir, "gk"),
                     rfreq=2, max_iterations=4,
                     enforce_max_iterations=True)
    tr = Trainer(store, {}, {}, cfg, rcfg, device="cpu", build_data=False)
    held = []
    try:
        tr.shard(world)
        runner = tr.sharded.runner = replaying(cfg)
        tr.run()
        out["trainer_counts"] = counts(runner)
        real_reset = runner.reset

        def spy():
            held.append(tr.sharded is not None and
                        tr.eval_group is not None)
            real_reset()
        runner.reset = spy
    finally:
        tr.close()
    out["close_dropped"] = np.asarray([runner.graph is None] + held)
    return out


TASKS = {"step": task_step, "topk": task_topk, "report": task_report,
         "elbo": task_elbo, "graph": task_graph,
         "graph_keys": task_graph_keys}


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    distributed.initialize_from_env(
        "cpu", init_method="file://" + os.path.join(workdir, "pg"),
        world_size=world, rank=rank)
    with open(os.path.join(workdir, "tasks.json")) as f:
        tasks = json.load(f)
    for task in tasks:
        out = TASKS[task["kind"]](task, workdir)
        np.savez(os.path.join(workdir, f"{task['name']}.rank{rank}.npz"),
                 **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
