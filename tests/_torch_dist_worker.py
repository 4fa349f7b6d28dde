"""One rank of the port's sharded tests (tests/test_torch_sharded.py).

    python _torch_dist_worker.py RANK WORLD WORKDIR

Joins a gloo process group through `WORKDIR/pg` (a file:// rendezvous),
runs every task of `WORKDIR/tasks.json` in order on the CPU and writes
each task's result as `WORKDIR/<name>.rank<RANK>.npz`. Stores come from
`WORKDIR/<store>.npz` (the COO of a seeded synthetic store, built by the
test with the JAX package's generator). Imports the port only.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from hgaprec_tpu_torch.config import ModelConfig, RunConfig
from hgaprec_tpu_torch.data.ratings import RatingsStore
from hgaprec_tpu_torch.eval.score import Scorer
from hgaprec_tpu_torch.models.state import state_to_numpy
from hgaprec_tpu_torch.models.step import _resolve_mode
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


def task_report(task, workdir):
    """The Trainer's sharded loop through reports on a per-rank store,
    with every collective call recorded (op and shapes) in order."""
    from hgaprec_tpu_torch.models.engine import Trainer
    store = load_store(workdir, task["store"], per_rank=True)
    cfg = ModelConfig(n=store.n, m=store.m, **task["cfg"])
    rcfg = RunConfig(datdir=workdir, outdir=os.path.join(workdir, "report"),
                     rfreq=task["rfreq"], max_iterations=task["iters"],
                     num_precision_users=10)
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


TASKS = {"step": task_step, "topk": task_topk, "report": task_report}


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
