"""Training loop: CAVI iterations + reporting cadence + stopping + contract.

Port of `hgaprec_tpu/models/engine.py`. It keeps the reference's
operational envelope:

  * per-run output directory named from the config (env.hh:283-369),
    containing param.txt, infer.log, validation.txt, test.txt,
    precision.txt, max.txt, byusers.tsv/byitems.tsv, model TSVs and
    model.npz, ranking.tsv and itemrank.tsv.
  * reporting every rfreq iterations at pre-increment counter 0, 10, ...
    (hgaprec.cc:962-971): validation + test likelihood, save_model,
    precision over freshly sampled users, itemrank (only at iter%100==0).
  * stopping rule (hgaprec.cc:1476-1491): after iter 30, stop when the
    validation likelihood's relative improvement < 1e-6 (why=0) or after
    3 consecutive decreases (why=1); then do_on_stop(): save model +
    write the full ranking for test_users.tsv if present (hgaprec.cc:
    1572-1577, 2087-2112).
  * SIGTERM sets a flag polled at every report boundary.
  * -logl: the training ELBO into logl.txt at every report, after the
    ranking reports (hgaprec_tpu/models/engine.py:406-412); in a sharded
    run every rank sums its own shard's nonzeros and the sums are
    all-reduced.
  * RMSE (rmse.txt, test_scores.tsv) and MSR (pred.csv) on the loaded or
    trained model, for the CLI's -rmse and -msr modes.
  * -trace DIR: training runs under torch.profiler with a TensorBoard
    trace handler (the port's counterpart of jax.profiler.trace).

In a sharded run (`Trainer.shard`, parallel/sharded.py) every rank
holds a Trainer and runs the same loop with its share of the step: at a
report boundary the state is gathered and a SIGTERM agreed over the
group, and all ranks run the same eval and stopping code on the gathered
state (the decisions are deterministic on it, so the ranks stay in
lockstep) and join the item-sharded top-k through `eval_group`; only the
primary (rank 0) writes the output-file contract, the others write their
report files into `.proc{rank}` under it.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from hgaprec_tpu_torch.config import (ModelConfig, RunConfig,
                                      set_matmul_precision)
from hgaprec_tpu_torch.data.device import DeviceData, build_device_data
from hgaprec_tpu_torch.data.ratings import (CountMap, RatingsStore,
                                            leave_one_out_map,
                                            validation_users_of_movie)
from hgaprec_tpu_torch.eval import ranking as rank_mod
from hgaprec_tpu_torch.eval.ranking import EvalIndex
from hgaprec_tpu_torch.eval.score import pair_loglik, scorer_from_state
from hgaprec_tpu_torch.io import checkpoint as ckpt
from hgaprec_tpu_torch.models.elbo import (training_elbo, training_gamma,
                                           training_nonzero_sum)
from hgaprec_tpu_torch.models.state import (ModelState, init_state,
                                            state_to_numpy)
from hgaprec_tpu_torch.models.step import make_multi_step, make_step
from hgaprec_tpu_torch.parallel import distributed, sharded


def _pairs_tensors(cmap: CountMap, device):
    pairs = sorted(cmap.keys())
    u = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=device)
    i = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=device)
    y = torch.tensor([cmap[p] for p in pairs], dtype=torch.float32,
                     device=device)
    return u, i, y


class Trainer:
    """The trainer of one device. `device` is required: the run happens
    where the caller says, never on a device picked behind its back.

    `primary` (default: rank 0 of the default process group, or True
    without one) writes the output files; `build_data=False` builds no
    single-device layout (the sharded loop builds each rank's shard
    itself, and a per-rank store holds only that rank's rows)."""

    def __init__(self, store: RatingsStore, validation: CountMap,
                 test: CountMap, mcfg: ModelConfig, rcfg: RunConfig,
                 device, device_data: Optional[DeviceData] = None,
                 primary: Optional[bool] = None, build_data: bool = True):
        self.device = torch.device(device)
        set_matmul_precision(mcfg.matmul_precision)
        self.store = store
        self.validation = validation
        self.test = test
        self.mcfg = mcfg
        self.rcfg = rcfg
        self.primary = distributed.is_primary() if primary is None \
            else primary
        self.shared_outdir = rcfg.resolve_outdir(mcfg)
        self.outdir = self.shared_outdir
        if not self.primary:
            self.outdir = os.path.join(self.shared_outdir,
                                       f".proc{distributed.rank()}")
        os.makedirs(self.outdir, exist_ok=True)
        # set by shard(): the group the ranking eval's items are sharded
        # over (every rank joins the top-k collective), and this rank's
        # share of the sharded step
        self.eval_group = None
        self.sharded: Optional[sharded.ShardedRun] = None
        # the evaluated users' rows gathered from a per-rank store
        self._view: Optional[tuple] = None
        if device_data is not None:
            self.data = device_data
        elif not build_data:
            self.data = None
        else:
            # the JAX package's layout decision (engine.py:96-116):
            # catalogs too wide to densify get the hybrid head/tail layout
            # under "auto"; an explicit "hybrid" always builds the head.
            # No head fits the byte budget -> COO only, and _resolve_mode
            # then picks the segment sweep.
            will_densify = store.n * store.m <= mcfg.dense_limit_bytes
            head = (mcfg.hybrid_head_items if mcfg.sweep == "hybrid" or
                    (mcfg.sweep == "auto" and not will_densify) else 0)
            self.data = build_device_data(
                store, self.device, hybrid_head_items=head,
                dense_limit_bytes=mcfg.dense_limit_bytes,
                head_limit_bytes=mcfg.head_limit_bytes)
        self.step = make_step(mcfg)
        self.multi_step = make_multi_step(mcfg)
        self.state: ModelState = init_state(mcfg, seed=rcfg.seed,
                                            device=self.device)
        self.iteration = 0
        self.start_time = time.time()
        self.index = EvalIndex(validation, test, store)
        self.leave_one_out = leave_one_out_map(test)
        self.val_users_of_movie = validation_users_of_movie(validation)
        self._val_pairs = _pairs_tensors(validation, self.device)
        self._test_pairs = _pairs_tensors(test, self.device)
        self._prev_h = 0.0
        self._nh = 0
        self._stop_requested = False
        self._sigterm = False
        self._on_stop_done = False
        self._rng = np.random.default_rng(
            (rcfg.seed or 0) + 1000003)  # eval sampling stream
        self._sampled_users: Optional[np.ndarray] = None
        self._save_thread: Optional[threading.Thread] = None
        self._files: Dict[str, object] = {}
        self._open_outputs()
        if self.primary:
            self._write_param_txt()
            # the marginals need every user's nonzeros
            if rcfg.write_marginals and store.local_user_rows is None:
                store.write_marginal_distributions(self.outdir)

    # -- plumbing ----------------------------------------------------------
    def _open_outputs(self):
        # reference opens all of these up front (hgaprec.cc:40-75)
        for name in ("heldout.txt", "validation.txt", "test.txt", "logl.txt",
                     "precision.txt", "ndcg.txt", "rmse.txt", "infer.log"):
            self._files[name] = open(os.path.join(self.outdir, name), "w")

    def close(self):
        self._join_save()
        for f in self._files.values():
            f.close()
        self._files = {}

    def log(self, msg: str):
        f = self._files.get("infer.log")
        if f:
            f.write(msg + "\n")
            f.flush()

    def _write_param_txt(self):
        m, r = self.mcfg, self.rcfg
        with open(os.path.join(self.outdir, "param.txt"), "w") as f:
            # key: value lines like Env::plog (env.hh:375-402)
            f.write(f"n: {m.n}\nk: {m.k}\nt: 2\n")
            f.write("test_ratio: 0.2\nvalidation_ratio: 0.01\n")
            f.write(f"seed: {r.seed}\n")
            f.write(f"a: {m.a}\nb: {m.b}\nc: {m.c}\nd: {m.d}\n")
            f.write(f"reportfreq: {r.rfreq}\n")
            f.write(f"vb: {int(m.vb)}\nbias: {int(m.bias)}\n")
            f.write(f"hier: {int(m.hier)}\n")
            f.write(f"binary_data: {int(m.binary)}\n")
            f.write(f"variant: {m.variant}\n")
            f.write(f"rating_threshold: {r.rating_threshold}\n")
            f.write(f"max_iterations: {r.max_iterations}\n")

    def scorer(self):
        return scorer_from_state(self.state, self.mcfg)

    def duration(self) -> int:
        return int(time.time() - self.start_time)

    def install_sigterm(self):
        signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):
        # a sharded run's ranks stop together, at a report boundary
        if self.sharded is None:
            self._stop_requested = True
        self._sigterm = True

    def shard(self, group):
        """Train sharded over user rows across `group` (every rank calls
        it, and then run()): this rank builds its own shard and starts
        from its rows of the current state (the initial draw, or a
        resumed model); the ranking eval's items are sharded over the
        group."""
        self.eval_group = group
        self.sharded = sharded.build_sharded_run(
            self.store, self.mcfg, group, self.device,
            arrays=state_to_numpy(self.state))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- likelihood + stopping (hgaprec.cc:1439-1501) ----------------------
    def compute_likelihood(self, validation: bool) -> float:
        u, i, y = self._val_pairs if validation else self._test_pairs
        k = int(u.shape[0])
        if k == 0:
            return 0.0
        total, _ = pair_loglik(self.scorer(), u, i, y, self.mcfg.binary)
        a = float(total) / k
        fname = "validation.txt" if validation else "test.txt"
        f = self._files[fname]
        f.write(f"{self.iteration}\t{self.duration()}\t{a:.9f}\t{k}\n")
        f.flush()
        if not validation:
            return a
        stop, why = False, -1
        if self.iteration > 30:
            if (a > self._prev_h and self._prev_h != 0 and
                    abs((a - self._prev_h) / self._prev_h) < 1e-6):
                stop, why = True, 0
            elif a < self._prev_h:
                self._nh += 1
            elif a > self._prev_h:
                self._nh = 0
            if self._nh > 2:
                stop, why = True, 1
        self._prev_h = a
        with open(os.path.join(self.outdir, "max.txt"), "w") as f:
            f.write(f"{self.iteration}\t{self.duration()}\t{a:.5f}\t{why}\n")
        if stop:
            self.do_on_stop()
            self._stop_requested = True
        return a

    def do_on_stop(self):
        """save_model + gen_ranking_for_users(false) (hgaprec.cc:1572-1577)."""
        self._on_stop_done = True
        self.save_model()
        self.gen_ranking_for_users(load=False)

    # -- model io ----------------------------------------------------------
    def _join_save(self):
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None

    def save_model(self):
        """Snapshot to host, write files on a background thread.

        The host copy is owning and complete before this returns: the next
        step rewrites the state's device tensors in place. The file writes
        (the reference blocks its loop on them every rfreq, hgaprec.cc:966)
        overlap the next training chunk. Only the primary writes."""
        if not self.primary:
            return
        arrays = state_to_numpy(self.state)
        iteration = self.iteration
        self._join_save()

        def write():
            ckpt.save_model_tsv(self.outdir, arrays, self.mcfg,
                                self.store.seq2user, self.store.seq2movie)
            ckpt.save_npz(os.path.join(self.outdir, "model.npz"), arrays,
                          iteration)

        self._save_thread = threading.Thread(target=write, daemon=True)
        self._save_thread.start()

    def load_model(self, indir: Optional[str] = None):
        """The npz checkpoint in `indir` (default: the shared output
        directory, which the primary wrote) with its iteration, else the
        model TSVs there into the current state (engine.py:271-280)."""
        self._join_save()   # don't read files an in-flight save is writing
        indir = indir or self.shared_outdir
        npz = os.path.join(indir, "model.npz")
        if os.path.exists(npz):
            self.state, self.iteration = ckpt.load_npz(npz, self.mcfg,
                                                       self.device)
        else:
            self.state = ckpt.load_model_tsv(indir, self.mcfg, self.state)

    # -- eval wrappers -----------------------------------------------------
    def _eval_store(self, users: np.ndarray, gather: bool = True):
        """The store the ranking eval reads for `users`. A per-rank store
        of a sharded run holds only this rank's users, so theirs are
        gathered from every rank (a collective: `gather` is False on the
        primary's own paths, which reuse the gather of the report's
        precision for the same users)."""
        if self.store.local_user_rows is None or self.eval_group is None:
            return self.store
        if self._view is None or self._view[0] is not users:
            if not gather:
                raise RuntimeError("the evaluated users' rows were not "
                                   "gathered on every rank")
            self._view = (users, sharded.user_view(
                self.store, users, self.eval_group, self.device))
        return self._view[1]

    def compute_precision(self, save_ranking: bool):
        """One precision report (hgaprec.cc:1703-1848).

        User selection parity: on saving reports (every 100 iters) the
        reference REUSES `_sampled_users` from the previous non-saving
        report (hgaprec.cc:1715-1721 only resamples when
        !save_ranking_file); test_users.tsv enters only through
        gen_ranking_for_users."""
        if self.iteration % 100 == 0 and self.iteration > 0:
            save_ranking = True
        if not save_ranking or self._sampled_users is None:
            self._sampled_users = rank_mod.sample_users(
                self._rng, self.store.n, self.rcfg.num_precision_users)
        path = os.path.join(self.outdir, "ranking.tsv") \
            if save_ranking and self.primary else None
        # with eval_group every rank joins the item-sharded top-k; only
        # the primary's report is the output contract
        return rank_mod.compute_precision(
            self.scorer(), self._eval_store(self._sampled_users),
            self.index, self._sampled_users,
            self._files["precision.txt"] if self.primary else None, path,
            self.rcfg.topn_by_user, self.eval_group)

    def compute_itemrank(self, final: bool):
        if not self.primary:
            return None   # no collective: the primary's work alone
        if self.iteration % 100 == 0 and self.iteration > 0:
            final = True
        if not final or self._sampled_users is None:
            return None
        return rank_mod.compute_itemrank(
            self.scorer(), self._eval_store(self._sampled_users, False),
            self.index, self._sampled_users, self.outdir)

    def gen_ranking_for_users(self, load: bool):
        """hgaprec.cc:2087-2112: rank for users in test_users.tsv."""
        if load:
            self.load_model()
        tu_path = os.path.join(self.rcfg.datdir, "test_users.tsv")
        if not os.path.exists(tu_path):
            self.log(f"cannot open {tu_path}")
            return
        users = self.store.read_test_users(tu_path)
        if users.size == 0:
            return
        self._sampled_users = users
        if self.primary or self.eval_group is not None:
            rank_mod.compute_precision(
                self.scorer(), self._eval_store(users), self.index, users,
                self._files["precision.txt"] if self.primary else None,
                (os.path.join(self.outdir, "ranking.tsv")
                 if self.primary else None),
                self.rcfg.topn_by_user, self.eval_group)
        if self.primary:
            rank_mod.compute_itemrank(self.scorer(),
                                      self._eval_store(users, False),
                                      self.index, users, self.outdir)

    def compute_rmse(self) -> float:
        return rank_mod.compute_rmse(self.scorer(), self.test,
                                     self.outdir, self._files["rmse.txt"])

    def gen_msr_csv(self):
        rank_mod.gen_msr_csv(self.scorer(), self.store, self.index,
                             self.leave_one_out, self.val_users_of_movie,
                             self.outdir)

    def logl(self) -> float:
        """Write the training ELBO to logl.txt (engine.py:356-366).

        In a sharded run it is a collective, called by every rank at a
        report: each rank sums the nonzero terms of its own shard (local
        user ids; padding entries add nothing), the sums are all-reduced
        in f64 over `eval_group`, and the Gamma terms are taken from the
        gathered state the report holds, so every rank has the same
        value."""
        if self.sharded is not None:
            run = self.sharded
            part = training_nonzero_sum(run.state, run.data, self.mcfg)
            s = float(sharded.all_reduce(part, self.eval_group) +
                      training_gamma(self.state, self.mcfg))
        elif self.data is None:
            # a per-process store of a rank that does not train holds only
            # its own rows: the ELBO of every row is out of its reach
            self.log("logl skipped: no single-device data (sharded run)")
            return 0.0
        else:
            s = training_elbo(self.state, self.data, self.mcfg)
        f = self._files["logl.txt"]
        f.write(f"{s:.5f}\n")
        f.flush()
        return s

    # -- main loop ---------------------------------------------------------
    def next_chunk(self, cap: Optional[int]):
        """(n_steps, bound) to reach the next report boundary — the next
        multiple of rfreq (reference reporting cadence, hgaprec.cc:962),
        clipped at the iteration cap."""
        rfreq = max(self.rcfg.rfreq, 1)
        bound = -(-self.iteration // rfreq) * rfreq
        if cap is not None:
            bound = min(bound, cap)
        return bound - self.iteration + 1, bound

    def resolve_cap(self) -> Optional[int]:
        """Iteration cap: vb_hier honors max_iterations (hgaprec.cc:
        1336-1339); the other variants run until the stopping rule unless
        enforce_max_iterations is set."""
        if self.mcfg.hier or self.rcfg.enforce_max_iterations:
            return self.rcfg.max_iterations
        return None

    def report(self):
        # every rank: the validation likelihood drives the stopping rule
        self.compute_likelihood(True)
        if self._stop_requested:
            return
        if self.primary:
            self.compute_likelihood(False)
            if not self.mcfg.mle:
                self.save_model()
        # with eval_group, precision is a collective: every rank calls it
        if self.primary or self.eval_group is not None:
            self.compute_precision(False)
        if self.primary:
            if (self.mcfg.variant in ("bpf", "hpf", "canny")
                    and not self.mcfg.bias):
                # reference: vb/vb_hier/vb_canny also run itemrank
                self.compute_itemrank(False)
        # a sharded run's ELBO is a collective: every rank calls it
        if self.rcfg.logl and (self.primary or self.sharded is not None):
            self.logl()

    def run(self, max_iters: Optional[int] = None) -> ModelState:
        """Train until the stopping rule fires (or an iteration cap).

        With rcfg.trace_dir set, the whole loop runs under torch.profiler
        (host ops, and the card's kernels on a CUDA device) and the trace
        is written to that directory as `*.pt.trace.json` for TensorBoard
        (engine.py:414-424 runs jax.profiler.trace there)."""
        if not self.rcfg.trace_dir:
            return self._run_loop(max_iters)
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities, on_trace_ready=
                     tensorboard_trace_handler(self.rcfg.trace_dir)):
            return self._run_loop(max_iters)

    def _gather(self):
        """A sharded run's report boundary: the whole state on every rank
        (the same gathers on every rank, since a report may save), and a
        SIGTERM taken by all ranks if any rank got one."""
        run = self.sharded
        self.state = run.unsharded_state()
        flag = torch.tensor([float(self._sigterm)], device=self.device)
        if sharded.all_reduce(flag, run.group,
                              dist.ReduceOp.MAX)[0] > 0:
            self._stop_requested = True

    def _run_loop(self, max_iters: Optional[int] = None) -> ModelState:
        cap = max_iters if max_iters is not None else self.resolve_cap()
        last_report = (time.time(), 0)
        while True:
            if cap is not None and self.iteration > cap:
                break
            # every iteration up to the next report boundary back to back,
            # with no host round trip in between
            n_steps, bound = self.next_chunk(cap)
            if self.sharded is not None:
                self.sharded.multi_step(n_steps)
            elif n_steps > 1:
                self.state = self.multi_step(self.state, self.data, n_steps)
            else:
                self.state = self.step(self.state, self.data)
            self.iteration = bound
            if self.iteration % self.rcfg.rfreq == 0:
                self._sync()
                now = time.time()
                t0, it0 = last_report
                if self.iteration > it0:
                    rate = (self.iteration - it0) / max(now - t0, 1e-9)
                    self.log(f"iteration {self.iteration}: "
                             f"{rate:.1f} iters/s")
                last_report = (now, self.iteration)
                if self.sharded is not None:
                    self._gather()
                self.report()
            if self._stop_requested:
                self.log(f"stopping at iteration {self.iteration} "
                         f"duration {self.duration()}s")
                break
            self.iteration += 1
        if self.sharded is not None:
            self.state = self.sharded.unsharded_state()
        # reference exits via do_on_stop on max_iterations (hgaprec.cc:
        # 1336-1339) and SIGTERM (973-976), not just on convergence
        if not self._on_stop_done:
            self.do_on_stop()
        self._join_save()   # checkpoint files complete when run() returns
        return self.state
