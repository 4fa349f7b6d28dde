"""Training loop: CAVI iterations + reporting cadence + stopping + contract.

Port of `hgaprec_tpu/models/engine.py` for one process and one device.
It keeps the reference's operational envelope:

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
    ranking reports (hgaprec_tpu/models/engine.py:406-412).
  * RMSE (rmse.txt, test_scores.tsv) and MSR (pred.csv) on the loaded or
    trained model, for the CLI's -rmse and -msr modes.
  * -trace DIR: training runs under torch.profiler with a TensorBoard
    trace handler (the port's counterpart of jax.profiler.trace).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

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
from hgaprec_tpu_torch.models.elbo import training_elbo
from hgaprec_tpu_torch.models.state import (ModelState, init_state,
                                            state_to_numpy)
from hgaprec_tpu_torch.models.step import make_multi_step, make_step


def _pairs_tensors(cmap: CountMap, device):
    pairs = sorted(cmap.keys())
    u = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=device)
    i = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=device)
    y = torch.tensor([cmap[p] for p in pairs], dtype=torch.float32,
                     device=device)
    return u, i, y


class Trainer:
    """Single-device trainer. `device` is required: the run happens where
    the caller says, never on a device picked behind its back."""

    def __init__(self, store: RatingsStore, validation: CountMap,
                 test: CountMap, mcfg: ModelConfig, rcfg: RunConfig,
                 device, device_data: Optional[DeviceData] = None):
        self.device = torch.device(device)
        set_matmul_precision(mcfg.matmul_precision)
        self.store = store
        self.validation = validation
        self.test = test
        self.mcfg = mcfg
        self.rcfg = rcfg
        self.outdir = rcfg.resolve_outdir(mcfg)
        os.makedirs(self.outdir, exist_ok=True)
        if device_data is not None:
            self.data = device_data
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
        self._on_stop_done = False
        self._rng = np.random.default_rng(
            (rcfg.seed or 0) + 1000003)  # eval sampling stream
        self._sampled_users: Optional[np.ndarray] = None
        self._save_thread: Optional[threading.Thread] = None
        self._files: Dict[str, object] = {}
        self._open_outputs()
        self._write_param_txt()
        if rcfg.write_marginals:
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
        self._stop_requested = True

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
        overlap the next training chunk."""
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
        """The npz checkpoint in `indir` (default: the output directory)
        with its iteration, else the model TSVs there into the current
        state (engine.py:271-280)."""
        self._join_save()   # don't read files an in-flight save is writing
        indir = indir or self.outdir
        npz = os.path.join(indir, "model.npz")
        if os.path.exists(npz):
            self.state, self.iteration = ckpt.load_npz(npz, self.mcfg,
                                                       self.device)
        else:
            self.state = ckpt.load_model_tsv(indir, self.mcfg, self.state)

    # -- eval wrappers -----------------------------------------------------
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
        path = os.path.join(self.outdir, "ranking.tsv") if save_ranking \
            else None
        return rank_mod.compute_precision(
            self.scorer(), self.store, self.index, self._sampled_users,
            self._files["precision.txt"], path,
            self.rcfg.topn_by_user)

    def compute_itemrank(self, final: bool):
        if self.iteration % 100 == 0 and self.iteration > 0:
            final = True
        if not final or self._sampled_users is None:
            return None
        return rank_mod.compute_itemrank(self.scorer(), self.store,
                                         self.index, self._sampled_users,
                                         self.outdir)

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
        rank_mod.compute_precision(
            self.scorer(), self.store, self.index, users,
            self._files["precision.txt"],
            os.path.join(self.outdir, "ranking.tsv"),
            self.rcfg.topn_by_user)
        rank_mod.compute_itemrank(self.scorer(), self.store, self.index,
                                  users, self.outdir)

    def compute_rmse(self) -> float:
        return rank_mod.compute_rmse(self.scorer(), self.test,
                                     self.outdir, self._files["rmse.txt"])

    def gen_msr_csv(self):
        rank_mod.gen_msr_csv(self.scorer(), self.store, self.index,
                             self.leave_one_out, self.val_users_of_movie,
                             self.outdir)

    def logl(self) -> float:
        """Write the training ELBO to logl.txt (engine.py:356-366)."""
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
        self.compute_likelihood(True)
        if self._stop_requested:
            return
        self.compute_likelihood(False)
        if not self.mcfg.mle:
            self.save_model()
        self.compute_precision(False)
        if (self.mcfg.variant in ("bpf", "hpf", "canny")
                and not self.mcfg.bias):
            # reference: vb/vb_hier/vb_canny also run itemrank
            self.compute_itemrank(False)
        if self.rcfg.logl:
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

    def _run_loop(self, max_iters: Optional[int] = None) -> ModelState:
        cap = max_iters if max_iters is not None else self.resolve_cap()
        last_report = (time.time(), 0)
        while True:
            if cap is not None and self.iteration > cap:
                break
            # every iteration up to the next report boundary back to back,
            # with no host round trip in between
            n_steps, bound = self.next_chunk(cap)
            if n_steps > 1:
                self.state = self.multi_step(self.state, self.data, n_steps)
                self.iteration = bound
            else:
                self.state = self.step(self.state, self.data)
            if self.iteration % self.rcfg.rfreq == 0:
                self._sync()
                now = time.time()
                t0, it0 = last_report
                if self.iteration > it0:
                    rate = (self.iteration - it0) / max(now - t0, 1e-9)
                    self.log(f"iteration {self.iteration}: "
                             f"{rate:.1f} iters/s")
                last_report = (now, self.iteration)
                self.report()
            if self._stop_requested:
                self.log(f"stopping at iteration {self.iteration} "
                         f"duration {self.duration()}s")
                break
            self.iteration += 1
        # reference exits via do_on_stop on max_iterations (hgaprec.cc:
        # 1336-1339) and SIGTERM (973-976), not just on convergence
        if not self._on_stop_done:
            self.do_on_stop()
        self._join_save()   # checkpoint files complete when run() returns
        return self.state
