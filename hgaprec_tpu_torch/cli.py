"""Command line of the PyTorch port, with the reference's flag surface.

    python -m hgaprec_tpu_torch.cli -dir DATA -n N -m M -k K [-hier] ...

Port of `hgaprec_tpu/cli.py`: the same flags, mode dispatch, messages,
output files and exit codes. Flag names mirror the reference hgaprec
binary's main.cc:100-366 (hand-rolled argv scan, same strings):

  hgaprec-tpu -dir DATA -n N -m M -k K [-hier] [-bias] [-binary-data]
              [-a -b -c -d] [-rfreq R] [-seed S] [-max-iterations I]
              [-mle-user|-mle-item|-canny] [-novb] [-label L]
              [-rating-threshold T] [-logl] [-gen-ranking] [-msr] [-rmse]
              [-write-training] [-lda|-vwlda|-nmf|-nmfload|-vwload]
              [-chi [-als|-wals|-chinmf|-climf|-chisgd|-chipmf]] [-ctr]
              [-test [-test-items a,b,...]]

Extensions: -sweep dense|segment|segment-chunked|hybrid|auto,
-resume (continue training from the native checkpoint),
-tail auto|pallas (hybrid tail: both select the CUDA tail kernel),
-head-gib G (hybrid head byte budget), -precision highest|default,
-outdir PATH, -cpu (run on the CPU; without it the run needs a CUDA
device), -trace DIR (run training under torch.profiler and write a
TensorBoard trace, in which the port's spans (trace.py) name the
multi-step's warm-up, capture and key walk and the report's phases,
and whose metadata holds the hybrid head's width and share of the
nonzeros under "hgaprec_layout"),
-devices D (shard training over D devices: user rows split across
ranks, parallel/sharded.py). -tail mxu (the TPU's one-hot MXU tail) is
rejected by name.

Multi-GPU: under torchrun (WORLD_SIZE set) each process is one rank,
binds cuda:LOCAL_RANK (the CPU with -cpu, over gloo), ingests only its
own user rows and trains sharded over the whole world. Without torchrun,
`-devices D` clamps D to the visible devices (the CPU's cores with -cpu),
trains in this process when one remains, and otherwise starts D worker
processes of this command line, one per device, joined through a file in
a private temporary directory (no port another process could take first),
forwards SIGTERM to them and exits with rank 0's code. Only rank 0 prints
and writes the output files; the other ranks' report files land in
OUT/.proc{rank}. Every rank of a run that ends normally meets the others
at a barrier before it tears its process group down.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

# the flags of modes that do not train: -devices does not apply to them
_MODES = ("gen_heldout", "rmse", "chi", "test", "msr", "write_training",
          "nmfload", "nmf", "lda", "vwlda", "vwload", "ctr", "gen_ranking")


def _usage():
    print(__doc__)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        _usage()
        return 0

    o = {
        "dir": ".", "n": 0, "m": 0, "k": 0, "rfreq": 10, "label": "",
        "logl": False, "max_iterations": 1000, "seed": 0.0, "load": False,
        "load_loc": "", "test": False, "batch": True, "online": False,
        "gen_heldout": False, "a": 0.3, "b": 0.3, "c": 0.3, "d": 0.3,
        "binary": False, "bias": False, "hier": False, "mle_user": False,
        "mle_item": False, "canny": False, "gen_ranking": False,
        "rmse": False, "vb": True, "msr": False, "nmf": False,
        "nmfload": False, "vwload": False, "lda": False, "vwlda": False,
        "test_items": None,
        "write_training": False, "chi": False, "chinmf": False,
        "chisgd": False, "chipmf": False,
        "als": False, "wals": False, "wals_l": 0.1, "wals_C": 10,
        "climf": False, "ctr": False, "rating_threshold": 1,
        "dataset": "movielens", "strid": False,
        # parsed-but-unused knobs kept for invocation parity
        # (main.cc:107-108, 115-119, 153-158; stored in Env, never read
        # by the model)
        "p": False, "nmi": False, "ground_truth_fname": "",
        "pred_accuracy": False, "gt_accuracy": False,
        # extensions
        "sweep": "auto", "devices": 0, "resume": False, "outdir": None,
        "cpu": False, "item_block": 4096, "precision": "highest",
        "trace": None,
        # hybrid tail implementation; the HGAPREC_TAIL env sets the
        # default, -tail overrides (hgaprec_tpu/cli.py:68-71)
        "tail": os.environ.get("HGAPREC_TAIL", "auto"),
        # hybrid head byte budget in GiB
        "head_gib": 4.0,
    }

    i = 0
    def nexta():
        nonlocal i
        i += 1
        if i >= len(argv):
            raise SystemExit(f"error: option {argv[i - 1]} requires a value")
        return argv[i]
    while i < len(argv):
        arg = argv[i]
        if arg == "-dir":
            o["dir"] = nexta()
        elif arg == "-n":
            o["n"] = int(nexta())
        elif arg == "-m":
            o["m"] = int(nexta())
        elif arg == "-k":
            o["k"] = int(nexta())
        elif arg == "-rfreq":
            o["rfreq"] = int(nexta())
        elif arg == "-strid":
            # parity: the reference also only parses this — Env::strid is
            # stored (env.hh:95, :245) and never read by any code path
            o["strid"] = True
        elif arg == "-p":
            o["p"] = True
        elif arg == "-nmi":
            o["nmi"] = True
            o["ground_truth_fname"] = nexta()
            print(f"+ ground truth fname = {o['ground_truth_fname']}")
        elif arg == "-pred-accuracy":
            o["pred_accuracy"] = True
            print("+ compute predictive accuracy")
        elif arg == "-gt-accuracy":
            o["gt_accuracy"] = True
            print("+ compute  accuracy to ground truth")
        elif arg == "-label":
            o["label"] = nexta()
        elif arg == "-logl":
            o["logl"] = True
        elif arg == "-max-iterations":
            o["max_iterations"] = int(nexta())
        elif arg == "-seed":
            o["seed"] = float(nexta())
        elif arg == "-load":
            o["load"] = True
            o["load_loc"] = nexta()
        elif arg == "-test":
            o["test"] = True
        elif arg == "-test-items":
            # extension: cold-start seed items as external ids "a,b,..."
            # (reference hard-codes 118,12263 — hgaprec.cc:2262-2264)
            o["test_items"] = [int(v) for v in nexta().split(",") if v]
        elif arg == "-batch":
            o["batch"] = True
        elif arg == "-online":
            o["batch"] = False
        elif arg == "-gen-heldout":
            o["gen_heldout"] = True
        elif arg in ("-netflix", "-mendeley", "-movielens", "-echonest",
                     "-nyt"):
            o["dataset"] = arg[1:]
        elif arg == "-a":
            o["a"] = float(nexta())
        elif arg == "-b":
            o["b"] = float(nexta())
        elif arg == "-c":
            o["c"] = float(nexta())
        elif arg == "-d":
            o["d"] = float(nexta())
        elif arg == "-binary-data":
            o["binary"] = True
        elif arg == "-bias":
            o["bias"] = True
        elif arg == "-hier":
            o["hier"] = True
        elif arg == "-mle-user":
            o["mle_user"] = True
        elif arg == "-mle-item":
            o["mle_item"] = True
        elif arg == "-canny":
            o["canny"] = True
        elif arg == "-gen-ranking":
            o["gen_ranking"] = True
        elif arg == "-rmse":
            o["rmse"] = True
        elif arg == "-novb":
            o["vb"] = False
        elif arg == "-msr":
            o["msr"] = True
        elif arg == "-nmf":
            o["nmf"] = True
        elif arg == "-nmfload":
            o["nmfload"] = True
        elif arg == "-vwload":
            o["vwload"] = True
        elif arg == "-lda":
            o["lda"] = True
        elif arg == "-vwlda":
            o["vwlda"] = True
        elif arg == "-write-training":
            o["write_training"] = True
        elif arg == "-chi":
            o["chi"] = True
        elif arg == "-chinmf":
            o["chinmf"] = True
        elif arg == "-als":
            o["als"] = True
        elif arg == "-wals":
            o["wals"] = True
        elif arg == "-wals_l":
            o["wals_l"] = float(nexta())
        elif arg == "-wals_C":
            o["wals_C"] = int(nexta())
        elif arg == "-climf":
            o["climf"] = True
        elif arg == "-chisgd":
            # graphchi biasSGD bridge (run_chi_sgd, hgaprec.cc:589-605 —
            # present in the reference but unreachable from its main())
            o["chisgd"] = True
        elif arg == "-chipmf":
            # graphchi PMF bridge (run_chi_pmf, hgaprec.cc:607-624)
            o["chipmf"] = True
        elif arg == "-ctr":
            o["ctr"] = True
        elif arg == "-rating-threshold":
            o["rating_threshold"] = int(nexta())
        elif arg == "-sweep":
            o["sweep"] = nexta()
        elif arg == "-devices":
            o["devices"] = int(nexta())
        elif arg == "-resume":
            o["resume"] = True
        elif arg == "-outdir":
            o["outdir"] = nexta()
        elif arg == "-cpu":
            o["cpu"] = True
        elif arg == "-item-block":
            o["item_block"] = int(nexta())
        elif arg == "-precision":
            o["precision"] = nexta()
        elif arg == "-tail":
            o["tail"] = nexta()
        elif arg == "-head-gib":
            o["head_gib"] = float(nexta())
        elif arg == "-trace":
            o["trace"] = nexta()
        elif arg in ("-h", "--help"):
            _usage()
            return 0
        else:
            print(f"error: unknown option {arg}")
            return 1
        i += 1

    # "auto" and "pallas" both name the hand-written tail kernel here;
    # "mxu" is the TPU's one-hot MXU workaround, which the port's tail
    # kernel does without
    if o["tail"] == "mxu":
        print("error: -tail mxu: the TPU's one-hot MXU tail is not ported; "
              "the CUDA tail kernel computes the same function "
              "(-tail auto or pallas)")
        return 1
    if o["tail"] == "pallas":
        o["tail"] = "auto"

    import torch
    import torch.distributed as dist

    from hgaprec_tpu_torch.parallel import distributed
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if o["cpu"]:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", distributed.local_rank()) if launched \
            else torch.device("cuda")
    else:
        print("error: no CUDA device; pass -cpu to run on the CPU")
        return 1

    trains = o["batch"] and not any(o[f] for f in _MODES)
    user_rows = None
    rendezvous = None
    if launched:
        # one rank of a multi-process launch: shard over the whole world
        # (torchrun's MASTER_ADDR/MASTER_PORT, or the file this CLI's
        # spawner names in distributed.INIT_METHOD_ENV)
        distributed.initialize_from_env(device)
        world = dist.get_world_size()
        o["devices"] = world
        print(f"+ multi-host: process {dist.get_rank()} of {world}, "
              f"{world} devices")
        # per-rank ingest for training: each rank materializes only its
        # own user rows of train.tsv (the id maps and val/test maps stay
        # global); the other modes read every row
        if trains:
            user_rows = distributed.host_user_rows
    elif o["devices"] > 1 and trains:
        ndev = min(o["devices"], os.cpu_count() if o["cpu"]
                   else torch.cuda.device_count())
        if ndev != o["devices"]:
            print(f"+ only {ndev} devices available "
                  f"(requested {o['devices']})")
        o["devices"] = ndev
        if ndev > 1:
            return _spawn_workers(argv, ndev)
        rendezvous = tempfile.mkdtemp(prefix="hgaprec_pg_")
        distributed.initialize_from_env(
            device, init_method="file://" + os.path.join(rendezvous, "pg"),
            world_size=1, rank=0)
    try:
        rc = _main(o, device, user_rows,
                   sharded=dist.is_initialized() and trains)
        if dist.is_initialized() and dist.get_world_size() > 1:
            # no rank tears down its links while a peer's last collective
            # may still be reading them (a rank that raised skips this:
            # its peers are stopped by the spawner or by torchrun)
            dist.barrier()
        return rc
    finally:
        if dist.is_initialized():
            # the Trainer let go of the group when it closed, so this
            # destroys the backend and joins its threads here: a gloo
            # thread still running at interpreter exit aborts the rank
            # ("terminate called without an active exception")
            dist.destroy_process_group()
        if rendezvous is not None:
            shutil.rmtree(rendezvous, ignore_errors=True)


def _main(o, device, user_rows, sharded: bool) -> int:
    from hgaprec_tpu_torch.config import ModelConfig, RunConfig
    from hgaprec_tpu_torch.data.ratings import load_dataset

    variant = "bpf"
    if o["hier"]:
        variant = "hpf"
    elif o["mle_user"]:
        variant = "mle_user"
    elif o["mle_item"]:
        variant = "mle_item"
    elif o["canny"]:
        variant = "canny"

    if o["gen_heldout"]:
        return _gen_heldout(o)

    print(f"+ reading ratings dataset from {o['dir']}")
    store, validation, test = load_dataset(
        o["dir"], o["n"], o["m"], o["binary"], o["rating_threshold"],
        user_rows=user_rows)
    print(f"read {store.n} users, {store.m} movies, "
          f"{store.nratings} ratings"
          + (f" (local rows {store.local_user_rows})"
             if store.local_user_rows else ""))

    mcfg = ModelConfig(
        n=store.n, m=store.m, k=o["k"], variant=variant, bias=o["bias"],
        binary=o["binary"], vb=o["vb"], a=o["a"], b=o["b"], c=o["c"],
        d=o["d"], sweep=o["sweep"], item_block=o["item_block"],
        matmul_precision=o["precision"], tail_impl=o["tail"],
        head_limit_bytes=int(o["head_gib"] * (1 << 30)))
    chi_tool = ("nmf" if o["chinmf"] else "als" if o["als"] else
                "wals" if o["wals"] else "climf" if o["climf"] else "")
    rcfg = RunConfig(
        datdir=o["dir"], outdir=o["outdir"], label=o["label"],
        rfreq=o["rfreq"], max_iterations=o["max_iterations"],
        seed=int(o["seed"]), rating_threshold=o["rating_threshold"],
        logl=o["logl"], batch=o["batch"], trace_dir=o["trace"],
        nmf=o["nmf"] or o["nmfload"], lda=o["lda"], vwlda=o["vwlda"],
        chi=o["chi"], ctr=o["ctr"], write_training=o["write_training"],
        chi_tool=chi_tool, wals_l=o["wals_l"], wals_C=o["wals_C"])

    from hgaprec_tpu_torch.models.engine import Trainer
    # a sharded run builds each rank's shard itself (and a per-rank store
    # holds only that rank's rows)
    tr = Trainer(store, validation, test, mcfg, rcfg, device=device,
                 build_data=not sharded)
    tr.install_sigterm()
    print(f"+ output directory: {tr.outdir}")

    try:
        return _dispatch(o, store, validation, test, mcfg, rcfg, tr, sharded)
    finally:
        tr.close()


def _spawn_workers(argv: List[str], ndev: int) -> int:
    """Run this command line as `ndev` ranks, one process per device,
    with torchrun's WORLD_SIZE, RANK and LOCAL_RANK, joined through a
    file in a private temporary directory (distributed.INIT_METHOD_ENV):
    no port is chosen, so none can be taken by another process between
    its choice and rank 0's bind. Rank 0 prints; every other rank's
    stdout and stderr go to `rank{r}.log` in that directory, and the log
    of a rank that did not exit 0 is printed before the directory goes
    (`_report_ranks`). SIGTERM is forwarded to every rank; when a rank
    fails the others are stopped (they would wait in their next
    collective). Returns rank 0's exit code, or 1 if only another rank
    failed."""
    from hgaprec_tpu_torch.parallel import distributed
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    rendezvous = tempfile.mkdtemp(prefix="hgaprec_pg_")
    init = "file://" + os.path.join(rendezvous, "pg")
    logs = [None] + [os.path.join(rendezvous, f"rank{r}.log")
                     for r in range(1, ndev)]
    sys.stdout.flush()
    procs = []
    try:
        for r in range(ndev):
            log = None if logs[r] is None else open(logs[r], "w")
            try:
                procs.append(subprocess.Popen(
                    _rank_command(argv),
                    env=dict(os.environ, WORLD_SIZE=str(ndev), RANK=str(r),
                             LOCAL_RANK=str(r), PYTHONPATH=path,
                             **{distributed.INIT_METHOD_ENV: init}),
                    stdout=log, stderr=log))
            finally:
                if log is not None:
                    log.close()
        rc = _wait_workers(procs)
        _report_ranks(procs, logs)
        return rc
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


def _rank_command(argv: List[str]) -> List[str]:
    """The command line one rank runs."""
    return [sys.executable, "-m", "hgaprec_tpu_torch.cli", *argv]


def _report_ranks(procs, logs) -> None:
    """Print the kept output of every rank that did not exit 0 (rank 0's
    went to this process's own streams)."""
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode == 0 or log is None:
            continue
        with open(log, errors="replace") as f:
            text = f.read()
        print(f"+ rank {r} of {len(procs)} exited with code {p.returncode};"
              f" its output:\n{text.rstrip()}\n+ end of rank {r}'s output",
              flush=True)


def _wait_workers(procs) -> int:
    """Wait for the ranks `procs`, forwarding SIGTERM and stopping the
    others when one fails; returns rank 0's code, or 1 if only another
    rank failed."""

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = signal.signal(signal.SIGTERM, forward)
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                forward(signal.SIGTERM, None)
                for p in procs:
                    p.wait()
                break
            time.sleep(0.1)
    finally:
        signal.signal(signal.SIGTERM, previous)
    codes = [p.returncode for p in procs]
    if codes[0] != 0:
        return codes[0] if codes[0] > 0 else 1
    return 0 if not any(codes) else 1


def _gen_heldout(o) -> int:
    """CREATE_TRAIN_TEST_SETS mode: raw format -> split TSVs
    (ratings.cc:11-26 ingest + the splitter the reference never shipped)."""
    from hgaprec_tpu_torch.data import readers
    d = o["dir"]
    ds = o["dataset"]
    print(f"+ reading raw {ds} dataset from {d}")
    if ds == "movielens":
        for cand in ("ml-1m_train.tsv", "ratings.dat", "ratings.tsv"):
            path = os.path.join(d, cand)
            if os.path.exists(path):
                break
        u, i, y = readers.read_movielens(path)
    elif ds == "netflix":
        u, i, y = readers.read_netflix_dir(d, max_movies=o["m"] or None)
    elif ds == "mendeley":
        u, i, y = readers.read_mendeley(os.path.join(d, "users.dat"))
    str2id = None
    if ds == "echonest":
        u, i, y, str2id = readers.read_triplets(
            os.path.join(d, "train_triplets.txt"))
    elif ds == "nyt":
        u, i, y, str2id = readers.read_triplets(
            os.path.join(d, "nyt-clicks.tsv"))
    elif ds not in ("movielens", "netflix", "mendeley"):
        print(f"unknown dataset {ds}")
        return 1
    out = o["outdir"] or d
    if str2id is not None:
        # persist the minted string->id map (ratings.cc:450-456; the
        # reference filters to long keys — user hashes — we keep all)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "str2id.tsv"), "w") as f:
            for s, sid in str2id.items():
                f.write(f"{s}\t{sid}\n")
    counts = readers.create_train_test_sets(
        u, i, y, out, leave_one_out=o["msr"], seed=int(o["seed"]))
    print(f"+ wrote splits to {out}: {counts}")
    return 0


def _dispatch(o, store, validation, test, mcfg, rcfg, tr,
              sharded: bool = False) -> int:
    from hgaprec_tpu_torch.data import formats
    from hgaprec_tpu_torch.eval import ranking as rank_mod
    from hgaprec_tpu_torch.eval.score import scorer_from_foreign

    def rank_foreign(theta, beta):
        """load_*_beta_and_theta tail: rank for test_users (hgaprec.cc:
        827-831 etc.)."""
        sc = scorer_from_foreign(theta, beta, tr.device)
        tu = os.path.join(o["dir"], "test_users.tsv")
        if not os.path.exists(tu):
            print(f"cannot open {tu}")
            return
        users = store.read_test_users(tu)
        rank_mod.compute_precision(
            sc, store, tr.index, users, tr._files["precision.txt"],
            os.path.join(tr.outdir, "ranking.tsv"), tr.rcfg.topn_by_user)
        print("DONE writing ranking.tsv in output directory")

    if o["rmse"]:
        if o["load"]:
            tr.load_model(o["load_loc"])
        tr.compute_rmse()
        return 0

    if o["chi"]:
        minval, maxval = formats.write_chi_training_matrix(
            store, validation, tr.outdir, wals=o["wals"],
            wals_c=o["wals_C"])
        tool = ("nmf" if o["chinmf"] else "als" if o["als"] else
                "wals" if o["wals"] else "climf" if o["climf"] else
                "biassgd" if o["chisgd"] else "pmf" if o["chipmf"] else
                None)
        if tool:
            root = os.environ.get("GRAPHCHI_ROOT", "")
            cmd = formats.chi_command(tool, tr.outdir, mcfg.k,
                                      graphchi_root=root or "graphchi-cpp",
                                      minval=minval, maxval=maxval)
            print(f"+ external command: {cmd}")
            if root:
                os.system(cmd)
                base = "chifull.tsv" if o["chinmf"] else "chitrain.tsv"
                theta = formats.mm_load_rowmajor(
                    os.path.join(tr.outdir, f"{base}_U.mm"), store.n,
                    mcfg.k)
                beta = formats.mm_load_rowmajor(
                    os.path.join(tr.outdir, f"{base}_V.mm"), store.m,
                    mcfg.k)
                rank_foreign(theta, beta)
            else:
                print("GRAPHCHI_ROOT not set; wrote matrices only")
        return 0

    if o["test"]:
        # cold-start demo (hgaprec.cc:2257-2346): map the seed items'
        # external ids, load the model, fold in a fresh user over 10 CAVI
        # iterations, print the top-21 titles. Default seed pair = the
        # reference's hard-coded Netflix ids 118/12263 (:2262-2264);
        # -test-items overrides. NB the reference does NOT exclude the
        # seed items from the printed ranking (the skip loop at
        # :2327-2330 is a no-op) — reproduced.
        from hgaprec_tpu_torch.data import readers
        from hgaprec_tpu_torch.models.coldstart import fold_in_users
        ext_items = o["test_items"] or [118, 12263]
        seq_items = []
        for e in ext_items:
            s = store.movie2seq.get(e)
            if s is None:
                print(f"error: seed item {e} not in the training set")
                return 1
            seq_items.append(int(s))
        meta = {}
        for fname, rdr in (("movie_titles.txt",
                            readers.read_netflix_metadata),
                           ("movies.dat", readers.read_movielens_metadata),
                           ("titles.dat", readers.read_mendeley_metadata),
                           ("nyt-titles.tsv", readers.read_nyt_metadata)):
            for base in (o["dir"], "."):
                p = os.path.join(base, fname)
                if os.path.exists(p):
                    meta = rdr(p)
                    break
            if meta:
                break

        def title(seq: int) -> str:
            ext = store.seq2movie.get(seq, seq)
            t = meta.get(ext)
            return f"{t[0]}, {t[1]}" if t else str(ext)

        for s in seq_items:
            print(title(s))
        tr.load_model(o["load_loc"] if o["load"] else None)
        print("loading model state complete")
        _, scores = fold_in_users(tr.state, mcfg, [seq_items])
        print("predictions")
        order = np.argsort(-scores[0], kind="stable")[:21]
        for mm in order:
            print(title(int(mm)))
        return 0

    if o["msr"]:
        tr.load_model(o["load_loc"] if o["load"] else None)
        tr.gen_msr_csv()
        return 0

    if o["write_training"]:
        if o["lda"]:
            formats.write_lda_training_matrix(
                store, os.path.join(tr.outdir, "ldatrain.tsv"))
        elif o["nmf"]:
            formats.write_nmf_training_matrix(
                store, os.path.join(tr.outdir, "trainm.tsv"))
        elif o["vwlda"]:
            formats.write_vwlda_training_matrix(
                store, os.path.join(tr.outdir, "ldatrain.tsv"))
        return 0

    if o["nmfload"]:
        # load_nmf_beta_and_theta (main.cc:298-302 -> hgaprec.cc:833-862):
        # import libNMF's theta.tsv/beta.tsv from the output dir, re-save
        # as nmf_{theta,beta}.tsv, rank for test_users
        from hgaprec_tpu_torch.io.checkpoint import _save_mat
        theta, beta = formats.nmf_load_factors(
            store.n, store.m, mcfg.k,
            os.path.join(tr.outdir, "theta.tsv"),
            os.path.join(tr.outdir, "beta.tsv"))
        _save_mat(os.path.join(tr.outdir, "nmf_theta.tsv"), theta, {})
        _save_mat(os.path.join(tr.outdir, "nmf_beta.tsv"), beta, {})
        rank_foreign(theta, beta)
        return 0

    if o["nmf"]:
        from hgaprec_tpu_torch.ops.nmf import nmf
        dense = np.zeros((store.n, store.m), np.float32)
        dense[store.coo_u, store.coo_i] = store.coo_y
        theta, beta = nmf(dense, mcfg.k, tr.device)
        from hgaprec_tpu_torch.io.checkpoint import _save_mat
        _save_mat(os.path.join(tr.outdir, "nmf_theta.tsv"), theta, {})
        _save_mat(os.path.join(tr.outdir, "nmf_beta.tsv"), beta, {})
        rank_foreign(theta, beta)
        return 0

    if o["lda"]:
        theta, beta = formats.load_lda_factors(store.n, store.m, mcfg.k)
        rank_foreign(theta, beta)
        return 0

    if o["vwlda"]:
        formats.write_vwlda_training_matrix(
            store, os.path.join(tr.outdir, "ldatrain.tsv"))
        vw = os.environ.get("VW_BINARY", "")
        cmd = formats.vwlda_command(tr.outdir, mcfg.k, store.n, store.m,
                                    vw_binary=vw or "vw")
        print(f"+ external command: {cmd}")
        if vw:
            os.system(cmd)
            theta, beta = formats.load_vwlda_factors(
                store.n, store.m, mcfg.k,
                os.path.join(tr.outdir, "gamma.tsv"),
                os.path.join(tr.outdir, "beta.tsv"))
            rank_foreign(theta, beta)
        return 0

    if o["vwload"]:
        theta, beta = formats.load_vwlda_factors(
            store.n, store.m, mcfg.k, os.path.join(tr.outdir, "gamma.tsv"),
            os.path.join(tr.outdir, "beta.tsv"))
        rank_foreign(theta, beta)
        return 0

    if o["ctr"]:
        # hgaprec.cc:418-476: place CTR rows through the id maps, write
        # the map CSVs and re-saved factors, then rank natively
        from hgaprec_tpu_torch.io.checkpoint import _save_mat
        theta, beta, umap, imap = formats.load_ctr_factors(
            store.n, store.m, mcfg.k)
        theta, beta = formats.apply_ctr_maps(
            theta, beta, umap, imap, store.seq2user, store.seq2movie,
            store.n, store.m)
        formats.write_ctr_map_csvs(tr.outdir, umap, imap, store.seq2user,
                                   store.seq2movie, store.n, store.m)
        _save_mat(os.path.join(tr.outdir, "ctr_theta.tsv"), theta,
                  store.seq2user)
        _save_mat(os.path.join(tr.outdir, "ctr_beta.tsv"), beta,
                  store.seq2movie)
        rank_foreign(theta, beta)
        return 0

    if o["gen_ranking"]:
        tr.gen_ranking_for_users(load=True)
        return 0

    if not o["batch"]:
        # parity: reference prints this and quits (main.cc:361-365)
        print("Quitting. Online inference not implemented.")
        return 0

    if o["resume"]:
        npz = os.path.join(tr.shared_outdir, "model.npz")
        if os.path.exists(npz):
            tr.load_model()
            print(f"+ resuming from iteration {tr.iteration}")
    if sharded:
        import torch.distributed as dist
        print(f"+ sharding over {o['devices']} devices")
        tr.shard(dist.group.WORLD)
    tr.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
