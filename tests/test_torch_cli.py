"""The port's command line against the JAX package's, on the CPU.

Both CLIs run on the same `write_pf_dataset` data with the same flags and
seed (the port with `-cpu`); their output files, printed lines and exit
codes are compared. Training agrees to 1e-4 relative per report, as in
tests/test_torch_engine.py; the modes that read a model (-rmse, -msr,
-gen-ranking, -test) read the same JAX-written checkpoint; the bridge
modes write byte-equal files.
"""

import os
import shutil
import signal
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from hgaprec_tpu import cli as jcli
from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.data.synthetic import write_pf_dataset
from hgaprec_tpu.io import checkpoint as jck
from hgaprec_tpu.models.coldstart import fold_in_users as j_fold_in
from hgaprec_tpu.models.state import init_state as j_init_state
from hgaprec_tpu_torch import cli as tcli
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.io import checkpoint as tck
from hgaprec_tpu_torch.models.coldstart import fold_in_users as t_fold_in
from hgaprec_tpu_torch.models.state import init_state as t_init_state
from hgaprec_tpu_torch.models.state import state_from_numpy

from _native_writers import load_both

N, M, K = 50, 30, 3
BASE = ["-n", str(N), "-m", str(M), "-k", str(K)]


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    # the JAX CLI would otherwise point JAX's cache under $HOME
    monkeypatch.setenv("HGAPREC_COMPILE_CACHE", "0")
    monkeypatch.delenv("GRAPHCHI_ROOT", raising=False)
    monkeypatch.delenv("HGAPREC_TAIL", raising=False)
    monkeypatch.delenv("VW_BINARY", raising=False)


@pytest.fixture
def dataset(tmp_path, rng):
    d = tmp_path / "data"
    write_pf_dataset(str(d), rng, N, M, k=K, scale=6.0, test_frac=0.15,
                     valid_frac=0.1)
    return d


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


def _both(args, tmp_path, capsys, jdir="jax", tdir="torch"):
    """Run both CLIs with `args` (+ -outdir each, -cpu for the port);
    returns (jax rc, port rc, jax stdout, port stdout, jax dir, port dir).
    """
    jd, td = tmp_path / jdir, tmp_path / tdir
    capsys.readouterr()
    jrc = jcli.main(args + ["-outdir", str(jd)])
    jout = capsys.readouterr().out
    trc = tcli.main(args + ["-outdir", str(td), "-cpu"])
    tout = capsys.readouterr().out
    return jrc, trc, jout.replace(str(jd), "OUT"), \
        tout.replace(str(td), "OUT"), jd, td


def _assert_reports_agree(jd, td, names=("validation.txt", "test.txt")):
    for name in names:
        jr, tr = _rows(jd / name), _rows(td / name)
        assert len(tr) == len(jr) >= 2, name
        assert [r[0] for r in tr] == [r[0] for r in jr], name    # iterations
        assert [r[3] for r in tr] == [r[3] for r in jr], name    # pair counts
        np.testing.assert_allclose([float(r[2]) for r in tr],
                                   [float(r[2]) for r in jr], rtol=1e-4,
                                   err_msg=name)


def _train_jax(dataset, tmp_path, capsys, flags=("-hier",), name="model"):
    out = tmp_path / name
    capsys.readouterr()
    rc = jcli.main(["-dir", str(dataset), *BASE, "-rfreq", "4",
                    "-max-iterations", "8", "-seed", "2", *flags,
                    "-outdir", str(out)])
    assert rc == 0
    return out


@pytest.mark.parametrize("flags", [
    ["-hier"],
    ["-hier", "-sweep", "segment-chunked", "-logl"],
    ["-bias", "-seed", "3"],
    ["-mle-user", "-rfreq", "6"],
], ids=["hpf", "hpf-segment-logl", "bpf-bias", "mle-user"])
def test_cli_training_agrees(dataset, tmp_path, capsys, flags):
    args = ["-dir", str(dataset), *BASE, "-rfreq", "4", "-max-iterations",
            "8", "-seed", "2", *flags]
    jrc, trc, jout, tout, jd, td = _both(args, tmp_path, capsys)
    assert jrc == trc == 0
    assert tout == jout
    _assert_reports_agree(jd, td)
    if "-logl" in flags:
        np.testing.assert_allclose(
            [float(r[0]) for r in _rows(td / "logl.txt")],
            [float(r[0]) for r in _rows(jd / "logl.txt")], rtol=1e-4)
    jfiles = {f for f in os.listdir(jd)}
    assert {f for f in os.listdir(td)} == jfiles
    for name in ("param.txt", "byusers.tsv", "byitems.tsv"):
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name


@pytest.mark.parametrize("k,flags", [(300, []), (255, ["-bias"])],
                         ids=["k300", "k255-bias"])
def test_cli_training_agrees_wide(dataset, tmp_path, capsys, k, flags):
    """HPF past 256 packed values through both CLIs on the CPU (K = 300;
    K = 255 with bias, 257 values): the port's plain versions, which the
    wide kernels are held to on the card, give the JAX package's
    validation and test likelihoods within 1e-4 relative."""
    args = ["-dir", str(dataset), "-n", str(N), "-m", str(M), "-k", str(k),
            "-hier", "-rfreq", "2", "-max-iterations", "4", "-seed", "2",
            *flags]
    jrc, trc, jout, tout, jd, td = _both(args, tmp_path, capsys)
    assert jrc == trc == 0
    assert tout == jout
    _assert_reports_agree(jd, td)


def test_cli_resume_agrees(dataset, tmp_path, capsys):
    """-resume continues from model.npz at the saved iteration (the
    stop save after iteration 3 records 4, as in the JAX package)."""
    args = ["-dir", str(dataset), *BASE, "-rfreq", "3", "-hier"]
    _, _, _, _, jd, td = _both(args + ["-max-iterations", "3"], tmp_path,
                               capsys)
    jrc, trc, jout, tout, _, _ = _both(
        args + ["-max-iterations", "9", "-resume"], tmp_path, capsys)
    assert jrc == trc == 0
    assert "+ resuming from iteration 4" in tout
    assert tout == jout
    _assert_reports_agree(jd, td)
    assert [r[0] for r in _rows(td / "validation.txt")] == ["6", "9"]


def test_cli_rmse_loads_jax_model(dataset, tmp_path, capsys):
    model = _train_jax(dataset, tmp_path, capsys)
    args = ["-dir", str(dataset), *BASE, "-hier", "-rmse", "-load",
            str(model)]
    jrc, trc, jout, tout, jd, td = _both(args, tmp_path, capsys)
    assert jrc == trc == 0 and tout == jout
    np.testing.assert_allclose(float((td / "rmse.txt").read_text()),
                               float((jd / "rmse.txt").read_text()),
                               rtol=1e-6)
    jr, tr = _rows(jd / "test_scores.tsv"), _rows(td / "test_scores.tsv")
    assert len(tr) == len(jr) > 0
    assert [r[0] for r in tr] == [r[0] for r in jr]
    np.testing.assert_allclose([float(r[1]) for r in tr],
                               [float(r[1]) for r in jr], atol=2e-5)


def _masked_scores(model_dir, dataset):
    """f64 [N, M] scores of the JAX checkpoint, train+validation masked
    to 0 as the ranking masks them."""
    from hgaprec_tpu.data.ratings import load_dataset
    store, validation, _ = load_dataset(str(dataset), N, M, False, 1)
    z = np.load(model_dir / "model.npz")
    s = z["theta.e"].astype(np.float64) @ z["beta.e"].astype(np.float64).T
    s[store.coo_u, store.coo_i] = 0.0
    for (u, i) in validation:
        s[u, i] = 0.0
    return store, s


@pytest.mark.parametrize("route", ["host", "streamed"])
def test_cli_msr_equal_up_to_ties(dataset, tmp_path, capsys, monkeypatch,
                                  route):
    """pred.csv from the same JAX model; "streamed" lowers the port's
    MSR_HOST_CELL_BUDGET so that its ranks come from the streamed rank
    counter (eval/topk.py::item_ranks) instead of host argsorts."""
    if route == "streamed":
        from hgaprec_tpu_torch.eval import ranking as tranking
        monkeypatch.setattr(tranking, "MSR_HOST_CELL_BUDGET", 0)
    model = _train_jax(dataset, tmp_path, capsys)
    args = ["-dir", str(dataset), *BASE, "-hier", "-msr", "-load",
            str(model)]
    jrc, trc, jout, tout, jd, td = _both(args, tmp_path, capsys)
    assert jrc == trc == 0 and tout == jout
    jr, tr = _rows(jd / "pred.csv"), _rows(td / "pred.csv")
    assert tr[0] == jr[0] and len(tr) == len(jr) > 1
    store, s = _masked_scores(model, dataset)
    for a, b in zip(tr[1:], jr[1:]):
        assert a[:2] + a[3:] == b[:2] + b[3:]
        if a[2] != b[2]:      # ranks may differ only where scores tie
            u = store.user2seq[int(a[0])]
            t = store.movie2seq[int(a[1])]
            row = s[u, :M - 1]
            ties = np.isclose(row, s[u, t], rtol=1e-6, atol=0).sum() - 1
            assert abs(int(a[2]) - int(b[2])) <= ties, (a, b)


@pytest.mark.parametrize("source", ["npz", "tsv"])
def test_cli_gen_ranking_same_items(dataset, tmp_path, capsys, source):
    """-gen-ranking on the same JAX model, read from model.npz or (with
    the npz removed) from the model TSVs."""
    model = _train_jax(dataset, tmp_path, capsys)
    jd, td = tmp_path / "jax", tmp_path / "torch"
    for d in (jd, td):
        shutil.copytree(model, d)
        if source == "tsv":
            os.remove(d / "model.npz")
    args = ["-dir", str(dataset), *BASE, "-hier", "-gen-ranking"]
    jrc, trc, jout, tout, _, _ = _both(args, tmp_path, capsys)
    assert jrc == trc == 0 and tout == jout
    jr, tr = _rows(jd / "ranking.tsv"), _rows(td / "ranking.tsv")
    assert len(tr) == len(jr) > 0
    assert [[r[c] for c in (0, 1, 3)] for r in tr] == \
        [[r[c] for c in (0, 1, 3)] for r in jr]
    np.testing.assert_allclose([float(r[2]) for r in tr],
                               [float(r[2]) for r in jr], atol=2e-5)


VARIANTS = [dict(variant="hpf"), dict(variant="bpf", bias=True),
            dict(variant="mle_user"), dict(variant="canny")]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("model_kw", VARIANTS,
                         ids=[v["variant"] for v in VARIANTS])
def test_tsv_cross_read(tmp_path, rng, model_kw, writer):
    """Each package reads the model TSVs the other wrote; the
    expectations agree to 1e-6. The JAX loader keeps a 1-D family's
    shape at [N, 1], so its HPF rate expectations broadcast to [N, N]:
    their diagonal is the value (ROADMAP queue 3)."""
    n, m = 12, 9
    seq2user = {i: 100 + i for i in range(n)}
    seq2movie = {i: 200 + i for i in range(m)}
    jcfg = JCfg(n=n, m=m, k=K, **model_kw)
    tcfg = TCfg(n=n, m=m, k=K, **model_kw)
    # a trained-looking state: the JAX initial state at seed 5, through
    # npz so both packages hold the same numbers
    npz = str(tmp_path / "s.npz")
    jck.save_npz(npz, j_init_state(jcfg, 5), 0)
    with np.load(npz) as z:
        arrays = {key: z[key] for key in z.files if key != "iteration"}
    if writer == "jax":
        jck.save_model_tsv(str(tmp_path), j_init_state(jcfg, 5), jcfg,
                           seq2user, seq2movie)
    else:
        tck.save_model_tsv(str(tmp_path), arrays, tcfg, seq2user, seq2movie)
    js = jck.load_model_tsv(str(tmp_path), jcfg, j_init_state(jcfg, 1))
    ts = tck.load_model_tsv(str(tmp_path), tcfg,
                            t_init_state(tcfg, 1, device="cpu"))
    truth = state_from_numpy(arrays, tcfg, "cpu")
    for f in ("theta", "beta", "theta_rate", "beta_rate", "theta_bias",
              "beta_bias"):
        g = getattr(ts, f)
        if g is None:
            continue
        for part in ("shape", "rate", "e", "elog"):
            got = getattr(g, part).numpy()
            jv = np.asarray(getattr(getattr(js, f), part))
            if jv.ndim == 2 and got.ndim == 1:      # the [N, N] broadcast
                jv = np.diagonal(jv) if jv.shape[1] > 1 else jv[:, 0]
            np.testing.assert_allclose(got, jv, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{f}.{part}")
            # what was saved comes back: shape and rate, and E[v] where
            # the family reads E[v] only (the biases)
            if (part == "e") == f.endswith("_bias") and part != "elog":
                np.testing.assert_allclose(
                    got, getattr(getattr(truth, f), part).numpy(),
                    rtol=1e-6, atol=1e-6, err_msg=f"{f}.{part} saved")
    for f in ("theta_mle", "beta_mle"):
        if getattr(ts, f) is not None:
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-6, atol=1e-6)


def test_cli_coldstart_titles_agree(dataset, tmp_path, capsys):
    """-test prints the same seed titles and the same 21 predicted
    titles from the same JAX model; fold_in_users' scores agree to
    rtol=1e-5 on that state."""
    model = _train_jax(dataset, tmp_path, capsys)
    meta_dir = tmp_path / "meta"
    shutil.copytree(dataset, meta_dir)
    (meta_dir / "movies.dat").write_text(
        "".join(f"{e}::Title {e}::Genre\n" for e in range(1, 31)))
    args = ["-dir", str(meta_dir), *BASE, "-hier", "-test", "-test-items",
            "1,2", "-load", str(model)]
    jrc, trc, jout, tout, _, _ = _both(args, tmp_path, capsys)
    assert jrc == trc == 0
    assert tout == jout
    tail = tout.split("predictions\n", 1)[1].strip().splitlines()
    assert len(tail) == 21 and "Title 1, Genre" in tout
    # fold-in scores on the same state
    from hgaprec_tpu.data.ratings import load_dataset
    store, _, _ = load_dataset(str(dataset), N, M, False, 1)
    cfg = dict(n=store.n, m=store.m, k=K, variant="hpf")
    jstate, _ = jck.load_npz(str(model / "model.npz"), JCfg(**cfg))
    tstate, _ = tck.load_npz(str(model / "model.npz"), TCfg(**cfg), "cpu")
    seeds = [[store.movie2seq[1], store.movie2seq[2]], [store.movie2seq[3]]]
    je, jsc = j_fold_in(jstate, JCfg(**cfg), seeds)
    te, tsc = t_fold_in(tstate, TCfg(**cfg), seeds)
    np.testing.assert_allclose(te, je, rtol=1e-5)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5)
    # a seed item outside the training set: same message, exit code 1
    jrc, trc, jout, tout, _, _ = _both(
        ["-dir", str(meta_dir), *BASE, "-hier", "-test", "-test-items",
         "99999", "-load", str(model)], tmp_path, capsys)
    assert jrc == trc == 1 and tout == jout


def _write_chi_stub(root):
    """A graphchi test double: writes deterministic MatrixMarket factors
    next to its --training file (tests/test_cli.py's stub)."""
    tooldir = root / "toolkits" / "collaborative_filtering"
    tooldir.mkdir(parents=True)
    for tool in ("als", "wals", "nmf", "climf", "biassgd", "pmf"):
        stub = tooldir / tool
        stub.write_text('''#!/usr/bin/env python3
import sys
train = [a.split("=", 1)[1] for a in sys.argv
         if a.startswith("--training=")][0]
d = [int(a.split("=", 1)[1]) for a in sys.argv if a.startswith("--D=")][0]
for side, rows in (("_U.mm", 50), ("_V.mm", 30)):
    with open(train + side, "w") as f:
        f.write("%%MatrixMarket matrix array real general\\n%comment\\n")
        f.write(f"{rows} {d}\\n")
        for r in range(rows):
            f.write(" ".join(str(0.01 * (r + 1) * (c + 1))
                             for c in range(d)) + "\\n")
''')
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)


def _factor_inputs(case, cwd, jd, td):
    """Foreign factor files a bridge mode imports (in the cwd or in each
    output directory), from a fixed numpy stream."""
    rng = np.random.default_rng(9)
    if case == "nmfload":
        th, be = rng.random((N, K)), rng.random((K, M))
        for d in (jd, td):
            d.mkdir()
            (d / "theta.tsv").write_text("h\nh\n" + "\n".join(
                " ".join(f"{v:.6f}" for v in r) for r in th))
            (d / "beta.tsv").write_text("h\nh\n" + "\n".join(
                " ".join(f"{v:.6f}" for v in r) for r in be))
    elif case == "lda":
        np.savetxt(cwd / "gamma.tsv", rng.random((N, K)) + 0.1)
        np.savetxt(cwd / "beta.tsv", np.log(rng.random((K, M)) + 1e-3))
    elif case == "vwload":
        for d in (jd, td):
            d.mkdir()
            rs = np.random.default_rng(4)
            np.savetxt(d / "gamma.tsv", rs.random((N, K)) + 0.1)
            rows = np.column_stack([np.arange(M), rs.random((M, K))])
            (d / "beta.tsv").write_text("header\n" * 11 + "\n".join(
                " ".join(f"{v:.6f}" for v in r) for r in rows) + "\n")
    elif case == "ctr":
        np.savetxt(cwd / "final-U.dat", rng.random((N, K)))
        np.savetxt(cwd / "final-V.dat", rng.random((M, K)))
        (cwd / "user_map.dat").write_text(
            "".join(f"{e},{e - 1}\n" for e in range(1, N + 1)))
        (cwd / "item_map.dat").write_text(
            "".join(f"{e},{e - 1}\n" for e in range(1, M + 1)))


BRIDGES = {
    "write-lda": ["-write-training", "-lda"],
    "write-nmf": ["-write-training", "-nmf"],
    "write-vwlda": ["-write-training", "-vwlda"],
    "chi-wals": ["-chi", "-wals"],
    "chi-als-stub": ["-chi", "-als"],
    "chi-nmf-stub": ["-chi", "-chinmf"],
    "chi-climf-stub": ["-chi", "-climf"],
    "chi-sgd": ["-chi", "-chisgd"],
    "chi-pmf-stub": ["-chi", "-chipmf"],
    "nmfload": ["-nmfload"],
    "lda": ["-lda"],
    "vwlda": ["-vwlda"],
    "vwload": ["-vwload"],
    "ctr": ["-ctr"],
}


@pytest.fixture(scope="module")
def native_writers():
    """Both packages' native TSV writers loaded in this process
    (tests/_native_writers.py): `-nmfload` and `-ctr` write factors
    through them, and the JAX package's Python path writes other bytes.
    Fails by name where one still cannot load."""
    missing = load_both()
    if missing:
        pytest.fail(f"{' and '.join(missing)} cannot be loaded: the "
                    f"bridge modes' byte comparison needs both")


@pytest.mark.parametrize("case", list(BRIDGES))
def test_cli_bridges_byte_equal(dataset, tmp_path, capsys, monkeypatch,
                                native_writers, case):
    """Every file a bridge mode writes is byte-equal between the two
    CLIs, and so is what they print."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    jd, td = tmp_path / "jax", tmp_path / "torch"
    if case.endswith("-stub"):
        _write_chi_stub(tmp_path / "graphchi-cpp")
        monkeypatch.setenv("GRAPHCHI_ROOT", str(tmp_path / "graphchi-cpp"))
    _factor_inputs(case, cwd, jd, td)
    args = ["-dir", str(dataset), *BASE, *BRIDGES[case]]
    jrc, trc, jout, tout, _, _ = _both(args, tmp_path, capsys)
    assert jrc == trc == 0
    assert tout == jout
    jfiles = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == jfiles
    for name in jfiles:
        if name == "infer.log":
            continue
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    if case.endswith("-stub") or case in ("nmfload", "lda", "vwload", "ctr"):
        assert (td / "ranking.tsv").stat().st_size > 0


OUTDIR_FLAGS = [
    [],
    ["-hier", "-label", "x"],
    ["-bias", "-binary-data", "-seed", "7"],
    ["-a", "0.5", "-d", "1.25", "-novb", "-mle-user"],
    ["-chi", "-wals", "-wals_l", "0.5", "-wals_C", "3"],
    ["-chi", "-als"],
    ["-chi", "-chinmf", "-canny"],
    ["-chi", "-climf", "-mle-item"],
    ["-nmf", "-write-training"],
    ["-lda", "-write-training"],
    ["-vwlda", "-write-training"],
]


@pytest.mark.parametrize("flags", OUTDIR_FLAGS,
                         ids=["-".join(f) or "plain" for f in OUTDIR_FLAGS])
def test_cli_outdir_names_equal(dataset, tmp_path, capsys, monkeypatch,
                                flags):
    """Without -outdir both CLIs name the output directory alike, the
    bridge suffixes included (env.hh:283-369)."""
    made = []
    for name, mod, extra in (("jax", jcli, []), ("torch", tcli, ["-cpu"])):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        capsys.readouterr()
        # -write-training alone writes nothing: the dispatch returns
        # before training in every case
        rc = mod.main(["-dir", str(dataset), *BASE, *flags,
                       "-write-training", *extra])
        assert rc == 0
        made.append(sorted(os.listdir(cwd)))
    assert made[1] == made[0] and len(made[0]) == 1


@pytest.mark.parametrize("case", ["movielens", "movielens-msr", "echonest",
                                  "nyt-msr"])
def test_cli_gen_heldout_equal(tmp_path, capsys, case):
    """-gen-heldout: raw movielens ratings or string triplets to split
    TSVs; the files and the printed lines are equal."""
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(3)
    if case.startswith("movielens"):
        (raw / "ratings.dat").write_text("".join(
            f"{u}::{m}::{r}::0\n" for u, m, r in zip(
                rng.integers(1, 60, 1500), rng.integers(1, 40, 1500),
                rng.integers(1, 6, 1500))))
    else:
        name = "train_triplets.txt" if case == "echonest" else \
            "nyt-clicks.tsv"
        (raw / name).write_text("".join(
            f"user{u}\titem{m}\t{c}\n" for u, m, c in zip(
                rng.integers(0, 60, 1500), rng.integers(0, 40, 1500),
                rng.integers(1, 4, 1500))))
    flags = ["-" + case.split("-")[0], "-gen-heldout", "-seed", "4"]
    if case.endswith("-msr"):
        flags.append("-msr")
    jrc, trc, jout, tout, jd, td = _both(["-dir", str(raw), *flags],
                                         tmp_path, capsys)
    assert jrc == trc == 0 and tout == jout
    jfiles = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == jfiles and "train.tsv" in jfiles
    for name in jfiles:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name


@pytest.mark.parametrize("args", [
    ["-online"],
    ["-bogus"],
    ["-gen-heldout", "-mendeleyx"],
    ["-h"],
    [],
], ids=["online", "unknown", "unknown-after-mode", "help", "no-args"])
def test_cli_quit_paths_equal(dataset, tmp_path, capsys, monkeypatch,
                              args):
    """-online quits with the reference's message; unknown options fail
    with exit code 1; -h and no arguments print the usage and exit 0."""
    monkeypatch.chdir(tmp_path)
    if args and args[0] != "-h":
        args = ["-dir", str(dataset), *BASE] + args
    capsys.readouterr()
    jrc = jcli.main(list(args) if args else [])
    jout = capsys.readouterr().out
    trc = tcli.main(list(args) + (["-cpu"] if args else []))
    tout = capsys.readouterr().out
    assert trc == jrc
    if args in (["-h"], []):
        assert "-dir DATA" in tout and "-cpu" in tout
    else:
        assert tout.replace(str(tmp_path), "") == \
            jout.replace(str(tmp_path), "")


@pytest.mark.parametrize("flag", ["-dir", "-k", "-seed", "-load", "-trace",
                                  "-tail", "-test-items"])
def test_cli_missing_value_equal(flag):
    """An option missing its value ends both CLIs with the same message."""
    msgs = []
    for mod in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            mod.main(["-n", "5", flag])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == f"error: option {flag} requires a value"


@pytest.mark.parametrize("flags,needle", [
    (["-tail", "mxu"], "-tail mxu"),
], ids=["tail-mxu"])
def test_cli_rejects_unported_by_name(dataset, tmp_path, capsys, flags,
                                      needle):
    out = tmp_path / "never"
    rc = tcli.main(["-dir", str(dataset), *BASE, "-hier", *flags, "-cpu",
                    "-outdir", str(out)])
    assert rc == 1
    assert needle in capsys.readouterr().out
    assert not out.exists()


def test_cli_tail_pallas_and_env_select_the_kernel(dataset, tmp_path,
                                                   monkeypatch, capsys):
    """-tail pallas (and HGAPREC_TAIL=pallas) select the port's one tail
    implementation; HGAPREC_TAIL=mxu is rejected like the flag."""
    out = tmp_path / "o"
    args = ["-dir", str(dataset), *BASE, "-hier", "-sweep", "hybrid",
            "-max-iterations", "2", "-rfreq", "2", "-cpu", "-outdir",
            str(out)]
    assert tcli.main(args + ["-tail", "pallas"]) == 0
    monkeypatch.setenv("HGAPREC_TAIL", "pallas")
    assert tcli.main(args) == 0
    monkeypatch.setenv("HGAPREC_TAIL", "mxu")
    capsys.readouterr()
    assert tcli.main(args) == 1
    assert "-tail mxu" in capsys.readouterr().out


def test_cli_without_cuda_needs_cpu_flag(dataset, tmp_path, capsys,
                                         monkeypatch):
    """With no CUDA device and no -cpu the CLI names -cpu, returns 1 and
    runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never"
    rc = tcli.main(["-dir", str(dataset), *BASE, "-hier", "-outdir",
                    str(out)])
    assert rc == 1
    assert "-cpu" in capsys.readouterr().out
    assert not out.exists()


def _free_port() -> int:
    """A port that was free a moment ago: torchrun's launch (MASTER_PORT)
    can only be handed one so (the CLI's own spawned ranks take none)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_subprocess(args, timeout=300, world=None):
    """(exit code, stdout) of `python -m hgaprec_tpu_torch.cli args` in a
    session of its own: on a timeout the CLI and the ranks it started
    are killed together, and the test fails. With `world`, the command
    runs as that many ranks with torchrun's variables, and rank 0's exit
    code and output are returned."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ranks = [{}] if world is None else [
        dict(WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
             MASTER_ADDR="localhost", MASTER_PORT=str(port))
        for port in [_free_port()] for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hgaprec_tpu_torch.cli", *args],
        env=dict(os.environ, PYTHONPATH=root, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for extra in ranks]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
        pytest.fail(f"the sharded CLI run {args} hung")
    for p, out in zip(procs[1:], outs[1:]):
        assert p.returncode == 0, out
    return procs[0].returncode, outs[0]


def _rerank(outdir, dest, args, world=None):
    """The ranking files of `-gen-ranking` on a copy of `outdir`'s model
    in `dest`: {name: text}."""
    shutil.copytree(outdir, dest)
    for name in RANKING_FILES:
        os.remove(dest / name)
    rc, text = _cli_subprocess(args + ["-cpu", "-gen-ranking", "-outdir",
                                       str(dest)], world=world)
    assert rc == 0, text
    return {name: (dest / name).read_text() for name in RANKING_FILES}


RANKING_FILES = ("ranking.tsv", "itemrank.tsv", "meanrank.txt")


def _up_to_ties(text):
    """ranking.tsv's lines, and its (user, score) sequence: the order of
    items with equal scores is the top-k's own (a stable sort on one
    device, the ranks' candidates merged in a sharded run)."""
    rows = [tuple(line.split("\t")) for line in text.splitlines()]
    return sorted(rows), [(r[0], r[2]) for r in rows]


def _ll(path):
    return [float(r[2]) for r in _rows(path / "validation.txt")]


def test_cli_spawned_ranks_take_no_port(dataset, tmp_path, monkeypatch):
    """The ranks that `-cpu -devices 2` starts join through a file in a
    private temporary directory, not through a port chosen, released and
    handed on (which another process can take before rank 0 binds it):
    with the port a spawner would hand out held by another listener (the
    race made certain), three two-rank runs in a row each train, write
    their reports, meet at the barrier before teardown and exit 0, and no
    rendezvous directory is left behind."""
    import socket
    import tempfile
    taken = socket.create_server(("", 0), family=socket.AF_INET6,
                                 dualstack_ipv6=True)
    port = taken.getsockname()[1]
    # a spawner that picks a free port gets this one
    monkeypatch.setattr(tcli, "_free_port", lambda: port, raising=False)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", None)
    args = ["-dir", str(dataset), *BASE, "-rfreq", "3", "-max-iterations",
            "3", "-hier", "-cpu", "-devices", "2"]
    try:
        for run in range(3):
            out = tmp_path / f"run{run}"
            assert tcli.main(args + ["-outdir", str(out)]) == 0, run
            assert len(_rows(out / "validation.txt")) >= 2
            assert (out / "model.npz").exists()
            assert not list(tmp.glob("hgaprec_pg_*"))
    finally:
        taken.close()


def test_cli_failing_rank_output_reaches_the_caller(tmp_path, monkeypatch,
                                                   capsys):
    """A spawned rank's stdout and stderr are kept in its log in the
    rendezvous directory: when the rank fails, its exit code and its
    messages reach the caller's output, and the spawner exits 1 and
    leaves no directory behind."""
    import tempfile
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", None)
    script = ("import os, sys\n"
              "r = int(os.environ['RANK'])\n"
              "print(f'rank {r} of {os.environ[\"WORLD_SIZE\"]} trains')\n"
              "if r == 2:\n"
              "    print('gloo: Connection closed by peer', file=sys.stderr)\n"
              "    sys.exit(3)\n")
    monkeypatch.setattr(tcli, "_rank_command",
                        lambda argv: [sys.executable, "-c", script])
    assert tcli._spawn_workers(["-cpu"], 3) == 1
    out = capsys.readouterr().out
    assert "+ rank 2 of 3 exited with code 3; its output:" in out
    assert "rank 2 of 3 trains" in out
    assert "gloo: Connection closed by peer" in out
    assert "+ end of rank 2's output" in out
    assert not list(tmp.glob("hgaprec_pg_*"))


@pytest.mark.parametrize("flags", [[], ["-sweep", "hybrid"], ["-logl"]],
                         ids=["dense", "hybrid", "dense-logl"])
def test_cli_sharded_devices(dataset, tmp_path, capsys, flags):
    """`-cpu -devices 2` (two gloo ranks, each ingesting its own user
    rows) trains, reports and checkpoints: its validation trajectory is
    within 1e-4 relative of the port's single-device run and within
    5e-3 of the JAX package's `-devices 8` run (tests/test_cli.py:125);
    only rank 0 writes model.npz (the dense case ports
    test_cli_sharded_devices, the hybrid one
    test_cli_sharded_hybrid_devices). With -logl, logl.txt holds the
    training ELBO of every report, within 1e-4 relative of the port's
    single-device run and of the JAX package's single-device -logl run,
    as the -logl training case holds the two CLIs."""
    args = ["-dir", str(dataset), *BASE, "-rfreq", "3", "-max-iterations",
            "6", "-hier", *flags]
    out = tmp_path / "sharded"
    rc, text = _cli_subprocess(args + ["-cpu", "-devices", "2", "-outdir",
                                       str(out)])
    assert rc == 0, text
    assert "+ multi-host: process 0 of 2, 2 devices" in text
    assert "+ sharding over 2 devices" in text
    assert "(local rows slice(0, " in text      # rank 0 ingests its rows
    assert tcli.main(args + ["-cpu", "-outdir", str(tmp_path / "one")]) == 0
    # the JAX package's -devices 8 run writes no ELBO on the CPU mesh (its
    # gathered state holds no Elog), so -logl is held to its
    # single-device run below
    assert jcli.main([a for a in args if a != "-logl"] +
                     ["-devices", "8", "-outdir", str(tmp_path / "jax")]) == 0
    got, one = _ll(out), _ll(tmp_path / "one")
    jax8 = _ll(tmp_path / "jax")
    assert len(got) == len(one) == len(jax8) >= 3
    np.testing.assert_allclose(got, one, rtol=1e-4)
    for a, b in zip(got, jax8):
        assert abs(a - b) < 5e-3 * max(1.0, abs(b))
    if "-logl" in flags:
        assert jcli.main(args + ["-outdir", str(tmp_path / "jax1")]) == 0
        elbo = [float(r[0]) for r in _rows(out / "logl.txt")]
        assert len(elbo) == len(got)
        for ref in (tmp_path / "one", tmp_path / "jax1"):
            np.testing.assert_allclose(
                elbo, [float(r[0]) for r in _rows(ref / "logl.txt")],
                rtol=1e-4, err_msg=str(ref))
    for name in ("model.npz", "htheta.tsv", "precision.txt", "param.txt"):
        assert (out / name).exists(), name
    assert not (out / ".proc1" / "model.npz").exists()
    assert len(_rows(out / ".proc1" / "validation.txt")) == len(got)
    # the reports and the stop's ranking of test_users.tsv, through the
    # item-sharded top-k
    assert [r[0] for r in _rows(out / "precision.txt")] == \
        [r[0] for r in _rows(tmp_path / "one" / "precision.txt")]
    # each rank holds only its own users' rows, and the stop's ranking
    # files are still the single-device eval's of the same model (the
    # training masks, counts and item degrees of every user)
    want = _rerank(out, tmp_path / "rerank", args)
    assert len(_rows(out / "itemrank.tsv")) > 0
    assert _up_to_ties((out / "ranking.tsv").read_text()) == \
        _up_to_ties(want["ranking.tsv"])
    for name in ("itemrank.tsv", "meanrank.txt"):
        assert (out / name).read_text() == want[name], name


def test_cli_launched_gen_ranking_reads_every_row(dataset, tmp_path):
    """Under a launch of two ranks (torchrun's variables) a mode that does
    not train ingests every user's rows: `-gen-ranking` writes what the
    single process writes."""
    args = ["-dir", str(dataset), *BASE, "-rfreq", "3", "-max-iterations",
            "3", "-hier"]
    out = tmp_path / "one"
    assert tcli.main(args + ["-cpu", "-outdir", str(out)]) == 0
    want = _rerank(out, tmp_path / "single", args)
    got = _rerank(out, tmp_path / "launched", args, world=2)
    assert len(_rows(tmp_path / "single" / "itemrank.tsv")) > 0
    assert got == want


def test_cli_devices_clamped_to_one(dataset, tmp_path, capsys, monkeypatch):
    """With one device visible `-devices 2` says so and trains the
    sharded loop in this process over a world of one, which gives the
    single-device run's trajectory."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    args = ["-dir", str(dataset), *BASE, "-rfreq", "3", "-max-iterations",
            "6", "-hier", "-cpu"]
    capsys.readouterr()
    assert tcli.main(args + ["-devices", "2", "-outdir",
                             str(tmp_path / "w1")]) == 0
    text = capsys.readouterr().out
    assert "+ only 1 devices available (requested 2)" in text
    assert "+ sharding over 1 devices" in text
    assert tcli.main(args + ["-outdir", str(tmp_path / "one")]) == 0
    np.testing.assert_allclose(_ll(tmp_path / "w1"), _ll(tmp_path / "one"),
                               rtol=1e-4)
    assert (tmp_path / "w1" / "model.npz").exists()


def test_cli_sharded_teardown_releases_the_group(dataset, tmp_path,
                                                 monkeypatch):
    """A sharded CLI run lets go of its process group before it destroys
    it, so destroy_process_group joins the backend's threads: a gloo
    thread that lives on into interpreter exit aborts its rank
    ("terminate called without an active exception"). Here over a world
    of one in this process: once main returns, nothing holds the group
    and the SIGTERM handler is the one before the run."""
    import weakref
    import torch.distributed as dist
    from hgaprec_tpu_torch.parallel import distributed as tdist
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    groups = []
    real = tdist.initialize_from_env

    def spy(*args, **kw):
        joined = real(*args, **kw)
        groups.append(weakref.ref(dist.group.WORLD))
        return joined
    monkeypatch.setattr(tdist, "initialize_from_env", spy)
    before = signal.getsignal(signal.SIGTERM)
    assert tcli.main(["-dir", str(dataset), *BASE, "-rfreq", "3",
                      "-max-iterations", "3", "-hier", "-cpu", "-devices",
                      "2", "-outdir", str(tmp_path / "w1")]) == 0
    assert len(groups) == 1 and groups[0]() is None
    assert not dist.is_initialized()
    assert signal.getsignal(signal.SIGTERM) is before


def test_cli_sharded_resume_starts_from_the_model(dataset, tmp_path,
                                                  capsys, monkeypatch):
    """`-resume` with `-devices` continues from model.npz (the JAX
    sharded loop draws a fresh state and keeps only the iteration
    count): the sharded resumed run reports what the single-device
    resumed run reports from a copy of the same model."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    args = ["-dir", str(dataset), *BASE, "-rfreq", "3", "-hier", "-cpu"]
    out = tmp_path / "sharded"
    assert tcli.main(args + ["-max-iterations", "3", "-devices", "2",
                             "-outdir", str(out)]) == 0
    shutil.copytree(out, tmp_path / "one")
    capsys.readouterr()
    for d, extra in ((out, ["-devices", "2"]), (tmp_path / "one", [])):
        assert tcli.main(args + ["-max-iterations", "9", "-resume",
                                 "-outdir", str(d), *extra]) == 0
        assert "+ resuming from iteration 4" in capsys.readouterr().out
    got, want = _rows(out / "validation.txt"), \
        _rows(tmp_path / "one" / "validation.txt")
    assert [r[0] for r in got] == [r[0] for r in want] == ["6", "9"]
    np.testing.assert_allclose([float(r[2]) for r in got],
                               [float(r[2]) for r in want], rtol=1e-4)


def test_cli_trace_writes_profiler_trace(dataset, tmp_path):
    trace = tmp_path / "trace"
    rc = tcli.main(["-dir", str(dataset), *BASE, "-hier", "-rfreq", "2",
                    "-max-iterations", "2", "-cpu", "-outdir",
                    str(tmp_path / "o"), "-trace", str(trace)])
    assert rc == 0
    traces = [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and (trace / traces[0]).stat().st_size > 0


def test_cli_nmf_on_device(dataset, tmp_path, capsys):
    """-nmf factorizes on the run's device and ranks for test_users
    (the init comes from a torch.Generator, so the factors differ from
    the JAX package's; the files and their shapes are the same)."""
    jrc, trc, jout, tout, jd, td = _both(
        ["-dir", str(dataset), *BASE, "-nmf"], tmp_path, capsys)
    assert jrc == trc == 0 and tout == jout
    for name in ("nmf_theta.tsv", "nmf_beta.tsv", "ranking.tsv"):
        jr, tr = _rows(jd / name), _rows(td / name)
        assert len(tr) == len(jr) > 0, name
        assert [len(r) for r in tr] == [len(r) for r in jr], name


META = {
    "movielens": ("movies.dat", "read_movielens_metadata",
                  "1::Toy Story (1995)::Animation\n7::Sabrina (1995)::"
                  "Romance\n"),
    "netflix": ("movie_titles.txt", "read_netflix_metadata",
                "118,1996,The Bird Cage\n12263,2001,Shrek\n"),
    "mendeley": ("titles.dat", "read_mendeley_metadata",
                 "collaborative filtering for implicit feedback\n"
                 "variational inference review\n"),
    "nyt": ("nyt-titles.tsv", "read_nyt_metadata",
            "3|Op-Ed: On Things\n9|World Briefing\nx|skipped\n"),
    "nyt-titles": ("nyt-titles.tsv", "read_nyt_titles",
                   "3|Op-Ed: On Things\n9|World Briefing\n11\n"),
}


@pytest.mark.parametrize("case", list(META))
def test_metadata_readers_equal(tmp_path, case):
    """The title readers of the -test chain (tests/test_cli.py:288) read
    the same titles in both packages."""
    from hgaprec_tpu.data import readers as jreaders
    from hgaprec_tpu_torch.data import readers as treaders
    fname, fn, text = META[case]
    (tmp_path / fname).write_text(text)
    got = getattr(treaders, fn)(str(tmp_path / fname))
    assert got == getattr(jreaders, fn)(str(tmp_path / fname)) and got


@pytest.mark.parametrize("shape", [(30, 20, 3), (17, 41, 5)])
def test_nmf_updates_match_f64_replica(shape):
    """The port's update loop, from numpy-drawn (w0, h0), against the
    same Lee-Seung updates in f64 numpy."""
    from hgaprec_tpu_torch.ops.nmf import _EPS, multiplicative_updates
    n, m, k = shape
    rng = np.random.default_rng(n)
    v = rng.poisson(2.0, (n, m)).astype(np.float64)
    w0 = rng.uniform(1e-3, 1.0, (n, k))
    h0 = rng.uniform(1e-3, 1.0, (k, m))
    w, h = w0.copy(), h0.copy()
    for _ in range(20):
        h = h * (w.T @ v) / ((w.T @ w) @ h + _EPS)
        w = w * (v @ h.T) / (w @ (h @ h.T) + _EPS)
    f32 = dict(dtype=torch.float32)
    tw, th = multiplicative_updates(torch.tensor(v, **f32),
                                    torch.tensor(w0, **f32),
                                    torch.tensor(h0, **f32), 20)
    np.testing.assert_allclose(tw.numpy(), w, rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), h, rtol=1e-4)


def test_nmf_reconstructs(rng):
    """tests/test_cli.py:128 on the port: a rank-3 matrix comes back."""
    from hgaprec_tpu_torch.ops.nmf import nmf
    w = rng.gamma(2.0, 1.0, (30, 3)).astype(np.float32)
    h = rng.gamma(2.0, 1.0, (20, 3)).astype(np.float32)
    v = w @ h.T
    theta, beta = nmf(v, 3, "cpu", iters=300, seed=1)
    assert theta.shape == (30, 3) and beta.shape == (20, 3)
    err = np.linalg.norm(theta @ beta.T - v) / np.linalg.norm(v)
    assert err < 0.05


def test_coldstart_prefers_seed_neighbors(tmp_path, rng):
    """tests/test_cli.py's fold-in check on the port's trained state,
    and the scores equal the JAX fold-in's on that state."""
    from conftest import make_synthetic
    from hgaprec_tpu_torch.data.device import build_device_data
    from hgaprec_tpu_torch.models.state import state_to_numpy
    from hgaprec_tpu_torch.models.step import make_step
    from test_torch_step import port_store
    js, _, _ = make_synthetic(rng, n=40, m=30, density=0.3)
    store = port_store(js)
    cfg = TCfg(n=store.n, m=store.m, k=3)
    data = build_device_data(store, "cpu")
    state = t_init_state(cfg, 1, device="cpu")
    step = make_step(cfg)
    for _ in range(10):
        state = step(state, data)
    theta_e, scores = t_fold_in(state, cfg, [[0, 1], [2]])
    assert theta_e.shape == (2, 3)
    assert np.isfinite(scores).all() and (scores >= 0).all()
    npz = str(tmp_path / "state.npz")
    tck.save_npz(npz, state_to_numpy(state), 10)
    jst, _ = jck.load_npz(npz, JCfg(n=store.n, m=store.m, k=3))
    je, jsc = j_fold_in(jst, JCfg(n=store.n, m=store.m, k=3), [[0, 1], [2]])
    np.testing.assert_allclose(theta_e, je, rtol=1e-5)
    np.testing.assert_allclose(scores, jsc, rtol=1e-5)


@pytest.mark.cuda
def test_cli_trains_on_card_through_kernel(dataset, tmp_path):
    """HPF K=8, 3 iterations through the CLI on the card: the f32 dense
    kernel (kernel #1's "highest" route) is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from hgaprec_tpu_torch.ops import dense_fused as df
    df.fused_dense_sweep.launches = 0
    out = tmp_path / "card"
    rc = tcli.main(["-dir", str(dataset), "-n", str(N), "-m", str(M),
                    "-k", "8", "-hier", "-rfreq", "3", "-max-iterations",
                    "3", "-outdir", str(out)])
    assert rc == 0
    assert df.fused_dense_sweep.launches > 0
    ll = [float(r[2]) for r in _rows(out / "validation.txt")]
    assert len(ll) == 2 and np.isfinite(ll).all()


@pytest.mark.cuda
def test_cli_sharded_world_of_one_on_card(dataset, tmp_path):
    """`-devices 2` on one card: a world of one over NCCL in this process,
    whose validation trajectory is the single-device run's (1e-4
    relative) and which launches kernel #1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    if torch.cuda.device_count() != 1:
        pytest.skip("the world of one needs exactly one visible card")
    from hgaprec_tpu_torch.ops import dense_fused as df
    args = ["-dir", str(dataset), "-n", str(N), "-m", str(M), "-k", "8",
            "-hier", "-rfreq", "3", "-max-iterations", "6"]
    df.fused_dense_sweep.launches = 0
    assert tcli.main(args + ["-devices", "2", "-outdir",
                             str(tmp_path / "w1")]) == 0
    assert df.fused_dense_sweep.launches > 0
    assert tcli.main(args + ["-outdir", str(tmp_path / "one")]) == 0
    np.testing.assert_allclose(_ll(tmp_path / "w1"), _ll(tmp_path / "one"),
                               rtol=1e-4)
