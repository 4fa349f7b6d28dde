"""The slice as a whole: the port's Trainer == the JAX Trainer.

Both train HPF on the same synthetic store and write their output-file
contracts; the validation log-likelihood per report agrees to 1e-4
relative, the stopping report and the ranked items are equal (same eval
RNG seed), and each package reads the other's model.npz.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import make_synthetic
from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.config import RunConfig as JRun
from hgaprec_tpu.io.checkpoint import load_npz as j_load_npz
from hgaprec_tpu.models.engine import Trainer as JTrainer
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.config import RunConfig as TRun
from hgaprec_tpu_torch.models.engine import Trainer as TTrainer
from test_torch_step import port_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


def _run_both(tmp_path, rng, model_kw=None, **run_kw):
    js, val, test = make_synthetic(rng, n=40, m=30, k=3)
    with open(tmp_path / "test_users.tsv", "w") as f:
        f.write("".join(f"{js.seq2user[u]}\n" for (u, _) in sorted(test)))
    kw = dict(datdir=str(tmp_path), rfreq=5, max_iterations=20,
              num_precision_users=10, **run_kw)
    model_kw = model_kw or dict(variant="hpf", sweep="dense")
    jtr = JTrainer(js, val, test, JCfg(n=js.n, m=js.m, k=3, **model_kw),
                   JRun(outdir=str(tmp_path / "jax"), **kw))
    jtr.run()
    jtr.close()
    ttr = TTrainer(port_store(js), val, test,
                   TCfg(n=js.n, m=js.m, k=3, **model_kw),
                   TRun(outdir=str(tmp_path / "torch"), **kw), device="cpu")
    ttr.run()
    ttr.close()
    return tmp_path / "jax", tmp_path / "torch", ttr


def test_trainers_agree(tmp_path, rng):
    jdir, tdir, ttr = _run_both(tmp_path, rng)
    for name in ("param.txt", "validation.txt", "test.txt", "precision.txt",
                 "max.txt", "htheta.tsv", "hbeta.tsv", "model.npz",
                 "ranking.tsv", "itemrank.tsv", "byusers.tsv"):
        assert (tdir / name).exists(), name
    for name in ("validation.txt", "test.txt"):
        jr, tr = _rows(jdir / name), _rows(tdir / name)
        assert [r[0] for r in tr] == [r[0] for r in jr]       # iterations
        assert [r[3] for r in tr] == [r[3] for r in jr]       # pair counts
        np.testing.assert_allclose([float(r[2]) for r in tr],
                                   [float(r[2]) for r in jr], rtol=1e-4)
    jm, tm = _rows(jdir / "max.txt")[0], _rows(tdir / "max.txt")[0]
    assert (tm[0], tm[3]) == (jm[0], jm[3])   # stopping iteration and why
    assert [r[0] for r in _rows(tdir / "precision.txt")] == \
        [r[0] for r in _rows(jdir / "precision.txt")]
    np.testing.assert_allclose(
        [[float(x) for x in r[1:]] for r in _rows(tdir / "precision.txt")],
        [[float(x) for x in r[1:]] for r in _rows(jdir / "precision.txt")])
    for name in ("ranking.tsv", "itemrank.tsv"):
        jr, tr = _rows(jdir / name), _rows(tdir / name)
        assert len(tr) == len(jr) > 0
        keep = [0, 1, 3] if name == "ranking.tsv" else [0, 1, 3, 4]
        assert [[r[c] for c in keep] for r in tr] == \
            [[r[c] for c in keep] for r in jr]
    assert (tdir / "param.txt").read_text() == (jdir / "param.txt").read_text()

    # the port's checkpoint loads through the JAX package and matches
    cfg = JCfg(n=ttr.store.n, m=ttr.store.m, k=3, variant="hpf")
    jt_state, jt_it = j_load_npz(str(tdir / "model.npz"), cfg)
    jj_state, jj_it = j_load_npz(str(jdir / "model.npz"), cfg)
    assert jt_it == jj_it
    np.testing.assert_array_equal(np.asarray(jt_state.theta.e),
                                  ttr.state.theta.e.numpy())
    np.testing.assert_allclose(np.asarray(jt_state.beta.e),
                               np.asarray(jj_state.beta.e), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("model_kw", [
    dict(variant="hpf", sweep="segment"),
    dict(variant="bpf", bias=True, sweep="segment-chunked"),
    dict(variant="mle_user", sweep="dense"),
    dict(variant="mle_item", sweep="dense"),
    dict(variant="canny", sweep="segment"),
], ids=["hpf-segment", "bpf-bias-chunked", "mle_user", "mle_item", "canny"])
def test_trainers_agree_with_logl(tmp_path, rng, model_kw):
    """The segment sweeps and the MLE/Canny variants through both
    Trainers with -logl: the same reports, validation ll and training
    ELBO per report (1e-4 relative), and the same stopping report."""
    jdir, tdir, _ = _run_both(tmp_path, rng, model_kw, logl=True,
                              enforce_max_iterations=True)
    for name in ("validation.txt", "logl.txt"):
        jr, tr = _rows(jdir / name), _rows(tdir / name)
        assert len(tr) == len(jr) >= 3, name
        col = 2 if name == "validation.txt" else 0
        if col:
            assert [r[0] for r in tr] == [r[0] for r in jr]
        np.testing.assert_allclose([float(r[col]) for r in tr],
                                   [float(r[col]) for r in jr], rtol=1e-4,
                                   err_msg=name)
    jm, tm = _rows(jdir / "max.txt")[0], _rows(tdir / "max.txt")[0]
    assert (tm[0], tm[3]) == (jm[0], jm[3])
    for name in ("model.npz", "itemrank.tsv"):     # saved as JAX saves
        assert (tdir / name).exists() == (jdir / name).exists(), name


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import hgaprec_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 13, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'hgaprec_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
