"""Port streamed top-k and rank counter == the JAX package's (eval/topk.py).

At m = 70,000 items (above DEVICE_TOPK_THRESHOLD) with K = 4 and a few
users, both packages score item chunks in f32; values agree within f32
tolerance, ids wherever the values are distinct (`torch.topk` and
`jax.lax.top_k` may order ties differently), and ranks except where the
target's score has a near-tie (within 1e-6 relative) that the two f32
products may break differently. A Trainer at m > 65,536 writes its
precision report through the streamed top-k in both packages.
"""

import numpy as np
import pytest
import torch

from hgaprec_tpu.config import ModelConfig as JCfg
from hgaprec_tpu.config import RunConfig as JRun
from hgaprec_tpu.data.ratings import RatingsStore as JStore
from hgaprec_tpu.eval.ranking import EvalIndex as JIndex
from hgaprec_tpu.eval.ranking import build_mask_matrix as j_mask
from hgaprec_tpu.eval.score import Scorer as JScorer
from hgaprec_tpu.eval.topk import item_ranks as j_item_ranks
from hgaprec_tpu.eval.topk import masked_topk as j_masked_topk
from hgaprec_tpu.models.engine import Trainer as JTrainer
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.config import RunConfig as TRun
from hgaprec_tpu_torch.eval import ranking as t_ranking
from hgaprec_tpu_torch.eval.ranking import EvalIndex as TIndex
from hgaprec_tpu_torch.eval.ranking import build_mask_matrix as t_mask
from hgaprec_tpu_torch.eval.score import Scorer as TScorer
from hgaprec_tpu_torch.eval.topk import item_ranks, masked_topk
from hgaprec_tpu_torch.models.engine import Trainer as TTrainer
from test_torch_step import port_store

M = 70000


def _wide(n=24, m=M, per_user=900, seed=0):
    """A JAX store over m items (every item rated in training) with
    validation and test maps held out of the random part."""
    rng = np.random.default_rng(seed)
    cover = (np.arange(m) % n) * m + np.arange(m)
    rand = np.setdiff1d(np.repeat(np.arange(n), per_user) * m
                        + rng.integers(0, m, n * per_user), cover)
    hold = rng.random(rand.size)
    train = np.concatenate([cover, rand[hold < 0.9]])
    u, i = train // m, train % m
    js = JStore(n, m)
    js.add_training(u + 1, i + 1, rng.integers(1, 6, u.size))
    js.finalize()
    val, test = {}, {}
    for key, h in zip(rand[hold >= 0.9], hold[hold >= 0.9]):
        un = js.user2seq[int(key // m) + 1]
        mn = js.movie2seq[int(key % m) + 1]
        (val if h < 0.93 else test)[(un, mn)] = int(rng.integers(1, 6))
    return js, val, test


def _scorers(js, k, bias, seed):
    rng = np.random.default_rng(seed)
    su = rng.gamma(0.5, 1.0, (js.n, k)).astype(np.float32)
    sv = rng.gamma(0.5, 1.0, (js.m, k)).astype(np.float32)
    bu = rng.random(js.n).astype(np.float32) if bias else None
    bi = rng.random(js.m).astype(np.float32) if bias else None
    import jax.numpy as jnp
    j = JScorer(jnp.asarray(su), jnp.asarray(sv),
                None if bu is None else jnp.asarray(bu),
                None if bi is None else jnp.asarray(bi))
    t = TScorer(torch.from_numpy(su), torch.from_numpy(sv),
                None if bu is None else torch.from_numpy(bu),
                None if bi is None else torch.from_numpy(bi))
    return j, t


@pytest.fixture(scope="module")
def wide():
    js, val, test = _wide()
    ts = port_store(js)
    return (js, ts, JIndex(val, test, js), TIndex(val, test, ts), val,
            test)


def test_mask_matrix_round_to_equals_jax(wide):
    js, ts, ji, ti, _, _ = wide
    users = np.arange(0, js.n, 3, dtype=np.int32)
    for r in (1, 64):
        np.testing.assert_array_equal(t_mask(ts, ti, users, round_to=r),
                                      j_mask(js, ji, users, round_to=r))
    assert t_mask(ts, ti, users, round_to=64).shape[1] % 64 == 0


@pytest.mark.parametrize("bias", [False, True])
def test_masked_topk_equals_jax(wide, bias):
    js, ts, ji, ti, _, _ = wide
    jsc, tsc = _scorers(js, 4, bias, seed=1 + bias)
    users = np.arange(0, js.n, 2, dtype=np.int32)
    jv, jid = j_masked_topk(jsc, js, ji, users, k=100)
    tv, tid = masked_topk(tsc, ts, ti, users, k=100)
    assert tv.shape == (users.size, 100) and tid.dtype == np.int32
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-6, atol=1e-7)
    # ids wherever the value is distinct from its neighbours in the list
    v = np.asarray(jv)
    gap = np.minimum(np.abs(np.diff(v, axis=1, prepend=np.inf)),
                     np.abs(np.diff(v, axis=1, append=-np.inf)))
    distinct = gap > 1e-5 * np.abs(v)
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(tid[distinct], np.asarray(jid)[distinct])
    # masked train items never rank ahead of a positive score
    for r, n in enumerate(users):
        assert not np.isin(tid[r][tv[r] > 0], ts.items_of_user(int(n))).any()


@pytest.mark.parametrize("bias", [False, True])
def test_item_ranks_equal_jax(wide, bias):
    js, ts, ji, ti, _, test = wide
    jsc, tsc = _scorers(js, 4, bias, seed=5 + bias)
    pairs = sorted(test)[:300]
    pu = np.asarray([p[0] for p in pairs])
    pi = np.asarray([p[1] for p in pairs])
    jr, jt = j_item_ranks(jsc, js, ji, pu, pi, pair_chunk=128)
    tr, tt = item_ranks(tsc, ts, ti, pu, pi, pair_chunk=128)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=1e-6)
    # a rank may differ only by the items whose score ties the target's
    # within f32 noise of the two products
    su, sv = tsc.su.double(), tsc.sv.double()
    full = (su[torch.as_tensor(pu)] @ sv.T).numpy()
    if bias:
        full += tsc.bias_u.double().numpy()[pu][:, None] + \
            tsc.bias_i.double().numpy()[None, :]
    near = np.abs(full - tt[:, None].astype(np.float64)) <= \
        1e-6 * np.abs(tt[:, None])
    slack = near.sum(1)
    assert (np.abs(tr - np.asarray(jr)) <= slack).all()
    assert (tr == np.asarray(jr)).mean() > 0.95
    # the stable-argsort position on the host agrees (limit_m = M)
    r0 = int(np.argmax(slack == 1))
    s = t_ranking.masked_user_scores(tsc, ts, ti, pu[r0:r0 + 1])[0]
    order = np.argsort(-s, kind="stable")
    assert abs(int(np.where(order == pi[r0])[0][0]) - tr[r0]) <= slack[r0]


def test_precision_report_through_the_streamed_topk(tmp_path, wide,
                                                    monkeypatch):
    js, ts, _, _, val, test = wide
    calls = []
    real = t_ranking.masked_topk

    def spy(*args, **kw):
        calls.append(args[3].size)
        return real(*args, **kw)
    monkeypatch.setattr(t_ranking, "masked_topk", spy)
    run = dict(datdir=str(tmp_path), rfreq=2, max_iterations=2,
               num_precision_users=8)
    jtr = JTrainer(js, val, test, JCfg(n=js.n, m=js.m, k=3, variant="hpf"),
                   JRun(outdir=str(tmp_path / "jax"), **run))
    jtr.run()
    jtr.close()
    ttr = TTrainer(ts, val, test, TCfg(n=ts.n, m=ts.m, k=3, variant="hpf"),
                   TRun(outdir=str(tmp_path / "torch"), **run),
                   device="cpu")
    ttr.run()
    ttr.close()
    assert ts.m > t_ranking.DEVICE_TOPK_THRESHOLD and calls
    jp, tp = [(tmp_path / d / "precision.txt").read_text().split()
              for d in ("jax", "torch")]
    assert len(tp) == len(jp) > 0
    np.testing.assert_allclose([float(x) for x in tp],
                               [float(x) for x in jp], atol=1e-5)
