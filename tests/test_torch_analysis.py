"""The port's analysis curves and raw-data readers == the JAX package's.

Each case of tests/test_analysis.py, and the rest of `eval/analysis.py`'s
and `data/readers.py`'s surface, runs against both packages' modules on
the same inputs; the results and the bytes of every file written must be
equal.
"""

import numpy as np
import pytest

from hgaprec_tpu.data import ratings as jratings
from hgaprec_tpu.data import readers as jreaders
from hgaprec_tpu.eval import analysis as janalysis
from hgaprec_tpu_torch.data import ratings as tratings
from hgaprec_tpu_torch.data import readers as treaders
from hgaprec_tpu_torch.eval import analysis as tanalysis
from test_torch_formats import _files, assert_same

JAX = dict(an=janalysis, readers=jreaders, ratings=jratings)
PORT = dict(an=tanalysis, readers=treaders, ratings=tratings)


def _ranking(seed=0):
    """ranking.tsv-shaped rows: 6 users x 12 recommendations."""
    rng = np.random.default_rng(seed)
    rows = [[u, i, rng.random(), float(rng.random() < 0.3)]
            for u in range(100, 106) for i in rng.permutation(40)[:12]]
    return np.asarray(rows)


def _precision_recall(m, d):
    ranking = np.asarray([[7, 1, 0.9, 1], [7, 2, 0.8, 0], [7, 3, 0.7, 1],
                          [7, 4, 0.6, 0]])
    return (m["an"].precision_recall_curves(ranking, {7: 3},
                                            num_recs=(2, 4)),
            m["an"].precision_recall_curves(
                _ranking(), {100 + u: u + 1 for u in range(5)}),
            m["an"].mean_precision_at(_ranking(1), {103: 4, 104: 0}, n=5),
            m["an"].hits_by_user(_ranking(2), num_recs=(1, 5, 20)))


def _roc(m, d):
    rng = np.random.default_rng(5)
    truth = np.asarray([1, 1, 0, 0])
    return (m["an"].roc_curve(truth, np.asarray([0.9, 0.8, 0.2, 0.1])),
            m["an"].roc_curve(truth, np.asarray([0.2, 0.9, 0.8, 0.1])),
            m["an"].roc_curve(rng.random(50) < 0.4, rng.random(50)))


def _coverage_and_ranking_file(m, d):
    ranking = _ranking(3)
    path = d / "ranking.tsv"
    path.write_text("".join(f"{int(u)}\t{int(i)}\t{p:.5f}\t{int(a)}\n"
                            for u, i, p, a in ranking))
    return (m["an"].load_ranking_tsv(str(path)),
            m["an"].coverage_by_item(ranking, num_recs=(3, 12)))


def _test_items_per_user(m, d):
    store = m["ratings"].RatingsStore(10, 10)
    store.add_training([5, 6, 7], [1, 2, 3], [1, 1, 1])
    store.finalize()
    test = {(0, 1): 2, (0, 2): 1, (1, 0): 3, (2, 2): 0}
    return (m["an"].test_items_per_user(test),
            m["an"].test_items_per_user(test, store))


def _marginal_fits(m, d):
    rng = np.random.default_rng(0)
    over = rng.poisson(rng.gamma(0.5, 40.0, 4000))
    gauss = np.clip(np.random.default_rng(1).normal(1000, 5, 4000), 1,
                    None).round()
    return (m["an"].negative_binomial_fit(over),
            m["an"].negative_binomial_fit(gauss),
            m["an"].marginal_fit_report(over),
            m["an"].marginal_fit_report(gauss))


def _movielens_reader(m, d):
    (d / "ratings.dat").write_text("1::10::5::978300760\n2::20::3::9783021\n")
    (d / "ratings.tsv").write_text("3\t30\t4\n4\t40\t1\n")
    return (m["readers"].read_movielens(str(d / "ratings.dat")),
            m["readers"].read_movielens(str(d / "ratings.tsv")))


def _netflix_reader(m, d):
    (d / "mv_0000001.txt").write_text("1:\n6,4,2005-09-06\n7,5,x\n")
    (d / "mv_0000002.txt").write_text("2:\n6,3,2005-09-06\n")
    (d / "mv_0000003.txt").write_text("3:\n8,1,2005-09-06\n")
    return (m["readers"].read_netflix_dir(str(d)),
            m["readers"].read_netflix_dir(str(d), max_movies=2))


def _mendeley_reader(m, d):
    (d / "users.dat").write_text("3 5 9 11\n1 2\n")
    return m["readers"].read_mendeley(str(d / "users.dat"))


def _triplets_reader(m, d):
    (d / "t.txt").write_text("ua\tsong1\t3\nub\tsong1\t1\nua\tsong2\t2\n")
    return m["readers"].read_triplets(str(d / "t.txt"))


def _create_train_test_sets(m, d):
    rng = np.random.default_rng(42)
    u, i = rng.integers(1, 50, 2000), rng.integers(1, 40, 2000)
    y = rng.integers(1, 6, 2000)
    counts = m["readers"].create_train_test_sets(
        u, i, y, str(d), heldout_ratio=0.2, validation_ratio=0.05, seed=1)
    store, _, _ = m["ratings"].load_dataset(str(d), 50, 40, False, 1)
    return counts, store.nratings, _files(d)


def _leave_one_out_split(m, d):
    u = np.repeat(np.arange(1, 21), 10)
    i = np.tile(np.arange(1, 11), 20)
    counts = m["readers"].create_train_test_sets(
        u, i, np.ones(200, np.int64), str(d), leave_one_out=True, seed=2)
    return counts, _files(d)


CASES = {f.__name__[1:]: f for f in (
    _precision_recall, _roc, _coverage_and_ranking_file,
    _test_items_per_user, _marginal_fits, _movielens_reader,
    _netflix_reader, _mendeley_reader, _triplets_reader,
    _create_train_test_sets, _leave_one_out_split)}


@pytest.mark.parametrize("case", list(CASES))
def test_analysis_and_readers_equal(tmp_path, case):
    results = []
    for name, mods in (("jax", JAX), ("torch", PORT)):
        d = tmp_path / name
        d.mkdir()
        results.append(CASES[case](mods, d))
    assert_same(results[1], results[0])
