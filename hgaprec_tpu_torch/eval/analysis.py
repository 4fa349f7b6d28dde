"""Offline metric curves — native replacement for the R analysis layer.

The port's copy of `hgaprec_tpu/eval/analysis.py` (NumPy and SciPy).

Reproduces plots/src/analysis.R on ranking.tsv:
  * hits@n per user: rows sorted by predicted desc, cumulative `actual`
    sampled at num_recs = 10..100 (compute.hits.by.user, analysis.R:24-30)
  * precision@n = hits / min(num.test.items, n)   (analysis.R:108-110)
  * recall@n    = hits / num.test.items           (analysis.R:117-118)
  * coverage-by-item curves                        (analysis.R:36-62)
plus ROC/AUC from (truth, score) pairs — the capability of the bundled
roceasy tool (src/roceasy.c, not in the reference build).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


def load_ranking_tsv(path: str) -> np.ndarray:
    """ranking.tsv rows: user, item, predicted, actual(0/1)."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 4:
                rows.append((int(p[0]), int(p[1]), float(p[2]), int(p[3])))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 4)


def hits_by_user(ranking: np.ndarray,
                 num_recs: Sequence[int] = tuple(range(10, 101, 10))
                 ) -> Dict[int, np.ndarray]:
    """cumsum of actual at each cutoff, per user (analysis.R:24-30).
    Cutoffs beyond a user's row count yield the final cumsum (R indexing
    past the end gives NA; we saturate instead, which matches top-100
    files where every user has max rows anyway)."""
    out: Dict[int, np.ndarray] = {}
    users = ranking[:, 0].astype(np.int64)
    for uid in np.unique(users):
        rows = ranking[users == uid]
        rows = rows[np.argsort(-rows[:, 2], kind="stable")]
        cum = np.cumsum(rows[:, 3])
        idx = np.minimum(np.asarray(num_recs) - 1, cum.size - 1)
        out[int(uid)] = np.where(np.asarray(num_recs) - 1 < cum.size,
                                 cum[idx], cum[-1] if cum.size else 0.0)
    return out


def precision_recall_curves(ranking: np.ndarray,
                            num_test_items: Dict[int, int],
                            num_recs: Sequence[int] = tuple(
                                range(10, 101, 10))
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean precision@n and recall@n over users (analysis.R:104-125).

    precision@n = hits / min(num.test.items, n); recall@n = hits / ntest.
    Users without test items are skipped (NA-equivalent)."""
    hbu = hits_by_user(ranking, num_recs)
    nr = np.asarray(num_recs, np.float64)
    precs, recs = [], []
    for uid, hits in hbu.items():
        nt = num_test_items.get(uid, 0)
        if nt <= 0:
            continue
        precs.append(hits / np.minimum(nt, nr))
        recs.append(hits / nt)
    if not precs:
        z = np.zeros(len(num_recs))
        return z, z
    return (np.mean(np.asarray(precs), axis=0),
            np.mean(np.asarray(recs), axis=0))


def mean_precision_at(ranking: np.ndarray,
                      num_test_items: Dict[int, int], n: int = 20) -> float:
    """The paper's headline mean precision@20 (arXiv:1311.1704)."""
    p, _ = precision_recall_curves(ranking, num_test_items, (n,))
    return float(p[0])


def test_items_per_user(test_map, store=None) -> Dict[int, int]:
    """num.test.items per user keyed by EXTERNAL id (for ranking.tsv) —
    test_user_degree.tsv equivalent. Only hits count (test_hit)."""
    out: Dict[int, int] = {}
    for (n, m), v in test_map.items():
        if store is not None:
            if not store.test_hit(v):
                continue
            n = store.seq2user[n]
        out[n] = out.get(n, 0) + 1
    return out


def roc_curve(truth: np.ndarray, score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(fpr, tpr, auc) — src/roceasy.c capability."""
    truth = np.asarray(truth) > 0
    order = np.argsort(-np.asarray(score), kind="stable")
    truth = truth[order]
    tp = np.cumsum(truth)
    fp = np.cumsum(~truth)
    p = max(int(truth.sum()), 1)
    n = max(int((~truth).sum()), 1)
    tpr = np.concatenate([[0.0], tp / p])
    fpr = np.concatenate([[0.0], fp / n])
    auc = float(np.trapezoid(tpr, fpr))
    return fpr, tpr, auc


def coverage_by_item(ranking: np.ndarray,
                     num_recs: Sequence[int] = tuple(range(10, 101, 10))
                     ) -> Dict[int, np.ndarray]:
    """#users with the item hit inside their top-n (analysis.R:36-62)."""
    users = ranking[:, 0].astype(np.int64)
    out: Dict[int, list] = {}
    for uid in np.unique(users):
        rows = ranking[users == uid]
        rows = rows[np.argsort(-rows[:, 2], kind="stable")]
        for rank, (_, item, _, actual) in enumerate(rows, start=1):
            if actual > 0:
                out.setdefault(int(item), []).append(rank)
    return {item: np.asarray([sum(r <= n for r in ranks)
                              for n in num_recs])
            for item, ranks in out.items()}


def negative_binomial_fit(counts: np.ndarray,
                          iters: int = 200) -> Tuple[float, float]:
    """Method-of-moments NB fit to a degree marginal — the capability of
    plots/src/marg.R (user-activity / item-popularity marginals)."""
    counts = np.asarray(counts, np.float64)
    mu = counts.mean()
    var = counts.var()
    if var <= mu:
        return float("inf"), mu  # ~Poisson
    r = mu * mu / (var - mu)
    return float(r), float(mu)


def _nb_loglik(counts: np.ndarray, r: float, mu: float) -> float:
    from scipy.special import gammaln
    p = r / (r + mu)
    c = np.asarray(counts, np.float64)
    return float(np.sum(gammaln(c + r) - gammaln(r) - gammaln(c + 1)
                        + r * np.log(p) + c * np.log1p(-p)))


def marginal_fit_report(counts: np.ndarray) -> Dict[str, float]:
    """NB vs Gaussian fit comparison for a degree marginal.

    plots/src/marg.R fits both (fitdistr 'negative binomial' / 'normal',
    marg.R:40-92) and compares them visually; here the comparison is by
    per-sample log-likelihood and AIC — the paper's point is that NB
    wins decisively on user-activity/item-popularity marginals."""
    c = np.asarray(counts, np.float64)
    n = c.size
    mean, sd = c.mean(), max(c.std(), 1e-12)
    ll_gauss = float(-0.5 * n * np.log(2 * np.pi * sd * sd)
                     - 0.5 * np.sum((c - mean) ** 2) / (sd * sd))
    r, mu = negative_binomial_fit(c)
    if np.isfinite(r):
        ll_nb = _nb_loglik(c, r, mu)
    else:  # Poisson limit
        from scipy.special import gammaln
        ll_nb = float(np.sum(c * np.log(max(mu, 1e-12)) - mu
                             - gammaln(c + 1)))
    return {
        "n": float(n), "nb_r": float(r), "nb_mu": float(mu),
        "gauss_mean": float(mean), "gauss_sd": float(sd),
        "loglik_nb": ll_nb, "loglik_gauss": ll_gauss,
        "aic_nb": 2 * 2 - 2 * ll_nb, "aic_gauss": 2 * 2 - 2 * ll_gauss,
        "nb_wins": float(ll_nb > ll_gauss),
    }
