"""The port's factor exploration == the JAX package's.

Each case of tests/test_explore.py runs against both packages'
`eval/explore.py` (and, for the marginal fits, `eval/analysis.py`) on the
same inputs; the results must be equal.
"""

import numpy as np
import pytest

from hgaprec_tpu.eval import analysis as janalysis
from hgaprec_tpu.eval import explore as jexplore
from hgaprec_tpu_torch.eval import analysis as tanalysis
from hgaprec_tpu_torch.eval import explore as texplore
from test_torch_formats import assert_same


def _beta():
    # 6 items x 3 factors; factor 2 is degenerate (one active item)
    return np.array([[9.0, 0.1, 0.0], [8.0, 0.2, 0.0], [0.1, 7.0, 0.0],
                     [0.2, 6.0, 0.0], [0.3, 0.3, 5.0], [7.0, 0.1, 0.0]])


NAMES = dict(names={10: "A", 11: "B", 15: "F"},
             seq2movie={0: 10, 1: 11, 5: 15})


def _top_items_by_factor(ex, an):
    return [ex.top_items_by_factor(_beta(), f, topn=3, **NAMES)
            for f in range(3)] + [ex.top_items_by_factor(_beta(), 1)]


def _degenerate_factor_skipped(ex, an):
    theta = np.array([[0.1, 0.2, 9.0], [3.0, 1.0, 2.0]])
    return (ex.active_items_per_factor(_beta()),
            ex.active_items_per_factor(_beta(), threshold=6.5),
            [ex.top_factors_of_user(theta, u, topn=2, beta_e=_beta())
             for u in range(2)],
            ex.top_factors_of_user(theta, 0, topn=3))


def _related_items(ex, an):
    return (ex.related_items(_beta(), 0, per_factor=3, n_factors=1),
            ex.related_items(_beta(), 4, per_factor=2, n_factors=2,
                             **NAMES))


def _factor_report(ex, an):
    return (ex.format_factor_report(_beta(), [0, 1], topn=2),
            ex.format_factor_report(_beta(), [2, 0], topn=4, **NAMES))


def _marginal_fit(ex, an):
    rng = np.random.default_rng(0)
    counts = rng.poisson(rng.gamma(0.5, 40.0, 4000))
    gauss = np.clip(np.random.default_rng(1).normal(1000, 5, 4000), 1,
                    None).round()
    return an.marginal_fit_report(counts), an.marginal_fit_report(gauss)


CASES = {f.__name__[1:]: f for f in (
    _top_items_by_factor, _degenerate_factor_skipped, _related_items,
    _factor_report, _marginal_fit)}


@pytest.mark.parametrize("case", list(CASES))
def test_explore_equal(case):
    assert_same(CASES[case](texplore, tanalysis),
                CASES[case](jexplore, janalysis))
