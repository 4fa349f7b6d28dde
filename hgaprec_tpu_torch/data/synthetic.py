"""Synthetic data from the HPF generative model (arXiv:1311.1704 §2).

Used by the tests and by chip_smoke.py, which ship no datasets. Draws xi/eta activity/popularity
scales, Gamma factor matrices, and Poisson counts, yielding realistic
long-tailed user/item degree distributions at any (n, m) scale.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_pf_counts(rng: np.random.Generator, n: int, m: int, k: int = 5,
                       a: float = 0.3, ap: float = 1.5, b: float = 0.3,
                       scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Sample sparse counts (u, i, y) from the hierarchical model."""
    xi = rng.gamma(ap, 1.0 / b, size=n)          # user activity
    eta = rng.gamma(ap, 1.0 / b, size=m)         # item popularity
    theta = rng.gamma(a, 1.0 / xi[:, None], size=(n, k))
    beta = rng.gamma(a, 1.0 / eta[:, None], size=(m, k))
    rate = scale * theta @ beta.T
    y = rng.poisson(rate)
    u, i = np.nonzero(y)
    return u.astype(np.int64), i.astype(np.int64), y[u, i].astype(np.int64)


def write_pf_dataset(outdir: str, rng: np.random.Generator, n: int, m: int,
                     k: int = 5, scale: float = 1.0,
                     test_frac: float = 0.2, valid_frac: float = 0.01,
                     clip: int = 255, **kw) -> int:
    """Write train/validation/test/test_users TSVs; returns nnz.

    Counts are clipped at 255 by default: the reference stores ratings in
    uint8 (yval_t, env.hh:20) and silently wraps larger values mod 256, so
    emitting counts a uint8 can hold keeps both stacks reading identical
    data (real rating datasets never exceed this anyway)."""
    import os
    os.makedirs(outdir, exist_ok=True)
    u, i, y = generate_pf_counts(rng, n, m, k=k, scale=scale, **kw)
    if clip:
        y = np.minimum(y, clip)
    r = rng.random(u.size)
    splits = {
        "train.tsv": r >= test_frac + valid_frac,
        "test.tsv": r < test_frac,
        "validation.tsv": (r >= test_frac) & (r < test_frac + valid_frac),
    }
    for fname, sel in splits.items():
        with open(os.path.join(outdir, fname), "w") as f:
            f.write("".join(f"{a + 1}\t{b + 1}\t{c}\n" for a, b, c in
                            zip(u[sel], i[sel], y[sel])))
    test_users = np.unique(u[r < test_frac])
    with open(os.path.join(outdir, "test_users.tsv"), "w") as f:
        f.write("".join(f"{a + 1}\n" for a in test_users))
    return int(u.size)
