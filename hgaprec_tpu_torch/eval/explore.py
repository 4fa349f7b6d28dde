"""Qualitative factor exploration — native replacement for plots/src/mlens.R.

The port's copy of `hgaprec_tpu/eval/explore.py` (NumPy only).

The reference explores a fitted model interactively in R: top items per
factor (mlens.R top_movies_by_factor), the dominant factors of a user
(show_top_user_factors, skipping degenerate factors with <=1 active
item), and "related movies" = top items of the strongest factors of a
seed item (show_related_movies). These are small NumPy reductions over
the exported expectation tables.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def top_items_by_factor(beta_e: np.ndarray, factor: int, topn: int = 20,
                        names: Optional[Dict[int, str]] = None,
                        seq2movie: Optional[Dict[int, int]] = None
                        ) -> List[Tuple[int, float, str]]:
    """Top `topn` items by E[beta] weight in one factor
    (mlens.R top_movies_by_factor). Returns (item_seq, weight, name)."""
    col = np.asarray(beta_e)[:, factor]
    order = np.argsort(-col)[:topn]
    out = []
    for s in order:
        ext = seq2movie.get(int(s), int(s)) if seq2movie else int(s)
        nm = names.get(ext, "") if names else ""
        out.append((int(s), float(col[s]), nm))
    return out


def active_items_per_factor(beta_e: np.ndarray,
                            threshold: float = 1e-5) -> np.ndarray:
    """Count of items with weight > threshold per factor — mlens.R skips
    'unused' factors where <=1 item is active (as.logical on the loaded
    beta, mlens.R). The default matches the reference's effective
    predicate: beta reaches R through a %.5f TSV export, so entries below
    ~1e-5 print as 0 and count as inactive."""
    b = np.asarray(beta_e)
    return (b > threshold).sum(axis=0)


def top_factors_of_user(theta_e: np.ndarray, user: int, topn: int = 3,
                        beta_e: Optional[np.ndarray] = None
                        ) -> List[int]:
    """The user's strongest factors, skipping degenerate ones
    (show_top_user_factors, mlens.R:12-31)."""
    row = np.asarray(theta_e)[user]
    order = np.argsort(-row)
    if beta_e is None:
        return [int(f) for f in order[:topn]]
    active = active_items_per_factor(beta_e)
    picked = [int(f) for f in order if active[f] > 1]
    return picked[:topn]


def related_items(beta_e: np.ndarray, item: int, per_factor: int = 20,
                  n_factors: int = 3,
                  names: Optional[Dict[int, str]] = None,
                  seq2movie: Optional[Dict[int, int]] = None
                  ) -> Dict[int, List[Tuple[int, float, str]]]:
    """Items sharing the seed item's strongest factors
    (show_related_movies, mlens.R:34-54): factor -> top items."""
    row = np.asarray(beta_e)[item]
    facs = np.argsort(-row)[:n_factors]
    return {int(f): top_items_by_factor(beta_e, int(f), per_factor,
                                        names, seq2movie)
            for f in facs}


def format_factor_report(beta_e: np.ndarray,
                         factors: Sequence[int], topn: int = 20,
                         names: Optional[Dict[int, str]] = None,
                         seq2movie: Optional[Dict[int, int]] = None) -> str:
    """Printable 'FACTOR k' blocks like mlens.R top_movies_by_factor."""
    lines = []
    for f in factors:
        lines.append(f"FACTOR {f}")
        for s, w, nm in top_items_by_factor(beta_e, f, topn, names,
                                            seq2movie):
            lines.append(f"  {s}\t{w:.6f}\t{nm}")
    return "\n".join(lines)
