"""Cold-start fold-in: infer a fresh user's factors from seed items.

Port of `hgaprec_tpu/models/coldstart.py`. Generalizes the reference's
hand-run `test()` demo (hgaprec.cc:2257-2346): reset one user's theta row
to its prior, then run a few CAVI iterations over only the seed items
while beta stays frozen, and rank all items. Batched over any number of
fresh users, on the state's device; the iterations are a plain loop of
torch ops (an XLA `fori_loop` in the JAX package, no hand-written kernel).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.models.state import ModelState
from hgaprec_tpu_torch.ops.gamma import expectations


def _fold_in(beta_e: torch.Tensor, beta_elog: torch.Tensor,
             seed_items: torch.Tensor, k: int, iters: int, a: float,
             b: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """seed_items: long[U, S] item ids per fresh user (padded with -1)."""
    betarowsum = beta_e.sum(0)                                  # [K]
    valid = (seed_items >= 0)[:, :, None]
    items = seed_items.clamp_min(0)
    rate = b + betarowsum                                       # [K]

    def shape_of(elog_t):
        # phi per (user, seed item): softmax over k of Elog theta + Elog beta
        logits = elog_t[:, None, :] + beta_elog[items]          # [U, S, K]
        phi = torch.where(valid, torch.softmax(logits, -1), 0.0)
        return a + phi.sum(1)                                   # [U, K]

    # theta starts at the prior expectation like set_to_prior_curr +
    # compute_expectations (hgaprec.cc:2277-2278)
    shape0 = torch.full((seed_items.shape[0], k), a, dtype=beta_e.dtype,
                        device=beta_e.device)
    _, elog_t = expectations(shape0, torch.full_like(rate, b))
    for _ in range(iters):
        _, elog_t = expectations(shape_of(elog_t), rate)
    e, _ = expectations(shape_of(elog_t), rate)
    return e, e @ beta_e.T


def fold_in_users(state: ModelState, cfg: ModelConfig,
                  seed_items: Sequence[Sequence[int]], iters: int = 10
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (theta_e [U, K], scores [U, M]) for fresh users described
    by their seed item lists."""
    smax = max(len(s) for s in seed_items)
    mat = np.full((len(seed_items), smax), -1, np.int64)
    for r, s in enumerate(seed_items):
        mat[r, :len(s)] = s
    beta = state.beta
    e, scores = _fold_in(beta.e, beta.elog,
                         torch.as_tensor(mat, device=beta.e.device),
                         cfg.k, iters, cfg.a, cfg.b)
    return e.cpu().numpy(), scores.cpu().numpy()


def top_items(scores: np.ndarray, exclude: Sequence[Sequence[int]],
              topn: int = 20) -> list:
    """Top-N ranked item ids per fresh user, excluding seed items."""
    out = []
    for r in range(scores.shape[0]):
        s = scores[r].copy()
        s[np.asarray(list(exclude[r]), dtype=np.int64)] = -np.inf
        out.append(np.argsort(-s, kind="stable")[:topn].tolist())
    return out
