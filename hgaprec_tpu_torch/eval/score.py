"""Prediction scores s(n, m) (port of `hgaprec_tpu/eval/score.py`).

Reference: prediction_score / prediction_score_hier (hgaprec.cc:1850-1991)
and rating_likelihood[_hier] (1503-1560). Score = E[theta]·E[beta]
(+ bias expectations), with point-estimate matrices substituted for the
MLE/Canny variants, and imported factor matrices for the baseline bridges
(prediction_score_{nmf,lda,chi,ctr}, hgaprec.cc:1893-1966). Raw rate is
the ranking score
(_use_rate_as_score = true, hgaprec.cc:30). The [S, M] score product is a
plain f32 `torch.matmul`, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hgaprec_tpu_torch import config as C
from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.models.state import ModelState


class Scorer(NamedTuple):
    """score(n, m) = su[n]·sv[m] + bias_u[n] + bias_i[m]."""
    su: torch.Tensor                 # [N, K]
    sv: torch.Tensor                 # [M, K]
    bias_u: Optional[torch.Tensor]   # [N] or None
    bias_i: Optional[torch.Tensor]   # [M] or None


def scorer_from_state(state: ModelState, cfg: ModelConfig) -> Scorer:
    if cfg.variant == C.VARIANT_MLE_USER:
        su, sv = state.theta_mle, state.beta.e
    elif cfg.variant in (C.VARIANT_MLE_ITEM, C.VARIANT_CANNY):
        su, sv = state.theta.e, state.beta_mle
    else:
        su, sv = state.theta.e, state.beta.e
    bu = state.theta_bias.e if cfg.bias else None
    bi = state.beta_bias.e if cfg.bias else None
    return Scorer(su, sv, bu, bi)


def scorer_from_foreign(theta, beta, device) -> Scorer:
    """Imported factors (NMF / LDA / graphchi / CTR bridges) as f32
    tensors on `device`. The bridges import no biases and no global
    offset (the JAX CLI's callers pass none either)."""
    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)
    return Scorer(tensor(theta), tensor(beta), None, None)


def _index(x: torch.Tensor, idx) -> torch.Tensor:
    return x[torch.as_tensor(idx, dtype=torch.long, device=x.device)]


def user_scores(sc: Scorer, users) -> torch.Tensor:
    """[len(users), M] score matrix on the scorer's device."""
    s = _index(sc.su, users) @ sc.sv.T
    if sc.bias_u is not None:
        s = s + _index(sc.bias_u, users)[:, None] + sc.bias_i[None, :]
    return s


def pair_scores(sc: Scorer, u, i) -> torch.Tensor:
    s = (_index(sc.su, u) * _index(sc.sv, i)).sum(1)
    if sc.bias_u is not None:
        s = s + _index(sc.bias_u, u) + _index(sc.bias_i, i)
    return s


def pair_loglik(sc: Scorer, u, i, y: torch.Tensor, binary: bool):
    """Total and per-pair heldout log-likelihood for (u, i, y) arrays."""
    s = torch.clamp_min(pair_scores(sc, u, i), 1e-30)  # floor (hgaprec.cc:1531)
    if binary:
        # y==0 ? -s : log(1 - exp(-s))   (hgaprec.cc:1533-1534)
        ll = torch.where(y == 0, -s, torch.log(-torch.expm1(-s)))
    else:
        # y log s - s - log y!           (hgaprec.cc:1535, 1563-1570)
        ll = y * torch.log(s) - s - torch.lgamma(y + 1.0)
    return ll.sum(), ll
