"""Training ELBO: the reference logl() (hgaprec.cc:2160-2255) on the device.

Port of `hgaprec_tpu/models/elbo.py`. The reference recomputes phi per
nonzero and accumulates sum_k y*phi_k*(Elog theta + Elog beta - log phi_k)
with phi already scaled by y, which collapses to y^2 * (lse - log y) per
nonzero (the bias slots included, hgaprec.cc:2228-2231). So the data term
needs one logsumexp per nonzero plus the expected-rate dot products over
nonzeros, and the per-family Gamma terms (gpbase.hh:360-387). The
reference's quirks are kept: the y^2 scaling and the -E[theta]E[beta] term
summed over nonzeros only.

The JAX package materialises the [P, K] logits at once (18 GB at EchoNest
shape). Here the nonzero terms stream over chunks of SEGMENT_CHUNK: each
chunk is summed in f32 and the chunk sums, with the f32 Gamma terms, are
added in f64. The result is a Python float.
"""

from __future__ import annotations

import torch

from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.models.state import ModelState
from hgaprec_tpu_torch.ops.gamma import elbo_term
from hgaprec_tpu_torch.ops.sweep import SEGMENT_CHUNK, nonzero_logits


def _nonzero_sum(state: ModelState, data: DeviceData, cfg: ModelConfig,
                 chunk: int, term) -> torch.Tensor:
    """f64 sum over nonzero chunks of the f32 chunk sums of
    term(lse, y, u, i), each [C] over the chunk's nonzeros (padding
    masked out)."""
    bias = cfg.bias
    eb_u = state.theta_bias.elog if bias else None
    eb_i = state.beta_bias.elog if bias else None
    total = torch.zeros((), dtype=torch.float64, device=data.y.device)
    for j0 in range(0, data.u_ids.shape[0], chunk):
        u = data.u_ids[j0:j0 + chunk].long()
        i = data.i_ids[j0:j0 + chunk].long()
        y = data.y[j0:j0 + chunk]
        lse = torch.logsumexp(nonzero_logits(
            state.theta.elog, state.beta.elog, eb_u, eb_i, u, i), dim=1)
        for part in term(lse, y, u, i):
            total += torch.where(y > 0, part, 0.0).sum().double()
    return total


def _gamma_terms(state: ModelState, cfg: ModelConfig, hier_prior):
    """The Gamma ELBO terms; hier_prior = (theta prior E, Elog, beta prior
    E, Elog) for the factor families under HPF."""
    theta, beta = state.theta, state.beta
    terms = []
    if not cfg.hier:
        terms += [elbo_term(theta.shape, theta.rate, theta.e, theta.elog,
                            cfg.a, cfg.b),
                  elbo_term(beta.shape, beta.rate, beta.e, beta.elog,
                            cfg.c, cfg.d)]
    else:
        te, tl, be, bl = hier_prior
        xi, eta = state.theta_rate, state.beta_rate
        terms += [elbo_term(theta.shape, theta.rate, theta.e, theta.elog,
                            cfg.a, te, tl),
                  elbo_term(beta.shape, beta.rate, beta.e, beta.elog,
                            cfg.c, be, bl),
                  elbo_term(xi.shape, xi.rate, xi.e, xi.elog, cfg.ap, cfg.bp),
                  elbo_term(eta.shape, eta.rate, eta.e, eta.elog, cfg.cp,
                            cfg.dp)]
    if cfg.bias:
        tb, bb = state.theta_bias, state.beta_bias
        terms += [elbo_term(tb.shape, tb.rate, tb.e, tb.elog, 0.3, 0.3),
                  elbo_term(bb.shape, bb.rate, bb.e, bb.elog, 0.3, 0.3)]
    return sum(t.double() for t in terms)


def training_elbo(state: ModelState, data: DeviceData, cfg: ModelConfig,
                  chunk: int = SEGMENT_CHUNK) -> float:
    """The reference's reported ELBO (`hgaprec_tpu/models/elbo.py:33-78`)."""
    theta, beta = state.theta, state.beta

    def term(lse, y, u, i):
        logy = torch.where(y > 1, torch.log(torch.clamp_min(y, 1.0)), 0.0)
        rate = (theta.e[u] * beta.e[i]).sum(1)
        if cfg.bias:
            rate = rate + state.theta_bias.e[u] + state.beta_bias.e[i]
        return y * y * (lse - logy), -rate

    s = _nonzero_sum(state, data, cfg, chunk, term)
    # hier prior rates: E[xi]/Elog[xi] captured at update time
    # (gpbase.hh:360-373 via set_prior_rate)
    s += _gamma_terms(state, cfg, (state.theta_prior_e,
                                   state.theta_prior_elog,
                                   state.beta_prior_e, state.beta_prior_elog))
    return float(s)


def true_elbo(state: ModelState, data: DeviceData, cfg: ModelConfig,
              chunk: int = SEGMENT_CHUNK) -> float:
    """The actual Poisson-factorization ELBO, not the reference's report
    (`hgaprec_tpu/models/elbo.py:81-125`): with phi at its coordinate
    optimum the data term is sum_nz (y*lse - log y!) and the Poisson mass
    runs over ALL pairs. Exact CAVI never decreases it across full update
    rounds."""
    theta, beta = state.theta, state.beta

    def term(lse, y, u, i):
        return (y * lse - torch.lgamma(torch.clamp_min(y, 1.0) + 1.0),)

    s = _nonzero_sum(state, data, cfg, chunk, term)
    s -= torch.sum(theta.e.sum(0) * beta.e.sum(0)).double()
    if cfg.bias:
        s -= cfg.m * state.theta_bias.e.sum().double()
        s -= cfg.n * state.beta_bias.e.sum().double()
    hier = ((state.theta_rate.e, state.theta_rate.elog, state.beta_rate.e,
             state.beta_rate.elog) if cfg.hier else None)
    s += _gamma_terms(state, cfg, hier)
    return float(s)
