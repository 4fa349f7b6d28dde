"""Gamma-posterior primitives (PyTorch port of `hgaprec_tpu/ops/gamma.py`).

A variational Gamma family is a `(shape, rate)` pair of tensors;
expectations are elementwise maps (torch.special.digamma in place of the
reference's gsl_sf_psi, gpbase.hh:248-262).

The host initializers draw from a NumPy Generator in the JAX package's
exact order and return NumPy arrays, so a port state starts bit-identical
to the JAX one under the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

# Reference clamp: make_nonzero floors non-positive params at 1e-30
# (gpbase.hh:27-44).
_FLOOR = 1e-30


def make_nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.0, x, torch.full((), _FLOOR, dtype=x.dtype,
                                              device=x.device))


def expectations(shape: torch.Tensor, rate: torch.Tensor, out=None):
    """E[v] = a/b, Elog[v] = digamma(a) - log b  (gpbase.hh:248-262).

    `rate` broadcasts against `shape` (global per-factor rates are a [K]
    vector against an [N, K] shape, gpbase.hh:583-597). With `out`, a
    pair of tensors of `shape`'s shape, the two are computed into it
    (the CAVI step's in-place update); returns (e, elog) either way.
    """
    a = make_nonzero(shape)
    b = make_nonzero(rate)
    if out is not None:
        e, elog = out
        torch.div(a, b, out=e)
        torch.sub(torch.special.digamma(a), torch.log(b), out=elog)
        return e, elog
    e = a / b
    elog = torch.special.digamma(a) - torch.log(b)
    return e, elog.expand_as(e)


def elbo_term(shape: torch.Tensor, rate: torch.Tensor, e: torch.Tensor,
              elog: torch.Tensor, sprior: float, rprior,
              log_rprior=None) -> torch.Tensor:
    """Per-family ELBO contribution (gpbase.hh:360-387, 717-741, 951-969),
    an f32 scalar tensor:

      sum[ a0*log(b0) + (a0-1)*Elog - b0*E - lgamma(a0) ]
    - sum[ a*log(b)  + (a-1)*Elog  - b*E  - lgamma(a)  ]

    `rprior` may be a tensor (hierarchical per-row prior rate E[xi_n],
    gpbase.hh:360-373), in which case `log_rprior` is Elog[xi_n]; both
    broadcast against `e` like set_prior_rate's row injection."""
    a = make_nonzero(shape)
    b = make_nonzero(torch.broadcast_to(rate, a.shape))
    dt, dev = e.dtype, e.device
    sprior = torch.tensor(sprior, dtype=dt, device=dev)
    rprior = torch.as_tensor(rprior, dtype=dt, device=dev)
    if log_rprior is None:
        log_rprior = torch.log(rprior)
    log_rprior = torch.as_tensor(log_rprior, dtype=dt, device=dev)
    if rprior.dim() and rprior.dim() < e.dim():
        rprior = rprior[:, None]
        log_rprior = log_rprior[:, None]
    s = torch.sum(sprior * log_rprior + (sprior - 1.0) * elog
                  - rprior * e - torch.lgamma(sprior))
    return s - torch.sum(a * torch.log(b) + (a - 1.0) * elog
                         - b * e - torch.lgamma(a))


# ---------------------------------------------------------------------------
# Initialization: host NumPy draws, same order and arithmetic as the JAX
# package (gpbase.hh:292-340, 655-715, 851-880).
# ---------------------------------------------------------------------------

def init_matrix_gr(rng: np.random.Generator, n: int, k: int, sprior: float,
                   rprior: float, dtype=np.float32):
    """GPMatrixGR::initialize + initialize_exp (gpbase.hh:631-715).

    shape[i,k] = a + 0.01*U;  rate[k] = b + 0.1*U (global per factor).
    Initial expectations use *fresh per-row* random rates b_row[i,k] =
    b + 0.1*U unrelated to `rate` — an intentional reference quirk that
    decorrelates the first sweep.
    """
    shape = sprior + 0.01 * rng.random((n, k))
    rate = rprior + 0.1 * rng.random(k)
    b_init = rprior + 0.1 * rng.random((n, k))
    e = shape / b_init
    elog = _digamma_np(shape) - np.log(b_init)
    return (np.asarray(shape, dtype), np.asarray(rate, dtype),
            np.asarray(e, dtype), np.asarray(elog, dtype))


def init_matrix(rng: np.random.Generator, n: int, k: int, sprior: float,
                rprior: float, dtype=np.float32):
    """GPMatrix::initialize + initialize_exp (gpbase.hh:292-340).

    Per-entry rates; initialize() gives every row the *same* random rate
    row (gpbase.hh:299-305) but that buffer is immediately overwritten by
    set_to_prior, so only the initialize_exp() expectations matter — those
    use fresh per-row random rates.
    """
    shape = sprior + 0.01 * rng.random((n, k))
    rate = np.broadcast_to(rprior + 0.1 * rng.random(k), (n, k)).copy()
    b_init = rprior + 0.1 * rng.random((n, k))
    e = shape / b_init
    elog = _digamma_np(shape) - np.log(b_init)
    return (np.asarray(shape, dtype), np.asarray(rate, dtype),
            np.asarray(e, dtype), np.asarray(elog, dtype))


def init_array2(rng: np.random.Generator, n: int, sprior: float,
                rprior: float, v: float, dtype=np.float32):
    """GPArray::initialize2(v) + compute_expectations (gpbase.hh:909-918).

    shape[i] = a + 0.01*U;  rate[i] = b + v (deterministic). Used for the
    HPF activity/popularity scales with v = K (hgaprec.cc:173-178).
    """
    shape = sprior + 0.01 * rng.random(n)
    rate = np.full(n, rprior + v)
    e = shape / rate
    elog = _digamma_np(shape) - np.log(rate)
    return (np.asarray(shape, dtype), np.asarray(rate, dtype),
            np.asarray(e, dtype), np.asarray(elog, dtype))


def init_matrix2(rng: np.random.Generator, n: int, k: int, sprior: float,
                 rprior: float, v: float, dtype=np.float32):
    """GPMatrix::initialize2(v) + compute_expectations (gpbase.hh:310-322).

    Used for the bias terms: thetabias.initialize2(M),
    betabias.initialize2(N) (hgaprec.cc:196-202).
    """
    shape = sprior + 0.01 * rng.random((n, k))
    rate = np.full((n, k), rprior + v)
    e = shape / rate
    elog = _digamma_np(shape) - np.log(rate)
    return (np.asarray(shape, dtype), np.asarray(rate, dtype),
            np.asarray(e, dtype), np.asarray(elog, dtype))


def _digamma_np(x):
    # SciPy-free host digamma via the asymptotic series with recurrence;
    # accurate to ~1e-12 for x > 0 at the shapes we initialize (x ~ 0.3).
    x = np.asarray(x, np.float64)
    res = np.zeros_like(x)
    y = x.copy()
    # recurrence psi(x) = psi(x+1) - 1/x until y >= 6
    for _ in range(8):
        small = y < 6.0
        res = np.where(small, res - 1.0 / np.where(small, y, 1.0), res)
        y = np.where(small, y + 1.0, y)
    inv = 1.0 / y
    inv2 = inv * inv
    res += (np.log(y) - 0.5 * inv
            - inv2 * (1.0 / 12 - inv2 * (1.0 / 120 - inv2 / 252)))
    return res
