"""Model state as dataclasses of tensors (port of `hgaprec_tpu/models/state.py`).

Each `Gam` carries the posterior (shape, rate) plus the current
expectations (e, elog). Expectations are carried, not recomputed on
demand, because the reference's initial expectations are deliberately
decorrelated from the initial posterior (initialize_exp uses fresh random
rates, gpbase.hh:324-340).

The CAVI step (models/step.py) writes each iteration's result into these
tensors in place, so the state's buffers live for the whole run. A caller
that keeps a snapshot across a step takes an owning copy
(`state_to_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hgaprec_tpu_torch import config as cfg_mod
from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.ops import gamma


@dataclasses.dataclass(frozen=True)
class Gam:
    shape: torch.Tensor   # [N, K] or [N]
    rate: torch.Tensor    # [K] (global), [N, K] (per-entry), or [N]
    e: torch.Tensor       # same shape as `shape`
    elog: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelState:
    theta: Gam                          # users x K
    beta: Gam                           # items x K
    theta_rate: Optional[Gam]           # HPF user activity xi [N]
    beta_rate: Optional[Gam]            # HPF item popularity eta [M]
    theta_bias: Optional[Gam]           # [N]
    beta_bias: Optional[Gam]            # [M]
    theta_mle: Optional[torch.Tensor]   # [N, K] point estimate (mle_user)
    beta_mle: Optional[torch.Tensor]    # [M, K] point estimate (mle_item/canny)
    # HPF ELBO parity: per-row prior rates in effect for theta/beta
    # (set_prior_rate, gpbase.hh:163-173)
    theta_prior_e: Optional[torch.Tensor]
    theta_prior_elog: Optional[torch.Tensor]
    beta_prior_e: Optional[torch.Tensor]
    beta_prior_elog: Optional[torch.Tensor]


GAM_FIELDS = ("theta", "beta", "theta_rate", "beta_rate", "theta_bias",
              "beta_bias")
ARRAY_FIELDS = ("theta_mle", "beta_mle", "theta_prior_e", "theta_prior_elog",
                "beta_prior_e", "beta_prior_elog")
_PARTS = ("shape", "rate", "e", "elog")


def init_arrays(cfg: ModelConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Reference HGAPRec::initialize() (hgaprec.cc:153-204) as host arrays,
    keyed like the npz checkpoint. NumPy draws in the JAX package's order,
    so the arrays equal its initial state bit for bit."""
    rng = np.random.default_rng(seed)
    n, m, k = cfg.n, cfg.m, cfg.k
    dt = cfg.dtype
    out: Dict[str, np.ndarray] = {}

    def put(name, parts):
        for p, v in zip(_PARTS, parts):
            out[f"{name}.{p}"] = v

    if not cfg.hier:
        # beta first, then theta (hgaprec.cc:156-160)
        put("beta", gamma.init_matrix_gr(rng, m, k, cfg.c, cfg.d, dt))
        put("theta", gamma.init_matrix_gr(rng, n, k, cfg.a, cfg.b, dt))
    else:
        # thetarate/betarate via initialize2(k) (hgaprec.cc:173-178), then
        # hbeta, then htheta (hgaprec.cc:184-192)
        put("theta_rate", gamma.init_array2(rng, n, cfg.ap, cfg.bp,
                                            float(k), dt))
        put("beta_rate", gamma.init_array2(rng, m, cfg.cp, cfg.dp,
                                           float(k), dt))
        put("beta", gamma.init_matrix(rng, m, k, cfg.c, cfg.d, dt))
        put("theta", gamma.init_matrix(rng, n, k, cfg.a, cfg.b, dt))
    if cfg.bias:
        # thetabias.initialize2(M), betabias.initialize2(N)
        # (hgaprec.cc:196-202); stored flattened to [N]/[M].
        put("theta_bias", [x[:, 0] for x in
                           gamma.init_matrix2(rng, n, 1, 0.3, 0.3, float(m),
                                              dt)])
        put("beta_bias", [x[:, 0] for x in
                          gamma.init_matrix2(rng, m, 1, 0.3, 0.3, float(n),
                                             dt)])
    if cfg.variant == cfg_mod.VARIANT_MLE_USER:
        out["theta_mle"] = np.full((n, k), 1.0 / k, dt)   # hgaprec.cc:988-991
    elif cfg.variant == cfg_mod.VARIANT_MLE_ITEM:
        out["beta_mle"] = np.full((m, k), 1.0 / k, dt)
    elif cfg.variant == cfg_mod.VARIANT_CANNY:
        out["beta_mle"] = np.full((m, k), 1.0 / m, dt)    # hgaprec.cc:1139-1141
    if cfg.hier:
        # before the first update the prior rates in effect are the
        # initialized scale expectations (separate buffers: the step
        # writes both in place)
        out["theta_prior_e"] = out["theta_rate.e"].copy()
        out["theta_prior_elog"] = out["theta_rate.elog"].copy()
        out["beta_prior_e"] = out["beta_rate.e"].copy()
        out["beta_prior_elog"] = out["beta_rate.elog"].copy()
    return out


def init_state(cfg: ModelConfig, seed: int = 0, *, device) -> ModelState:
    """Initial state on `device` (required: no silent CPU default), equal
    to the JAX package's init_state."""
    return state_from_numpy(init_arrays(cfg, seed), cfg, device)


def state_from_numpy(arrays, cfg: ModelConfig, device) -> ModelState:
    """Build a state from host arrays keyed like the npz checkpoint
    (`theta.shape`, `theta.rate`, `theta.e`, `theta.elog`, ...,
    `theta_prior_e`, ...). Missing e/elog are recomputed from shape/rate.
    Every tensor is a fresh buffer on `device`."""
    dt = getattr(torch, cfg.dtype)

    def tensor(v):
        return torch.tensor(np.asarray(v), dtype=dt, device=device)

    def gam(f) -> Optional[Gam]:
        if f"{f}.shape" not in arrays:
            return None
        shape, rate = tensor(arrays[f"{f}.shape"]), tensor(arrays[f"{f}.rate"])
        if f"{f}.e" in arrays and f"{f}.elog" in arrays:
            return Gam(shape, rate, tensor(arrays[f"{f}.e"]),
                       tensor(arrays[f"{f}.elog"]))
        e, elog = gamma.expectations(shape, rate)
        return Gam(shape, rate, e.contiguous(), elog.contiguous())

    kw = {f: gam(f) for f in GAM_FIELDS}
    kw.update({f: tensor(arrays[f]) if f in arrays else None
               for f in ARRAY_FIELDS})
    return ModelState(**kw)


def state_to_numpy(state: ModelState) -> Dict[str, np.ndarray]:
    """Owning host copies of every tensor, keyed like the npz checkpoint.

    The copies are complete when this returns, so the caller may hand them
    to another thread while the next step rewrites the device buffers."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", copy=True).numpy()

    out: Dict[str, np.ndarray] = {}
    for f in GAM_FIELDS:
        g = getattr(state, f)
        if g is not None:
            for p in _PARTS:
                out[f"{f}.{p}"] = host(getattr(g, p))
    for f in ARRAY_FIELDS:
        v = getattr(state, f)
        if v is not None:
            out[f] = host(v)
    return out
