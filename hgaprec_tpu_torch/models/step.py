"""One CAVI iteration per model variant (port of `hgaprec_tpu/models/step.py`).

Update *ordering* within an iteration is part of the algorithm and is kept
exactly as the reference stages it:

  * vb() (hgaprec.cc:919-980): theta rate uses old beta; theta swaps; beta
    rate uses the *new* theta (asymmetric staleness).
  * vb_bias() (1219-1319): same, plus bias shape slots; -novb switches to
    fully synchronous swaps (all rates from old expectations).
  * vb_hier() (1321-1436): per-row prior rates injected from the scale
    variables (set_prior_rate, gpbase.hh:163-173); scales update last from
    the *new* factor expectations.
  * vb_mle_user/item (982-1130) and vb_canny (1132-1216): one side is a
    point matrix renormalized per sweep (EM for GaP / Canny's GaP).

The step writes its result into the state's own tensors (the JAX package
donates them to the jitted step instead), so a run keeps one set of state
buffers. Every old value a later update reads is consumed or copied before
its buffer is overwritten.

With a process `group` (parallel/sharded.py) the user-side tables and
nonzeros are this rank's row block, the item-side tables are replicated,
and the only traffic is an all-reduce (SUM) of the item-side statistics
and of the K-length user-axis column sums, issued in the same order on
every rank; `row_mask` zeroes the expectations of the padding rows, so
they add nothing to those sums (the JAX step's `axis_name` and
`row_mask`, hgaprec_tpu/models/step.py:34-66).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from hgaprec_tpu_torch import config as C
from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.models.state import Gam, ModelState
from hgaprec_tpu_torch.ops.gamma import expectations
from hgaprec_tpu_torch.ops.sweep import sweep


def _update(g: Gam, shape, rate, row_mask=None) -> None:
    """Write a fresh posterior and its expectations into g's buffers;
    `row_mask` zeroes the expectations of padding rows."""
    e, elog = expectations(shape, rate)
    if row_mask is not None:
        e = e * row_mask.reshape((-1,) + (1,) * (e.dim() - 1))
    g.shape.copy_(shape)
    g.rate.copy_(rate)
    g.e.copy_(e)
    g.elog.copy_(elog)


def _usum(x: torch.Tensor, group) -> torch.Tensor:
    """Column sum over the (possibly rank-sharded) user axis."""
    s = x.sum(0)
    if group is not None:
        dist.all_reduce(s, group=group)
    return s


def _ipsum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce an item-side accumulator computed from this rank's
    nonzeros (in place, or in a contiguous copy of a strided view, which
    the collective cannot take); returns the sum."""
    if group is not None:
        x = x.contiguous()
        dist.all_reduce(x, group=group)
    return x


def _bias_updates(cfg: ModelConfig, state: ModelState, res,
                  group=None) -> None:
    """Bias Gamma(0.3, 0.3) updates: shape += y*phi[bias slot], rate =
    prior + count of opposite-side entities (update_rate_next_all,
    hgaprec.cc:1265-1270, gpbase.hh:231-237)."""
    _update(state.theta_bias, 0.3 + res.acc_bias_a,
            torch.full_like(state.theta_bias.rate, 0.3 + cfg.m))
    _update(state.beta_bias, 0.3 + _ipsum(res.acc_bias_b, group),
            torch.full_like(state.beta_bias.rate, 0.3 + cfg.n))


def _resolve_mode(cfg: ModelConfig, data: DeviceData) -> str:
    """The JAX package's rule (hgaprec_tpu/models/step.py:68-81)."""
    mode = cfg.resolve_sweep()
    auto = cfg.sweep == C.SWEEP_AUTO
    if mode == C.SWEEP_DENSE and data.dense_y is None:
        mode = (C.SWEEP_HYBRID if data.head_dense_y is not None
                else C.SWEEP_SEGMENT)
    if auto and mode == C.SWEEP_SEGMENT:
        if data.dense_y is not None:
            mode = C.SWEEP_DENSE       # densified despite a wide catalog
        elif data.head_dense_y is not None:
            mode = C.SWEEP_HYBRID      # head block built -> use it
    if mode == C.SWEEP_HYBRID and data.head_dense_y is None:
        mode = C.SWEEP_SEGMENT
    return mode


def cavi_step(state: ModelState, data: DeviceData, cfg: ModelConfig,
              group=None, row_mask: Optional[torch.Tensor] = None
              ) -> ModelState:
    """One CAVI iteration, written into `state`'s tensors; returns it.
    With `group`, the state and data are one rank's user shard (module
    docstring); `cfg.n` is the true user count all the same."""
    mode = _resolve_mode(cfg, data)
    if cfg.variant == C.VARIANT_BPF:
        _step_bpf(state, data, cfg, mode, group, row_mask)
    elif cfg.variant == C.VARIANT_HPF:
        _step_hpf(state, data, cfg, mode, group, row_mask)
    elif cfg.variant == C.VARIANT_MLE_USER:
        _step_mle_user(state, data, cfg, mode, group)
    elif cfg.variant in (C.VARIANT_MLE_ITEM, C.VARIANT_CANNY):
        _step_mle_item(state, data, cfg, mode,
                       cfg.variant == C.VARIANT_CANNY, group, row_mask)
    else:
        raise ValueError(cfg.variant)
    return state


def _sweep(state: ModelState, data: DeviceData, cfg: ModelConfig, mode,
           elog_a=None, elog_b=None):
    """The sweep on the state's Elog factors (or the given log point
    matrices in their place, for the MLE variants, which have no bias)."""
    eb_u = state.theta_bias.elog if cfg.bias else None
    eb_i = state.beta_bias.elog if cfg.bias else None
    return sweep(state.theta.elog if elog_a is None else elog_a,
                 state.beta.elog if elog_b is None else elog_b, eb_u, eb_i,
                 data, mode, cfg.item_block, cfg.user_block,
                 cfg.matmul_precision)


def _step_bpf(state, data, cfg, mode, group=None, row_mask=None):
    res = _sweep(state, data, cfg, mode)
    betasum = state.beta.e.sum(0)                  # old beta [K]
    old_thetasum = None if cfg.vb else _usum(state.theta.e, group)
    _update(state.theta, cfg.a + res.acc_a, cfg.b + betasum, row_mask)
    # vb: beta rate from the NEW theta; -novb: from the old one
    thetasum = _usum(state.theta.e, group) if cfg.vb else old_thetasum
    _update(state.beta, cfg.c + _ipsum(res.acc_b, group), cfg.d + thetasum)
    if cfg.bias:
        _bias_updates(cfg, state, res, group)


def _step_hpf(state, data, cfg, mode, group=None, row_mask=None):
    res = _sweep(state, data, cfg, mode)
    xi, eta = state.theta_rate, state.beta_rate
    # prior rates in effect for this update, kept for the hier ELBO term
    state.theta_prior_e.copy_(xi.e)
    state.theta_prior_elog.copy_(xi.elog)
    state.beta_prior_e.copy_(eta.e)
    state.beta_prior_elog.copy_(eta.elog)
    # theta: prior rate := E[xi] per row (replacing b), plus old-beta colsum
    betarowsum = state.beta.e.sum(0)
    _update(state.theta, cfg.a + res.acc_a,
            xi.e[:, None] + betarowsum[None, :], row_mask)
    # beta: symmetric with the NEW theta (hgaprec.cc:1380-1386)
    thetarowsum = _usum(state.theta.e, group)
    _update(state.beta, cfg.c + _ipsum(res.acc_b, group),
            eta.e[:, None] + thetarowsum[None, :])
    if cfg.bias:
        _bias_updates(cfg, state, res, group)
    # scales last, from NEW factor expectations (hgaprec.cc:1398-1414):
    # shape = prior + K*prior; rate = prior + row-sums of E.
    _update(xi, torch.full_like(xi.shape, cfg.ap + cfg.k * cfg.ap),
            cfg.bp + state.theta.e.sum(1), row_mask)
    _update(eta, torch.full_like(eta.shape, cfg.cp + cfg.k * cfg.cp),
            cfg.dp + state.beta.e.sum(1))


def _step_mle_user(state, data, cfg, mode, group=None):
    res = _sweep(state, data, cfg, mode, elog_a=torch.log(state.theta_mle))
    betasum = state.beta.e.sum(0)                  # old beta [K]
    td = res.acc_a / betasum[None, :]              # EM normalize
    _update(state.beta, cfg.c + _ipsum(res.acc_b, group),
            cfg.d + _usum(td, group))
    state.theta_mle.copy_(td)


def _step_mle_item(state, data, cfg, mode, canny: bool, group=None,
                   row_mask=None):
    res = _sweep(state, data, cfg, mode, elog_b=torch.log(state.beta_mle))
    thetasum = _usum(state.theta.e, group)         # old theta [K]
    acc_b = _ipsum(res.acc_b, group)
    if canny:
        # floor *before* normalizing (hgaprec.cc:1173-1176), then per-factor
        # L1 column normalization (1179-1187)
        bd = torch.clamp_min(acc_b, 1e-10) / thetasum[None, :]
        bd = bd / bd.sum(0, keepdim=True)
    else:
        bd = acc_b / thetasum[None, :]
    _update(state.theta, cfg.a + res.acc_a, cfg.b + bd.sum(0), row_mask)
    state.beta_mle.copy_(bd)


def make_step(cfg: ModelConfig):
    """Return `step(state, data) -> state` for this config."""
    def step(state: ModelState, data: DeviceData) -> ModelState:
        return cavi_step(state, data, cfg)
    return step


def make_multi_step(cfg: ModelConfig):
    """Return `multi_step(state, data, n_steps) -> state`: `n_steps` CAVI
    iterations back to back, with no host synchronisation in between.
    (The JAX package fuses them into one dispatch; replaying a captured
    CUDA graph is the counterpart, a later step.)"""
    def multi_step(state: ModelState, data: DeviceData,
                   n_steps: int) -> ModelState:
        for _ in range(n_steps):
            cavi_step(state, data, cfg)
        return state
    return multi_step
