"""Plain reference of one HPF CAVI iteration on a (user, item, count) COO.

Hierarchical Poisson factorization (Gopalan, Hofman & Blei, UAI 2015,
arXiv:1311.1704) fitted by batch coordinate ascent, with the update order
of the hgaprec reference's `vb_hier` (hgaprec.cc:1321-1436):

  1. phi over every nonzero from the old Elog factors:
     phi[j, k] = A[u, k] B[i, k] / sum_k A[u, k] B[i, k], A = exp(Elog theta),
     B = exp(Elog beta); acc_a[u] += y phi, acc_b[i] += y phi.
  2. the prior rates in effect are the old scale expectations E[xi], E[eta]
     (kept as `theta_prior_*`, `beta_prior_*`);
  3. theta: shape = a + acc_a, rate = E[xi_u] + sum_i E[beta_i] (old beta);
  4. beta: shape = c + acc_b, rate = E[eta_i] + sum_u E[theta_u] (new theta);
  5. xi: shape = a' + K a', rate = b' + sum_k E[theta_uk];
     eta: shape = c' + K c', rate = d' + sum_k E[beta_ik] (new factors).

Expectations E = shape / rate and Elog = digamma(shape) - log(rate), with
shape and rate floored at 1e-30 where not positive (gpbase.hh:27-44), and
the phi denominator floored at 1e-30.

A state is a dict of tensors keyed by leaf name (`theta.shape`, ...,
`beta_prior_elog`). Plain torch only: this module imports nothing of the
program under test. `dtype` sets the precision of every operation;
`low` names a rounding of the operands of the sweep's three products
(A B^T, W B, W^T A), accumulating in `dtype`: the control, one precision
below the one a cell states (`BELOW`): "tf32" as a TF32 matrix unit
reads a float32 operand, below "highest" (float32); "fp8" as an FP8 E4M3
matrix unit reads one scaled by row, below "default" (bfloat16).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

FLOOR = 1e-30
GAMS = ("theta", "beta", "theta_rate", "beta_rate")
PARTS = ("shape", "rate", "e", "elog")
PRIORS = ("theta_prior_e", "theta_prior_elog", "beta_prior_e",
          "beta_prior_elog")
LEAVES = tuple(f"{g}.{p}" for g in GAMS for p in PARTS) + PRIORS


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties to even, as the tensor cores read a TF32 operand."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


# FP8 E4M3's largest finite value
FP8_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to FP8 E4M3 (3 explicit mantissa bits), to
    nearest, with one power-of-two scale per row (along the last
    dimension) that brings the row's largest magnitude within FP8_MAX, as
    a row-wise scaled FP8 product reads its operands; returned unscaled."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.exp2(torch.floor(torch.log2(
        FP8_MAX / amax.clamp_min(torch.finfo(torch.float32).tiny))))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


# the rounding a control applies to the products' operands, by name, and
# the control one step below each precision that a cell states (the
# port's matmul precision: "highest" float32, "default" bfloat16)
ROUNDINGS = {"tf32": to_tf32, "fp8": to_fp8}
BELOW = {"highest": "tf32", "default": "fp8"}


def expectations(shape: torch.Tensor, rate: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.where(shape > 0, shape, torch.full_like(shape, FLOOR))
    b = torch.where(rate > 0, rate, torch.full_like(rate, FLOOR))
    return a / b, torch.special.digamma(a) - torch.log(b)


def sweep(a_lin: torch.Tensor, b_lin: torch.Tensor, u: torch.Tensor,
          i: torch.Tensor, y: torch.Tensor, low: Optional[str] = None,
          chunk: int = 1 << 21) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc_a [N, K], acc_b [M, K]): the sums of y phi over each user's
    and each item's nonzeros, streamed over chunks of the COO."""
    acc_a = torch.zeros_like(a_lin)
    acc_b = torch.zeros_like(b_lin)
    dt = a_lin.dtype
    rnd = ROUNDINGS[low] if low else None
    a_op = rnd(a_lin).to(dt) if rnd else a_lin
    b_op = rnd(b_lin).to(dt) if rnd else b_lin
    for j0 in range(0, u.shape[0], chunk):
        uu = u[j0:j0 + chunk].long()
        ii = i[j0:j0 + chunk].long()
        s = (a_op[uu] * b_op[ii]).sum(1)
        w = y[j0:j0 + chunk].to(dt) / torch.clamp_min(s, FLOOR)
        if rnd:
            # each nonzero's weight a row of its own, so that the rounding
            # of one chunk does not depend on another's
            w = rnd(w[:, None])[:, 0].to(dt)
        # acc_a = A (.) (W B) and acc_b = B (.) (W^T A): the outer factor
        # multiplies the finished sum, as in the sweep's matrix form
        acc_a.index_add_(0, uu, w[:, None] * b_op[ii])
        acc_b.index_add_(0, ii, w[:, None] * a_op[uu])
    acc_a.mul_(a_lin)
    acc_b.mul_(b_lin)
    return acc_a, acc_b


def hpf_step(st: Dict[str, torch.Tensor], u: torch.Tensor, i: torch.Tensor,
             y: torch.Tensor, k: int, priors: Dict[str, float],
             low: Optional[str] = None, chunk: int = 1 << 21
             ) -> Dict[str, torch.Tensor]:
    """One iteration from state `st` (left unchanged); returns the new
    state, every leaf a fresh tensor of st's dtype."""
    p = priors
    acc_a, acc_b = sweep(torch.exp(st["theta.elog"]),
                         torch.exp(st["beta.elog"]), u, i, y, low, chunk)
    xi_e, eta_e = st["theta_rate.e"], st["beta_rate.e"]
    out = {"theta_prior_e": xi_e.clone(),
           "theta_prior_elog": st["theta_rate.elog"].clone(),
           "beta_prior_e": eta_e.clone(),
           "beta_prior_elog": st["beta_rate.elog"].clone()}

    def put(name, shape, rate):
        e, elog = expectations(shape, rate)
        out.update({f"{name}.shape": shape, f"{name}.rate": rate,
                    f"{name}.e": e, f"{name}.elog": elog})

    put("theta", p["a"] + acc_a, xi_e[:, None] + st["beta.e"].sum(0)[None])
    put("beta", p["c"] + acc_b,
        eta_e[:, None] + out["theta.e"].sum(0)[None])
    n, m = xi_e.shape[0], eta_e.shape[0]
    put("theta_rate", torch.full((n,), p["ap"] + k * p["ap"],
                                 dtype=xi_e.dtype, device=xi_e.device),
        p["bp"] + out["theta.e"].sum(1))
    put("beta_rate", torch.full((m,), p["cp"] + k * p["cp"],
                                dtype=eta_e.dtype, device=eta_e.device),
        p["dp"] + out["beta.e"].sum(1))
    return out
