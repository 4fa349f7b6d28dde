"""The CAVI phi sweep, dense path (port of `hgaprec_tpu/ops/sweep.py`).

Reference behavior (hgaprec.cc:928-941 and get_phi at 206-239): for every
training nonzero (n, m, y), phi = softmax_k(Elog a[n] + Elog b[m] [+ bias
logits]), scaled by y, accumulated into the user-side and item-side shape
buffers. With A = exp(Elog a), B = exp(Elog b) the softmax denominator is
(A B^T)[n, m], so the accumulated statistics are

    acc_a = A * (W B),   acc_b = B * (W^T A),   W = Y / (A B^T + biases)

an SDDMM plus two SpMMs over the densified count matrix. On a CUDA tensor
that is the hand-written kernel (ops/dense_fused.py); on a CPU tensor it
is the kernel's plain blocked version. The segment and hybrid sweeps are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hgaprec_tpu_torch.config import SWEEP_DENSE, SWEEP_DENSE_PALLAS
from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.ops.dense_fused import (fused_dense_sweep,
                                               fused_dense_sweep_reference)

DENSE_MODES = (SWEEP_DENSE, SWEEP_DENSE_PALLAS)


class SweepResult(NamedTuple):
    acc_a: torch.Tensor                  # [N, K] sum of y*phi over items of n
    acc_b: torch.Tensor                  # [M, K] sum of y*phi over users of m
    acc_bias_a: Optional[torch.Tensor]   # [N] sum of y*phi[K]   (bias slot)
    acc_bias_b: Optional[torch.Tensor]   # [M] sum of y*phi[K+1]


def _linear(elog_a, elog_b, elog_bias_a, elog_bias_b):
    bias = elog_bias_a is not None
    return (torch.exp(elog_a), torch.exp(elog_b),
            torch.exp(elog_bias_a) if bias else None,
            torch.exp(elog_bias_b) if bias else None)


def _scaled(a_lin, b_lin, ba_lin, bb_lin, raw) -> SweepResult:
    if ba_lin is not None:
        return SweepResult(a_lin * raw[0], b_lin * raw[1],
                           ba_lin * raw[2], bb_lin * raw[3])
    return SweepResult(a_lin * raw[0], b_lin * raw[1], None, None)


def sweep_dense(elog_a: torch.Tensor, elog_b: torch.Tensor,
                elog_bias_a: Optional[torch.Tensor],
                elog_bias_b: Optional[torch.Tensor],
                dense_y: torch.Tensor, *, item_block: int = 4096,
                user_block: int = 16384,
                precision: str = "highest") -> SweepResult:
    """Plain dense-blocked sweep in torch ops, on any device.

    dense_y: u8 [>= N, >= M] counts (0 = none); padding rows and columns
    meet zero counts and contribute nothing."""
    lin = _linear(elog_a, elog_b, elog_bias_a, elog_bias_b)
    raw = fused_dense_sweep_reference(
        *lin[:2], dense_y, *lin[2:], bf16=(precision == "default"),
        user_block=user_block, item_block=item_block)
    return _scaled(*lin, raw)


def sweep(elog_a, elog_b, elog_bias_a, elog_bias_b, data: DeviceData,
          mode: str, item_block: int = 4096, user_block: int = 16384,
          precision: str = "highest") -> SweepResult:
    """Dispatch one sweep. A CUDA tensor always takes the CUDA kernel, a
    CPU tensor the plain version; `dense` and `dense-pallas` are the same
    request (the TPU's VMEM gate on the fused kernel has no counterpart:
    the two-pass kernel takes any item count)."""
    if mode not in DENSE_MODES:
        raise NotImplementedError(
            f"sweep mode {mode!r} is not ported yet (ROADMAP queue 1, items "
            "12-13: hybrid and segment sweeps)")
    if data.dense_y is None:
        raise ValueError("dense sweep requested but dense_y not built")
    if data.dense_y.device.type == "cpu":
        return sweep_dense(elog_a, elog_b, elog_bias_a, elog_bias_b,
                           data.dense_y, item_block=item_block,
                           user_block=user_block, precision=precision)
    lin = _linear(elog_a, elog_b, elog_bias_a, elog_bias_b)
    raw = fused_dense_sweep(*lin[:2], data.dense_y, *lin[2:],
                            bf16=(precision == "default"))
    return _scaled(*lin, raw)
