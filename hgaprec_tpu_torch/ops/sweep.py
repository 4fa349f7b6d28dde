"""The CAVI phi sweep, dense path (port of `hgaprec_tpu/ops/sweep.py`).

Reference behavior (hgaprec.cc:928-941 and get_phi at 206-239): for every
training nonzero (n, m, y), phi = softmax_k(Elog a[n] + Elog b[m] [+ bias
logits]), scaled by y, accumulated into the user-side and item-side shape
buffers. With A = exp(Elog a), B = exp(Elog b) the softmax denominator is
(A B^T)[n, m], so the accumulated statistics are

    acc_a = A * (W B),   acc_b = B * (W^T A),   W = Y / (A B^T + biases)

an SDDMM plus two SpMMs over the densified count matrix. On a CUDA tensor
that is the hand-written kernel (ops/dense_fused.py); on a CPU tensor it
is the kernel's plain blocked version.

Catalogs too wide to densify take the hybrid sweep: the same dense kernel
over the head block of top-degree items, and the tail kernel
(ops/tail_fused.py) over the remaining nonzeros. The segment sweeps are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hgaprec_tpu_torch.config import (SWEEP_DENSE, SWEEP_DENSE_PALLAS,
                                      SWEEP_HYBRID)
from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.ops.dense_fused import (fused_dense_sweep,
                                               fused_dense_sweep_reference)
from hgaprec_tpu_torch.ops.tail_fused import tail_sweep

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


def sweep_hybrid(elog_a: torch.Tensor, elog_b: torch.Tensor,
                 elog_bias_a: Optional[torch.Tensor],
                 elog_bias_b: Optional[torch.Tensor],
                 data: DeviceData, *,
                 precision: str = "highest") -> SweepResult:
    """Head/tail hybrid sweep (`hgaprec_tpu/ops/sweep.py:295-367`).

    The dense kernel sweeps the head block (columns = head_items) and
    returns raw W B, W^T A that still need the A and B factors; the tail
    returns finished y * phi sums. Both halves share the denominator
    s = <A[u], B[i]> (+ biases), so the result equals one sweep over all
    nonzeros up to f32 summation order. The tail follows the precision
    flag like the head (config.py: the port's tail-precision policy)."""
    a_lin, b_lin, ba_lin, bb_lin = _linear(elog_a, elog_b, elog_bias_a,
                                           elog_bias_b)
    bias = ba_lin is not None
    bf16 = precision == "default"
    head = data.head_items.long()
    b_head = b_lin[head]
    bb_head = bb_lin[head] if bias else None
    raw = fused_dense_sweep(a_lin, b_head, data.head_dense_y, ba_lin,
                            bb_head, bf16=bf16)
    tail = tail_sweep(a_lin, b_lin, ba_lin, bb_lin, data.tail, bf16=bf16)
    acc_a = tail[0] + a_lin * raw[0]
    acc_b = tail[1].index_add_(0, head, b_head * raw[1])
    if bias:
        return SweepResult(acc_a, acc_b, tail[2] + ba_lin * raw[2],
                           tail[3].index_add_(0, head, bb_head * raw[3]))
    return SweepResult(acc_a, acc_b, None, None)


def sweep(elog_a, elog_b, elog_bias_a, elog_bias_b, data: DeviceData,
          mode: str, item_block: int = 4096, user_block: int = 16384,
          precision: str = "highest") -> SweepResult:
    """Dispatch one sweep. A CUDA tensor always takes the CUDA kernels, a
    CPU tensor their plain versions; `dense` and `dense-pallas` are the
    same request (the TPU's VMEM gate on the fused kernel has no
    counterpart: the two-pass kernel takes any item count)."""
    if mode == SWEEP_HYBRID:
        if data.head_dense_y is None:
            raise ValueError("hybrid sweep requested but the head dense "
                             "block was not built (build_device_data "
                             "hybrid_head_items)")
        return sweep_hybrid(elog_a, elog_b, elog_bias_a, elog_bias_b, data,
                            precision=precision)
    if mode not in DENSE_MODES:
        raise NotImplementedError(
            f"sweep mode {mode!r} is not ported yet (ROADMAP queue 1, item "
            "13: segment sweeps)")
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
