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
(ops/tail_fused.py) over the remaining nonzeros.

The segment sweeps work on the dual-sorted COO alone: gather, log-softmax
and dual segment sums (`sweep_segment`), or the one-pass linear-space form
streamed over nonzero chunks (`sweep_segment_chunked`). They are the JAX
package's general sparse path and correctness baseline; a CPU tensor runs
them as the JAX dispatch picks them. On a CUDA tensor both segment modes
run the CSR sweep kernel (ops/segment_fused.py), which computes the same
sums.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hgaprec_tpu_torch.config import (SWEEP_DENSE, SWEEP_DENSE_PALLAS,
                                      SWEEP_HYBRID, SWEEP_SEGMENT_CHUNKED)
from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.ops.dense_fused import (fused_dense_sweep,
                                               fused_dense_sweep_reference)
from hgaprec_tpu_torch.ops.segment_fused import segment_sweep
from hgaprec_tpu_torch.ops.tail_fused import tail_sweep

DENSE_MODES = (SWEEP_DENSE, SWEEP_DENSE_PALLAS)
_CLAMP = 1e-30


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


def nonzero_logits(elog_a, elog_b, elog_bias_a, elog_bias_b, u, i):
    """[C, K] (or [C, K+2] with bias) per-nonzero logits."""
    logits = elog_a[u] + elog_b[i]
    if elog_bias_a is not None:
        logits = torch.cat([logits, elog_bias_a[u][:, None],
                            elog_bias_b[i][:, None]], dim=1)
    return logits


def sweep_segment(elog_a: torch.Tensor, elog_b: torch.Tensor,
                  elog_bias_a: Optional[torch.Tensor],
                  elog_bias_b: Optional[torch.Tensor],
                  data: DeviceData) -> SweepResult:
    """Gather -> log-softmax -> dual segment-sum sweep over sorted COO
    (`hgaprec_tpu/ops/sweep.py:170-200`)."""
    n, k = elog_a.shape
    m = elog_b.shape[0]
    u = data.u_ids.long()
    logits = nonzero_logits(elog_a, elog_b, elog_bias_a, elog_bias_b, u,
                            data.i_ids.long())
    lse = torch.logsumexp(logits, dim=1, keepdim=True)
    # y * phi, and 0 on a padding entry (y = 0) even where its row's Elog
    # is -inf (an MLE row of zeros: -inf - -inf is NaN), which a rank whose
    # rows are all padding cannot avoid
    y = data.y[:, None]
    phis = torch.where(y > 0, y * torch.exp(logits - lse), 0.0)
    acc_a = logits.new_zeros((n, k)).index_add_(0, u, phis[:, :k])
    phis_i = phis[data.item_order.long()]
    i_sorted = data.i_ids_sorted.long()
    acc_b = logits.new_zeros((m, k)).index_add_(0, i_sorted, phis_i[:, :k])
    if elog_bias_a is not None:
        acc_ba = logits.new_zeros(n).index_add_(0, u, phis[:, k])
        acc_bb = logits.new_zeros(m).index_add_(0, i_sorted, phis_i[:, k + 1])
        return SweepResult(acc_a, acc_b, acc_ba, acc_bb)
    return SweepResult(acc_a, acc_b, None, None)


# above this many padded nonzeros the [P, K] phi matrix is streamed in
# chunks (EchoNest: P ~ 48M, K = 100 -> 19 GB if materialized at once)
SEGMENT_CHUNK_THRESHOLD = 4 << 20
SEGMENT_CHUNK = 1 << 20


def sweep_segment_chunked(elog_a: torch.Tensor, elog_b: torch.Tensor,
                          elog_bias_a: Optional[torch.Tensor],
                          elog_bias_b: Optional[torch.Tensor],
                          data: DeviceData,
                          chunk: int = SEGMENT_CHUNK) -> SweepResult:
    """One-pass linear-space segment sweep streamed over nonzero chunks
    (`hgaprec_tpu/ops/sweep.py:209-239`).

    Same accumulators as sweep_segment; the [P, K] phi tensor only ever
    exists [chunk, K] at a time. phi is proportional to A[u] (.) B[i] with
    s = <A[u], B[i]> (+ biases), the dense path's identity, instead of a
    log-softmax; one pass over the user-sorted stream feeds both sides.
    The 1e-30 clamp mirrors the reference's make_nonzero; zero-count
    padding rows contribute nothing."""
    return _segment_onepass_lin(*_linear(elog_a, elog_b, elog_bias_a,
                                         elog_bias_b),
                                data.u_ids, data.i_ids, data.y, chunk)


def _segment_onepass_lin(a_lin, b_lin, ba_lin, bb_lin, u_ids, i_ids, y,
                         chunk: int) -> SweepResult:
    """The one-pass linear-space COO sweep over a user-sorted stream
    (`hgaprec_tpu/ops/sweep.py:242-292`). Inputs are linear-space
    expectations (exp of Elog)."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    bias = ba_lin is not None
    acc_a, acc_b = a_lin.new_zeros((n, k)), a_lin.new_zeros((m, k))
    acc_ba, acc_bb = a_lin.new_zeros(n), a_lin.new_zeros(m)
    for j0 in range(0, u_ids.shape[0], chunk):
        uu = u_ids[j0:j0 + chunk].long()
        ii = i_ids[j0:j0 + chunk].long()
        prod = a_lin[uu] * b_lin[ii]                     # [C, K]
        s = prod.sum(1)
        if bias:
            bau, bbi = ba_lin[uu], bb_lin[ii]
            s = s + bau + bbi
        w = y[j0:j0 + chunk] / torch.clamp_min(s, _CLAMP)   # [C]
        ph = w[:, None] * prod
        acc_a.index_add_(0, uu, ph)
        acc_b.index_add_(0, ii, ph)
        if bias:
            acc_ba.index_add_(0, uu, w * bau)
            acc_bb.index_add_(0, ii, w * bbi)
    if bias:
        return SweepResult(acc_a, acc_b, acc_ba, acc_bb)
    return SweepResult(acc_a, acc_b, None, None)


def sweep(elog_a, elog_b, elog_bias_a, elog_bias_b, data: DeviceData,
          mode: str, item_block: int = 4096, user_block: int = 16384,
          precision: str = "highest") -> SweepResult:
    """Dispatch one sweep (`hgaprec_tpu/ops/sweep.py:370-411`). A CUDA
    tensor always takes the CUDA kernels, a CPU tensor their plain
    versions; `dense` and `dense-pallas` are the same request (the TPU's
    VMEM gate on the fused kernel has no counterpart: the two-pass kernel
    takes any item count). Every other mode is a segment sweep: on a CPU
    tensor the JAX rule picks the chunked form for `segment-chunked` or
    more than SEGMENT_CHUNK_THRESHOLD nonzeros, else the log-softmax form;
    on a CUDA tensor both run the CSR sweep kernel, in f32 whatever the
    precision (as the JAX segment path)."""
    if mode in DENSE_MODES:
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
    if mode == SWEEP_HYBRID:
        if data.head_dense_y is None:
            raise ValueError("hybrid sweep requested but the head dense "
                             "block was not built (build_device_data "
                             "hybrid_head_items)")
        return sweep_hybrid(elog_a, elog_b, elog_bias_a, elog_bias_b, data,
                            precision=precision)
    if data.u_ids.device.type != "cpu":
        return SweepResult(*segment_sweep(
            *_linear(elog_a, elog_b, elog_bias_a, elog_bias_b), data))
    if (mode == SWEEP_SEGMENT_CHUNKED or
            data.u_ids.shape[0] > SEGMENT_CHUNK_THRESHOLD):
        return sweep_segment_chunked(elog_a, elog_b, elog_bias_a,
                                     elog_bias_b, data)
    return sweep_segment(elog_a, elog_b, elog_bias_a, elog_bias_b, data)


def nonzero_logsumexp_sum(elog_a, elog_b, elog_bias_a, elog_bias_b,
                          data: DeviceData, weights: torch.Tensor,
                          chunk: int = SEGMENT_CHUNK) -> torch.Tensor:
    """sum over nonzeros of weights * logsumexp(logits), an ELBO helper
    (`hgaprec_tpu/ops/sweep.py:414-427`): the y^2 * lse collapse of the
    reference's phi-entropy term in logl() (hgaprec.cc:2217-2235).

    Streamed over nonzero chunks, so the [P, K] logits never exist whole;
    each chunk is summed in f32 and the chunk sums in f64. Returns an f64
    scalar tensor."""
    total = torch.zeros((), dtype=torch.float64, device=data.y.device)
    for j0 in range(0, data.u_ids.shape[0], chunk):
        lse = torch.logsumexp(nonzero_logits(
            elog_a, elog_b, elog_bias_a, elog_bias_b,
            data.u_ids[j0:j0 + chunk].long(),
            data.i_ids[j0:j0 + chunk].long()), dim=1)
        live = data.y[j0:j0 + chunk] > 0
        total += torch.where(live, weights[j0:j0 + chunk] * lse,
                             0.0).sum().double()
    return total
