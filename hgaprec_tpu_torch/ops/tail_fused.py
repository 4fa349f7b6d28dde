"""Sparse-tail half-sweep: the CUDA kernel's wrapper.

Port of `hgaprec_tpu/ops/pallas_tail.py::pallas_half_sweep` and
`pallas_tail_sweep`. For a stream sorted by its primary ids p, with
other-side ids o, counts y and bias-augmented tables P, O (ops/tail.py):

    out[r] = sum_{j: p_j = r} w_j * P[r] (.) O[o_j],
    w_j = y_j / max(<P[r], O[o_j]>, 1e-30)

The kernel (`csrc/tail_fused.cu`) replaces the TPU kernel
`hgaprec_tpu/ops/pallas_tail.py::_kernel`. It is bounded by the random
row gathers: one O row per nonzero (kq * 2 bytes in bf16) plus 12 bytes of
ids and y. Each warp keeps a row's running sum in registers and writes
each finished row once; rows cut by a warp's range meet in a small
deterministic fix-up pass, so no float atomics and the same bits on
every launch.

On a CUDA tensor `fused_half_sweep` launches the kernel or raises; only a
CPU tensor takes `ops/tail.py::half_sweep_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops.tail import (TailStream, half_sweep_reference,
                                        run_tail_sweep)

RANGE = 256            # nonzeros per warp (a multiple of 32)
KQ_MAX = 256           # widest table row the kernel takes


def _check(p_tab, o_tab, p_ids, o_ids, y, rows):
    if p_tab.dim() != 2 or o_tab.dim() != 2 or \
            p_tab.shape[1] != o_tab.shape[1]:
        raise ValueError(f"tables {tuple(p_tab.shape)}, {tuple(o_tab.shape)}"
                         " must be [rows_p, kq] and [rows_o, kq]")
    if p_tab.dtype != o_tab.dtype or p_tab.dtype not in (torch.float32,
                                                         torch.bfloat16):
        raise ValueError(f"tables must both be float32 or both bfloat16, "
                         f"got {p_tab.dtype}, {o_tab.dtype}")
    quantum = 8 if p_tab.dtype == torch.bfloat16 else 4
    kq = p_tab.shape[1]
    if kq % quantum or kq > KQ_MAX:
        raise ValueError(f"table width {kq} is not a multiple of {quantum} "
                         f"(16-byte rows) up to {KQ_MAX}")
    if p_tab.shape[0] < rows:
        raise ValueError(f"primary table has {p_tab.shape[0]} rows < {rows}")
    nnz = p_ids.shape[0]
    for t, dt in ((p_ids, torch.int32), (o_ids, torch.int32),
                  (y, torch.float32)):
        if t.dim() != 1 or t.shape[0] != nnz or t.dtype != dt:
            raise ValueError(f"ids and y must be 1-D of one length, int32 "
                             f"and float32; got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (p_tab, o_tab, p_ids, o_ids, y):
        if not t.is_contiguous():
            raise ValueError("tail tensors must be contiguous")
        if t.device != p_tab.device:
            raise ValueError(f"tensors on {t.device} and {p_tab.device}")


def fused_half_sweep(p_tab: torch.Tensor, o_tab: torch.Tensor,
                     p_ids: torch.Tensor, o_ids: torch.Tensor,
                     y: torch.Tensor, rows: int) -> torch.Tensor:
    """f32 [rows, kq]: one half-sweep onto the primary side.

    p_tab [>= rows, kq], o_tab [rows_o, kq]: float32 or bfloat16, kq a
    whole number of 16-byte chunks; p_ids int32 ascending, o_ids int32,
    y float32, all [nnz] and in range (the layout of
    `ops/tail.py::build_tail_stream`). Untouched rows are zero."""
    _check(p_tab, o_tab, p_ids, o_ids, y, rows)
    if p_tab.device.type == "cpu":
        return half_sweep_reference(p_tab, o_tab, p_ids, o_ids, y, rows)
    if p_tab.device.type != "cuda":
        raise ValueError(f"no kernel for device {p_tab.device}")
    kq = p_tab.shape[1]
    nnz = p_ids.shape[0]
    out = torch.zeros((rows, kq), dtype=torch.float32, device=p_tab.device)
    if nnz == 0:
        return out
    warps = -(-nnz // RANGE)
    brow = torch.empty(2 * warps, dtype=torch.int32, device=p_tab.device)
    bacc = torch.empty((2 * warps, kq), dtype=torch.float32,
                       device=p_tab.device)
    bf16 = p_tab.dtype == torch.bfloat16
    lib = build.load_library()
    fn = lib.hpf_tail_half_sweep_bf16 if bf16 else \
        lib.hpf_tail_half_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(p_tab.device):
        stream = torch.cuda.current_stream(p_tab.device).cuda_stream
        err = fn(p_ids.data_ptr(), o_ids.data_ptr(), y.data_ptr(),
                 p_tab.data_ptr(), o_tab.data_ptr(), out.data_ptr(),
                 brow.data_ptr(), bacc.data_ptr(), nnz, kq, RANGE, stream)
    if err != 0:
        raise RuntimeError(f"tail half-sweep launch failed: cudaError {err} "
                           f"(nnz={nnz}, rows={rows}, kq={kq}, bf16={bf16})")
    fused_half_sweep.launches += 1
    return out


fused_half_sweep.launches = 0


def tail_sweep(a_lin, b_lin, ba_lin, bb_lin, stream: TailStream,
               bf16: bool = False):
    """Both halves of a tail sweep through the kernel (two launches on a
    CUDA tensor, the plain version on a CPU tensor). Returns (acc_a,
    acc_b, acc_ba | None, acc_bb | None), the finished y * phi sums."""
    return run_tail_sweep(fused_half_sweep, a_lin, b_lin, ba_lin, bb_lin,
                          stream, bf16)
