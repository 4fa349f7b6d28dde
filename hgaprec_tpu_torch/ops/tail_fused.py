"""Sparse-tail half-sweep: the CUDA kernels' wrapper.

Port of `hgaprec_tpu/ops/pallas_tail.py::pallas_half_sweep` and
`pallas_tail_sweep`. For a stream sorted by its primary ids p, with
other-side ids o, counts y and bias-augmented tables P, O (ops/tail.py):

    out[r] = sum_{j: p_j = r} w_j * P[r] (.) O[o_j],
    w_j = y_j / max(<P[r], O[o_j]>, 1e-30)

Two kernels replace the TPU kernel `hgaprec_tpu/ops/pallas_tail.py::
_kernel`, both bounded by the random row gathers: one O row per nonzero
(kq * 2 bytes in bf16, kq * 4 in f32) plus 12 bytes of ids and y.
  * bf16 ("default"), `csrc/tail_bf16.cu`: a lane group of 8, 16 or 32
    lanes (one 16-byte chunk of a row per lane, `plan`) owns each range of
    RANGE nonzeros, and keeps several O rows, and the P row of each run
    that starts among them, in flight in a cp.async ring in shared memory.
  * f32 ("highest"), `csrc/tail_fused.cu`: a warp owns each range and
    loads the next O row while it computes one (`csrc/row_sweep.cuh`).
Either keeps a run's running sum in registers and writes each finished row
once; the first and last run of each range go to two boundary slots that
a small fix-up pass adds in range order, so no float atomics and the same
bits on every launch.

On a CUDA tensor `fused_half_sweep` launches a kernel or raises; only a
CPU tensor takes `ops/tail.py::half_sweep_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops.tail import (TailStream, half_sweep_reference,
                                        run_tail_sweep)

RANGE = 256            # nonzeros per range (a multiple of 32)
KQ_MAX = 256           # widest table row the kernels take


def plan(bf16: bool, kq: int) -> Tuple[str, int]:
    """(C entry, lanes per range) for rows of kq values: the bf16 kernel's
    lane group holds one 16-byte chunk (8 values) per lane, 8 lanes up to
    kq = 64, 16 up to 128, 32 beyond (`csrc/tail_bf16.cu` picks the same);
    the f32 row sweep runs a warp per range."""
    if not bf16:
        return "hpf_tail_half_sweep_f32", 32
    return "hpf_tail_half_sweep_bf16", 8 if kq <= 64 else 16 if kq <= 128 \
        else 32


def scratch_rows(nnz: int) -> int:
    """Boundary slots for a stream of nnz > 0 nonzeros: two per range of
    RANGE (the kernels' `brow` [slots] and `bacc` [slots, kq])."""
    return 2 * -(-nnz // RANGE)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A C entry of the kernel library, its argument types set once."""
    fn = getattr(build.load_library(), name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    slots = scratch_rows(nnz)
    brow = torch.empty(slots, dtype=torch.int32, device=p_tab.device)
    bacc = torch.empty((slots, kq), dtype=torch.float32, device=p_tab.device)
    bf16 = p_tab.dtype == torch.bfloat16
    name, lanes = plan(bf16, kq)
    fn = _entry(name)
    with torch.cuda.device(p_tab.device):
        stream = torch.cuda.current_stream(p_tab.device).cuda_stream
        err = fn(p_ids.data_ptr(), o_ids.data_ptr(), y.data_ptr(),
                 p_tab.data_ptr(), o_tab.data_ptr(), out.data_ptr(),
                 brow.data_ptr(), bacc.data_ptr(), nnz, kq, RANGE, stream)
    if err != 0:
        raise RuntimeError(f"tail half-sweep launch failed: cudaError {err} "
                           f"({name}, {lanes} lanes per range; nnz={nnz}, "
                           f"rows={rows}, kq={kq})")
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
