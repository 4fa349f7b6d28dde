"""Sparse-tail half-sweep: the CUDA kernels' wrapper.

Port of `hgaprec_tpu/ops/pallas_tail.py::pallas_half_sweep` and
`pallas_tail_sweep`. For a stream sorted by its primary ids p, with
other-side ids o, counts y and bias-augmented tables P, O (ops/tail.py):

    out[r] = sum_{j: p_j = r} w_j * P[r] (.) O[o_j],
    w_j = y_j / max(<P[r], O[o_j]>, 1e-30)

Two routes replace the TPU kernel `hgaprec_tpu/ops/pallas_tail.py::
_kernel`, both bounded by the random row gathers:
  * bf16 ("default"), `csrc/tail_bf16.cu`: a lane group of 8, 16 or 32
    lanes (one 16-byte chunk of a row per lane; past 256 values the wide
    passes' group shapes, `plan`) owns each range of RANGE nonzeros, and
    keeps several O rows, and the P row of each run that starts among
    them, in flight in a cp.async ring in shared memory.
    Each half is one launch of `fused_half_sweep`.
  * f32 ("highest"), the CSR sweep's two passes (`csrc/segment_sweep.cu`,
    ops/segment_fused.py): the user-sorted half is the user pass, which
    keeps each w_j; the item-sorted half is the item pass, which reads w_j
    through `TailStream.order` instead of forming the dot again, over the
    tail's own slab stream (users cut into L2-sized slabs, the stream in
    (slab, item, user) order). One half alone (`fused_half_sweep`) runs
    the user pass's kernel on that half's stream.
Both keep a run's sum in registers and write each finished row once; the
first and last run of each range go to two boundary slots that a small
fix-up pass adds in range order, so no float atomics and the same bits on
every launch.

On a CUDA tensor `fused_half_sweep` and `tail_halves` launch kernels or
raise; only a CPU tensor takes the plain versions of `ops/tail.py`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops import segment_fused as sf
from hgaprec_tpu_torch.ops.tail import (TailStream, half_sweep_reference,
                                        run_tail_sweep)

RANGE = 256            # nonzeros per range of the bf16 kernel (x 32)
# The f32 route's slab stream (ops/segment_fused.py::slab_stream): user
# slabs of SLAB_BYTES of A rows and weights, and an item of the tail keeps
# slab order only where its entries outnumber SLAB_FILL times its extra
# pair rows (the median tail item has fewer entries than there are
# slabs). Both chosen on the H100 at the EchoNest tail (PERF.md, PR 9):
# the item half took 1.48 ms at 48 MB and fill 4, 1.70 ms at the CSR
# sweep's 24 MB with every item in slab order.
SLAB_BYTES = 48 << 20
SLAB_FILL = 4


def plan(bf16: bool, kq: int) -> Tuple[str, sf.Plan]:
    """(C entry, shape) of one half for rows of kq values: the bf16
    kernel's, or in f32 the CSR sweep's user pass
    (`ops/segment_fused.py::pass_plan`)."""
    return ("hpf_tail_half_sweep_bf16" if bf16 else
            "hpf_segment_user_pass_f32", sf.pass_plan(kq, bf16))


def scratch_rows(nnz: int, bf16: bool) -> int:
    """Boundary slots for a stream of nnz > 0 nonzeros: two per range of
    the route's kernel (RANGE nonzeros in bf16, the CSR sweep's sf.RANGE
    in f32), the kernels' `brow` [slots] and `bacc` [slots, kq]."""
    return 2 * -(-nnz // (RANGE if bf16 else sf.RANGE))


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The bf16 C entry of the kernel library, its argument types set
    once."""
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
    if kq % quantum:
        raise ValueError(f"table width {kq} is not a multiple of {quantum} "
                         f"(16-byte rows)")
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
    dev = p_tab.device
    bf16 = p_tab.dtype == torch.bfloat16
    if nnz == 0 or bf16:
        out = torch.zeros((rows, kq), dtype=torch.float32, device=dev)
    else:                   # the user pass zeroes the rows it does not write
        out = torch.empty((rows, kq), dtype=torch.float32, device=dev)
    if nnz == 0:
        return out
    slots = scratch_rows(nnz, bf16)
    name, shape = plan(bf16, kq)
    brow = torch.empty(slots, dtype=torch.int32, device=dev)
    # past one window the bf16 kernel keeps the weights in rows of bacc
    # after the slots (the same rule as csrc/tail_bf16.cu's entry)
    extra = -(-nnz // kq) if bf16 and kq > sf.ONE_WINDOW_MAX else 0
    bacc = torch.empty((slots + extra, kq), dtype=torch.float32, device=dev)
    if not bf16:            # the user pass, its weights thrown away
        sf.user_pass(p_tab, o_tab, p_ids, o_ids, y, out, sf.Scratch(
            torch.empty(nnz, dtype=torch.float32, device=dev), brow, bacc),
            tail=True)
        fused_half_sweep.launches += 1
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(name)(p_ids.data_ptr(), o_ids.data_ptr(), y.data_ptr(),
                           p_tab.data_ptr(), o_tab.data_ptr(),
                           out.data_ptr(), brow.data_ptr(), bacc.data_ptr(),
                           nnz, kq, RANGE, stream)
    if err != 0:
        raise RuntimeError(f"tail half-sweep launch failed: cudaError {err} "
                           f"({name}, {shape}; nnz={nnz}, rows={rows}, "
                           f"kq={kq})")
    fused_half_sweep.launches += 1
    return out


fused_half_sweep.launches = 0


def tail_slabs(stream: TailStream, n: int, m: int, kq: int,
               slab_bytes: int = SLAB_BYTES,
               fill: int = SLAB_FILL) -> sf.SlabStream:
    """The f32 route's item-pass stream of the tail for tables of n user
    and m item rows of kq floats, built on the card at the first sweep and
    kept in `stream.slab_cache`."""
    return sf.slab_stream(stream.u, stream.order, stream.i_by_item,
                          stream.u_by_item, stream.slab_cache, n, m, kq,
                          slab_bytes, fill)


def tail_halves(a_t: torch.Tensor, b_t: torch.Tensor, stream: TailStream,
                slab_bytes: int = SLAB_BYTES):
    """(acc_a f32 [n, kq], acc_b f32 [m, kq]): both halves of a tail sweep
    on the augmented tables a_t = [A | ba | 1], b_t = [B | 1 | bb] and a
    stream of nnz > 0 nonzeros. bf16 tables and CPU tensors take
    `fused_half_sweep` once per half; f32 tables on the card take the CSR
    sweep's user pass and then its item pass over the tail's slab stream
    (user slabs of `slab_bytes`, sparse items first by SLAB_FILL), which
    reads the user pass's weights: two launches, each counted in
    `fused_half_sweep.launches`. Every row of both outputs is written
    (zero where no nonzero lies)."""
    (n, kq), m = a_t.shape, b_t.shape[0]
    if a_t.dtype == torch.bfloat16 or a_t.device.type == "cpu":
        return (fused_half_sweep(a_t, b_t, stream.u, stream.i, stream.y, n),
                fused_half_sweep(b_t, a_t, stream.i_by_item,
                                 stream.u_by_item, stream.y_by_item, m))
    _check(a_t, b_t, stream.u, stream.i, stream.y, n)
    if a_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_t.device}")
    sc = sf.Scratch.make(stream.nnz, kq, a_t.device)
    # every row: those with an entry summed, the others zeroed
    acc_a = torch.empty((n, kq), dtype=torch.float32, device=a_t.device)
    sf.user_pass(a_t, b_t, stream.u, stream.i, stream.y, acc_a, sc,
                 tail=True)
    fused_half_sweep.launches += 1
    # the host checks and lays out the item half while the card runs
    _check(b_t, a_t, stream.i_by_item, stream.u_by_item, stream.y_by_item, m)
    slabs = tail_slabs(stream, n, m, kq, slab_bytes)
    acc_b = torch.empty((m, kq), dtype=torch.float32, device=a_t.device)
    sf.item_pass(a_t, b_t, slabs, acc_b, sc, tail=True)
    fused_half_sweep.launches += 1
    return acc_a, acc_b


def tail_sweep(a_lin, b_lin, ba_lin, bb_lin, stream: TailStream,
               bf16: bool = False):
    """Both halves of a tail sweep through the kernels (two launches on a
    CUDA tensor, the plain version on a CPU tensor). Returns (acc_a,
    acc_b, acc_ba | None, acc_bb | None), the finished y * phi sums."""
    return run_tail_sweep(tail_halves, a_lin, b_lin, ba_lin, bb_lin, stream,
                          bf16)
