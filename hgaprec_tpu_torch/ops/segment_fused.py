"""CSR segment sweep: the CUDA kernel's wrapper.

Port of `docs/design/pallas_csr_sweep.py::sweep_pallas` (TPU kernel
`_sweep_pass_kernel`). One call runs both passes of a segment sweep over
`DeviceData`'s dual-sorted COO (ops/segment.py): the user pass finds and
keeps the weights w_j = y_j / max(<A[u], B[i]>, 1e-30) and sums acc_a; the
item pass reads w through `item_order` and sums acc_b. Tables are f32
always, as in the JAX segment path.

The kernel (`csrc/segment_fused.cu`) is bounded by the random row gathers,
one table row per nonzero in each pass (kq * 4 bytes) plus ids, y and a
random w read. Each pass cuts its sorted stream into fixed ranges of
nonzeros, one warp each, so a popular item spread over many ranges does
not leave the card idle; rows cut by a range meet in a fixed-order fix-up
pass, so no float atomics and the same bits on every launch.

On a CUDA tensor `fused_segment_sweep` launches the kernel or raises; only
a CPU tensor takes `ops/segment.py::segment_sweep_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops.segment import segment_sweep_reference
from hgaprec_tpu_torch.ops.tail import tail_tables

RANGE = 512            # nonzeros per warp (a multiple of 32)
KQ_MAX = 256           # widest table row the kernel takes


def _check(a_tab, b_tab, data: DeviceData):
    if a_tab.dim() != 2 or b_tab.dim() != 2 or \
            a_tab.shape[1] != b_tab.shape[1]:
        raise ValueError(f"tables {tuple(a_tab.shape)}, {tuple(b_tab.shape)}"
                         " must be [n, kq] and [m, kq]")
    if a_tab.dtype != torch.float32 or b_tab.dtype != torch.float32:
        raise ValueError(f"tables must be float32, got {a_tab.dtype}, "
                         f"{b_tab.dtype}")
    kq = a_tab.shape[1]
    if kq % 4 or kq > KQ_MAX:
        raise ValueError(f"table width {kq} is not a multiple of 4 "
                         f"(16-byte rows) up to {KQ_MAX}")
    p = data.u_ids.shape[0]
    for name in ("u_ids", "i_ids", "item_order", "i_ids_sorted",
                 "u_ids_by_item", "y"):
        t = getattr(data, name)
        dt = torch.float32 if name == "y" else torch.int32
        if t.dim() != 1 or t.shape[0] != p or t.dtype != dt:
            raise ValueError(f"{name} must be 1-D [{p}] {dt}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (a_tab, b_tab, data.u_ids, data.i_ids, data.y, data.item_order,
              data.i_ids_sorted, data.u_ids_by_item):
        if not t.is_contiguous():
            raise ValueError("segment sweep tensors must be contiguous")
        if t.device != a_tab.device:
            raise ValueError(f"tensors on {t.device} and {a_tab.device}")


def fused_segment_sweep(a_tab: torch.Tensor, b_tab: torch.Tensor,
                        data: DeviceData):
    """(out_a f32 [n, kq], out_b f32 [m, kq]): one segment sweep over
    `data`'s COO with the augmented f32 tables a_tab [n, kq], b_tab
    [m, kq] (kq a multiple of 4); ids in range and sorted as
    `build_device_data` lays them out. Untouched rows are zero."""
    _check(a_tab, b_tab, data)
    if a_tab.device.type == "cpu":
        return segment_sweep_reference(a_tab, b_tab, data)
    if a_tab.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_tab.device}")
    n, kq = a_tab.shape
    m = b_tab.shape[0]
    p = data.u_ids.shape[0]
    dev = a_tab.device
    out_a = torch.zeros((n, kq), dtype=torch.float32, device=dev)
    out_b = torch.zeros((m, kq), dtype=torch.float32, device=dev)
    if p == 0:
        return out_a, out_b
    w = torch.empty(p, dtype=torch.float32, device=dev)
    warps = -(-p // RANGE)
    brow = torch.empty(2 * warps, dtype=torch.int32, device=dev)
    bacc = torch.empty((2 * warps, kq), dtype=torch.float32, device=dev)
    fn = build.load_library().hpf_segment_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(data.u_ids.data_ptr(), data.i_ids.data_ptr(),
                 data.y.data_ptr(), data.item_order.data_ptr(),
                 data.i_ids_sorted.data_ptr(), data.u_ids_by_item.data_ptr(),
                 a_tab.data_ptr(), b_tab.data_ptr(), out_a.data_ptr(),
                 out_b.data_ptr(), w.data_ptr(), brow.data_ptr(),
                 bacc.data_ptr(), p, kq, RANGE, stream)
    if err != 0:
        raise RuntimeError(f"segment sweep launch failed: cudaError {err} "
                           f"(nnz={p}, n={n}, m={m}, kq={kq})")
    fused_segment_sweep.launches += 1
    return out_a, out_b


fused_segment_sweep.launches = 0


def segment_sweep(a_lin, b_lin, ba_lin, bb_lin, data: DeviceData):
    """One segment sweep through the kernel (the plain version on a CPU
    tensor) on the f32 augmented tables of the linear factors. Returns
    (acc_a [N, K], acc_b [M, K], acc_ba [N] | None, acc_bb [M] | None),
    the finished y * phi sums of `sweep_segment`."""
    k = a_lin.shape[1]
    a_t, b_t = tail_tables(a_lin, b_lin, ba_lin, bb_lin, bf16=False)
    out_a, out_b = fused_segment_sweep(a_t, b_t, data)
    if ba_lin is not None:
        return out_a[:, :k], out_b[:, :k], out_a[:, k], out_b[:, k + 1]
    return out_a[:, :k], out_b[:, :k], None, None
