"""Fused dense CAVI sweep: the CUDA kernel's wrapper and its plain version.

Port of `hgaprec_tpu/ops/dense_pallas.py::fused_dense_sweep`. For linear
factors A = exp(Elog theta) [N, K], B = exp(Elog beta) [M, K] and the
uint8 count matrix Y, with W = Y / max(A B^T, 1e-30):

    raw_a = W B,  raw_b = W^T A     [, rowsum W, colsum W with bias]

The caller multiplies by A and B (and the bias expectations) to get the
CAVI sufficient statistics (ops/sweep.py).

Two kernels replace the TPU kernel
`hgaprec_tpu/ops/dense_pallas.py::_kernel`: bf16 ("default") runs
`csrc/dense_wgmma.cu` (wgmma products on TMA-fed tiles), f32 ("highest",
the default precision of `ModelConfig` and the CLI) runs
`csrc/dense_simt.cu` (register-tiled FP32 FMAs fed by a cp.async
ring). A sweep costs 8 N M kq FLOPs (four products of 2 N M kq:
both of the kernels' two deterministic roles recompute S) against two
uint8 reads of Y, about 400 FLOPs per byte at K = 100, so it is
compute-bound on the H100. The two-role design trades the fourth product
for sums without atomics and no item-count limit. Each kernel is also
built once per stage of the stage probe (`ops/dense_probe.py`), whose
prod stage is the production kernel itself.

On a CUDA tensor `fused_dense_sweep` launches a kernel or raises; only
a CPU tensor takes `fused_dense_sweep_reference`, the same function in
blocked torch ops.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hgaprec_tpu_torch.ops import build

KP_MAX = 256           # widest packed factor row the kernels take


class _Kernel(NamedTuple):
    entry: str         # the library's C entry point
    probe: str         # the entry of its stage probe's instantiations
    probe_kq: int      # the widest packed row the probe's stages take
    tile: int          # stationary rows per CTA, the unit splits_for plans in
    per_sm: int        # CTAs resident on one SM
    min_chunk: int     # fewest tiles of moving rows one CTA sweeps when split


KERNELS = {
    # bf16: csrc/dense_wgmma.cu (one 384-thread CTA per SM); its stages are
    # built at kq = 112 only
    "wgmma": _Kernel("hpf_dense_wgmma_bf16", "hpf_dense_wgmma_probe_bf16",
                     112, 128, 1, 8),
    # f32: csrc/dense_simt.cu (one 256-thread CTA per SM, 224,256 bytes of
    # shared memory at kq = 104); its stages at the 64-row moving tile
    "f32": _Kernel("hpf_dense_simt_f32", "hpf_dense_simt_probe_f32", 104, 128,
                   1, 8),
}
_CLAMP = 1e-30
# (a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq, ldy, split_a, split_b
# [, stage], stream)
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
_ARGTYPES = {
    **{k.entry: _ARGS + [ctypes.c_void_p] for k in KERNELS.values()},
    **{k.probe: _ARGS + [ctypes.c_int, ctypes.c_void_p]
       for k in KERNELS.values()},
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The library's C entry `name`, typed once per process."""
    fn = getattr(build.load_library(), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _pack(a_lin, b_lin, ba_lin, bb_lin, width=None, dtype=torch.float32):
    """a = [A | ba | 1], b = [B | 1 | bb]: the score then includes both
    biases, and W b, W^T a deliver rowsum(W) in column k of raw_a and
    colsum(W) in column k+1 of raw_b (dense_pallas.py:139-152). `width`
    zero-pads the rows (the kernel loads them in 16-byte chunks)."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    kaug = k + 2 if ba_lin is not None else k
    width = width or kaug
    a = torch.zeros((n, width), dtype=dtype, device=a_lin.device)
    b = torch.zeros((m, width), dtype=dtype, device=b_lin.device)
    a[:, :k] = a_lin
    b[:, :k] = b_lin
    if ba_lin is not None:
        a[:, k] = ba_lin
        a[:, k + 1] = 1.0
        b[:, k] = 1.0
        b[:, k + 1] = bb_lin
    return a, b


def _unpack(acc_a, acc_b, k: int, bias: bool):
    if bias:
        return acc_a[:, :k], acc_b[:, :k], acc_a[:, k], acc_b[:, k + 1]
    return acc_a[:, :k], acc_b[:, :k]


def packed_width(kaug: int, kernel: str) -> int:
    """The zero-padded width kq of the packed rows `kernel` takes for
    `kaug` values (K, plus 2 with bias). f32 copies rows in 16-byte
    chunks (multiples of 4 values; the kernel loops over this true width,
    100 at K = 100); wgmma stages them as
    128-byte-swizzled k-blocks of 64 values (TMA zero-fills the rest of a
    last partial block) and is built for kq = 64, 112, 128 and 256
    (K = 100 takes 112, with or without bias)."""
    if kernel == "wgmma":
        kq = next((w for w in (64, 112, 128, 256) if kaug <= w), kaug)
    else:
        kq = -(-kaug // 4) * 4
    if kq > KP_MAX:
        raise ValueError(f"packed factor width {kq} > {KP_MAX}")
    return kq


def check_tma_layout(dense_y: torch.Tensor) -> None:
    """The wgmma kernel loads Y with TMA, which needs a row stride and a
    base that are multiples of 16 bytes (the Trainer's layouts are:
    data/device.py, dense_count_matrix). Raises ValueError otherwise;
    there is no byte-load fallback."""
    if dense_y.stride(0) % 16 or dense_y.data_ptr() % 16:
        raise ValueError(
            f"the bf16 kernel loads Y with TMA: its row stride "
            f"({dense_y.stride(0)} bytes) and base must be multiples of 16 "
            f"bytes (build Y with data.device.dense_count_matrix)")


def splits_for(n: int, m: int, sms: int, kernel: str) -> Tuple[int, int]:
    """(split_a, split_b): chunks per user-role and item-role CTA loop.

    One CTA per stationary tile leaves most of the card idle when N and M
    are small (ML-1M, wgmma: 48 + 29 CTAs for 132 SMs), so each role's
    moving loop is cut into chunks of at least `min_chunk` tiles, aiming
    at about four CTAs per resident slot. At Netflix shape the chunks are
    thousands of tiles long and the item role splits in two; at the
    EchoNest head (4096 items) the item role splits in nine."""
    spec = KERNELS[kernel]
    tiles_a, tiles_b = -(-n // spec.tile), -(-m // spec.tile)
    slots = spec.per_sm * sms
    chunk = max(spec.min_chunk, -(-2 * tiles_a * tiles_b // (4 * slots)))
    return -(-tiles_b // chunk), -(-tiles_a // chunk)


def _check(a_lin, b_lin, dense_y, ba_lin, bb_lin):
    if a_lin.dim() != 2 or b_lin.dim() != 2 or a_lin.shape[1] != b_lin.shape[1]:
        raise ValueError(f"a_lin {tuple(a_lin.shape)} and b_lin "
                         f"{tuple(b_lin.shape)} must be [N, K] and [M, K]")
    n, m = a_lin.shape[0], b_lin.shape[0]
    if dense_y.dim() != 2 or dense_y.dtype != torch.uint8:
        raise ValueError(f"dense_y must be a 2-D uint8 tensor, got "
                         f"{dense_y.dtype} {tuple(dense_y.shape)}")
    if dense_y.shape[0] < n or dense_y.shape[1] < m:
        raise ValueError(f"dense_y {tuple(dense_y.shape)} smaller than "
                         f"[{n}, {m}]")
    if (ba_lin is None) != (bb_lin is None):
        raise ValueError("pass both bias vectors or neither")
    vecs = [a_lin, b_lin] + ([ba_lin, bb_lin] if ba_lin is not None else [])
    if ba_lin is not None and (tuple(ba_lin.shape) != (n,)
                               or tuple(bb_lin.shape) != (m,)):
        raise ValueError(f"bias shapes {tuple(ba_lin.shape)}, "
                         f"{tuple(bb_lin.shape)} != ({n},), ({m},)")
    for t in vecs:
        if t.dtype != torch.float32:
            raise ValueError(f"factors must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("factor tensors must be contiguous")
        if t.device != dense_y.device:
            raise ValueError(f"tensors on {t.device} and {dense_y.device}")
    if dense_y.stride(1) != 1:
        raise ValueError("dense_y rows must be contiguous (stride(1) == 1)")


def fused_dense_sweep(a_lin: torch.Tensor, b_lin: torch.Tensor,
                      dense_y: torch.Tensor,
                      ba_lin: Optional[torch.Tensor] = None,
                      bb_lin: Optional[torch.Tensor] = None,
                      *, bf16: bool = False) -> Tuple[torch.Tensor, ...]:
    """(W B, W^T A[, rowsum W, colsum W]) with W = Y / (A B^T [+ biases]).

    a_lin f32 [N, K], b_lin f32 [M, K], dense_y u8 [>= N, >= M] (rows may
    be padded, rows may be wider than M), ba_lin/bb_lin optional f32 [N],
    [M]. bf16=True reads A and B as bf16 and rounds W to bf16 before the
    contraction products, accumulating in f32; on a CUDA tensor it needs
    Y's row stride and base at multiples of 16 bytes (`check_tma_layout`).
    Returns 2 or 4 f32 tensors.
    """
    _check(a_lin, b_lin, dense_y, ba_lin, bb_lin)
    if dense_y.device.type == "cpu":
        return fused_dense_sweep_reference(a_lin, b_lin, dense_y, ba_lin,
                                           bb_lin, bf16=bf16)
    if dense_y.device.type != "cuda":
        raise ValueError(f"no kernel for device {dense_y.device}")
    acc_a, acc_b = launch_dense(a_lin, b_lin, dense_y, ba_lin, bb_lin,
                                kernel="wgmma" if bf16 else "f32")
    if a_lin.shape[0] and b_lin.shape[0]:     # an empty side launches nothing
        fused_dense_sweep.launches += 1
    return _unpack(acc_a, acc_b, a_lin.shape[1], ba_lin is not None)


def launch_dense(a_lin, b_lin, dense_y, ba_lin=None, bb_lin=None, *,
                 kernel: str, stage: Optional[int] = None):
    """Pack the factors, launch `kernel` (a key of KERNELS) on the card and
    return the raw packed outputs (f32 [N, kq], [M, kq]). An int `stage`
    (ops/dense_probe.py's STAGES) runs that kernel built for that stage of
    the stage probe, on rows packed to the probe's width (wgmma: 112; f32:
    at most 104). Inputs are checked by the caller; the wgmma kernel's Y
    layout is checked here."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    spec = KERNELS[kernel]
    kq = packed_width(k + 2 if ba_lin is not None else k, kernel)
    if stage is not None:
        if kq > spec.probe_kq:
            raise ValueError(f"the {kernel} probe's stages take packed rows "
                             f"of at most {spec.probe_kq} values, not {kq}")
        if kernel == "wgmma":
            kq = spec.probe_kq      # its stages are built for this width
    if kernel == "wgmma":
        check_tma_layout(dense_y)
    a, b = _pack(a_lin, b_lin, ba_lin, bb_lin, kq,
                 torch.float32 if kernel == "f32" else torch.bfloat16)
    acc_a = torch.empty((n, kq), dtype=torch.float32, device=a.device)
    acc_b = torch.empty((m, kq), dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return acc_a.zero_(), acc_b.zero_()
    split_a, split_b = splits_for(
        n, m, torch.cuda.get_device_properties(a.device).multi_processor_count,
        kernel)
    part_a = (torch.empty((split_a, n, kq), dtype=torch.float32,
                          device=a.device) if split_a > 1 else None)
    part_b = (torch.empty((split_b, m, kq), dtype=torch.float32,
                          device=a.device) if split_b > 1 else None)
    fn = _entry(spec.entry if stage is None else spec.probe)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), dense_y.data_ptr(),
                 acc_a.data_ptr(), acc_b.data_ptr(),
                 None if part_a is None else part_a.data_ptr(),
                 None if part_b is None else part_b.data_ptr(), n, m, kq,
                 dense_y.stride(0), split_a, split_b,
                 *([stage] if stage is not None else []), stream)
    if err != 0:
        raise RuntimeError(f"dense sweep launch failed: cudaError {err} "
                           f"(n={n}, m={m}, kq={kq}, kernel={kernel}, "
                           f"stage={stage}, splits={split_a}, {split_b})")
    return acc_a, acc_b


fused_dense_sweep.launches = 0


def hgmma_counts() -> Dict[int, int]:
    """Warpgroup tensor-core instructions (HGMMA) in the wgmma kernel's
    machine code, by production instantiation (packed width kq; the stage
    probe's other stages are not counted): a width whose count is zero had
    its products folded away."""
    counts: Dict[int, int] = {}
    kq = None
    for line in build.sass().splitlines():
        if "Function :" in line:
            hit = re.search(r"dense_wgmma_kernelILi(\d+)ELi0EE", line)
            kq = int(hit.group(1)) if hit else None
            if kq is not None:
                counts[kq] = 0
        elif kq is not None and "HGMMA" in line:
            counts[kq] += 1
    return counts


def fused_dense_sweep_reference(a_lin: torch.Tensor, b_lin: torch.Tensor,
                                dense_y: torch.Tensor,
                                ba_lin: Optional[torch.Tensor] = None,
                                bb_lin: Optional[torch.Tensor] = None,
                                *, bf16: bool = False,
                                user_block: int = 8192,
                                item_block: int = 4096
                                ) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in blocked torch ops (same contract).

    Blocks of users x items bound the [block, block] score tile, so the
    plain version also runs at Netflix shape. bf16 rounding is emulated
    in f32 arithmetic (A, B and W rounded to bf16 where the kernel rounds
    them), so the result does not depend on a bf16 product's summation
    order."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    bias = ba_lin is not None
    a, b = _pack(a_lin, b_lin, ba_lin, bb_lin)
    if bf16:
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    acc_a = torch.zeros((n, a.shape[1]), dtype=torch.float32, device=a.device)
    acc_b = torch.zeros((m, a.shape[1]), dtype=torch.float32, device=a.device)
    for u0 in range(0, n, user_block):
        u1 = min(u0 + user_block, n)
        a_u = a[u0:u1]
        for c0 in range(0, m, item_block):
            c1 = min(c0 + item_block, m)
            b_c = b[c0:c1]
            y = dense_y[u0:u1, c0:c1].float()
            w = y / torch.clamp_min(a_u @ b_c.T, _CLAMP)
            if bf16:
                w = w.to(torch.bfloat16).float()
            acc_a[u0:u1] += w @ b_c
            acc_b[c0:c1] += w.T @ a_u
    return _unpack(acc_a, acc_b, k, bias)
