"""Device-resident training data: padded dual-sorted COO + dense uint8 Y.

Counterpart of `hgaprec_tpu/data/device.py`, dense half only. The COO is
padded to a block multiple and kept in two sort orders (user-major, and a
permutation into item-major order), as the JAX package keeps it; the ELBO
and the segment sweeps will read it. The dense sweep reads `dense_y`, the
count matrix as uint8 (like the reference's yval_t, env.hh:20).

`dense_y` rows are padded to a multiple of 512 when N > 4096, exactly as
the JAX layout does (ML-1M: 6040 -> 6144 rows). Its shape keeps M columns:
the CUDA sweep kernel masks the ragged item edge itself. Its row *stride*
is rounded up to 16 bytes (`dense_count_matrix`), so the kernel loads Y in
16-byte runs; nothing pads or copies Y per step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hgaprec_tpu_torch.data.ratings import RatingsStore


@dataclasses.dataclass(frozen=True)
class DeviceData:
    # user-sorted COO, padded to P (padding: y = 0, ids = last row)
    u_ids: torch.Tensor          # i32[P]
    i_ids: torch.Tensor          # i32[P]
    y: torch.Tensor              # f32[P]
    # permutation into item-sorted order and the sorted item ids
    item_order: torch.Tensor     # i32[P]
    i_ids_sorted: torch.Tensor   # i32[P]
    u_ids_by_item: torch.Tensor  # i32[P] = u_ids[item_order]
    dense_y: Optional[torch.Tensor]  # u8[N(padded), M] or None

    @property
    def nnz_padded(self) -> int:
        return self.u_ids.shape[0]


def dense_count_matrix(rows: int, m: int, device) -> torch.Tensor:
    """Zeroed uint8 [rows, m] view whose row stride is m rounded up to a
    multiple of 16 bytes (the padding bytes stay zero)."""
    stride = -(-m // 16) * 16
    return torch.zeros((rows, stride), dtype=torch.uint8,
                       device=device)[:, :m]


def build_device_data(store: RatingsStore, device, *,
                      pad_multiple: int = 1024,
                      dense_row_multiple: int = 512,
                      dense_limit_bytes: int = 10 << 30,
                      hybrid_head_items: int = 0) -> DeviceData:
    """Build the static-shape device tensors from a finalized host store.

    Catalogs too wide to densify (n * m > dense_limit_bytes) and the
    hybrid head/tail layout (hybrid_head_items > 0) belong to the
    big-sparse slice, which is not ported yet: both raise."""
    if hybrid_head_items > 0:
        raise NotImplementedError(
            "hybrid head/tail layout is not ported yet (ROADMAP queue 1, "
            "item 12: big-sparse hybrid)")
    n, m = store.n, store.m
    if n * m > dense_limit_bytes:
        raise NotImplementedError(
            f"catalog {n} x {m} does not densify under dense_limit_bytes="
            f"{dense_limit_bytes}; the hybrid/segment sweeps are not ported "
            "yet (ROADMAP queue 1, items 12-13)")
    u = store.coo_u.astype(np.int32)
    i = store.coo_i.astype(np.int32)
    y = store.coo_y.astype(np.float32)
    nnz = u.size
    p = max(pad_multiple, -(-max(nnz, 1) // pad_multiple) * pad_multiple)
    pad = p - nnz
    # pad with max ids so both sort orders remain ascending
    u = np.concatenate([u, np.full(pad, max(n - 1, 0), np.int32)])
    i = np.concatenate([i, np.full(pad, max(m - 1, 0), np.int32)])
    y = np.concatenate([y, np.zeros(pad, np.float32)])
    item_order = np.lexsort((u, i)).astype(np.int32)

    dense_y = None
    if n > 0 and m > 0:
        big = n * m > (1 << 28)
        npad = (-(-n // dense_row_multiple) * dense_row_multiple
                if (big or n > 4096) else n)
        # scatter on the device: the host never holds the [N, M] matrix
        dense_y = dense_count_matrix(npad, m, device)
        dense_y[torch.from_numpy(store.coo_u.astype(np.int64)).to(device),
                torch.from_numpy(store.coo_i.astype(np.int64)).to(device)] = \
            torch.from_numpy(np.minimum(store.coo_y, 255).astype(np.uint8)
                             ).to(device)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return DeviceData(
        u_ids=dev(u), i_ids=dev(i), y=dev(y),
        item_order=dev(item_order),
        i_ids_sorted=dev(i[item_order]),
        u_ids_by_item=dev(u[item_order]),
        dense_y=dense_y,
    )
