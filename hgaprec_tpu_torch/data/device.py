"""Device-resident training data: padded dual-sorted COO, dense uint8 Y,
and the hybrid head/tail split.

Counterpart of `hgaprec_tpu/data/device.py`. The COO is
padded to a block multiple and kept in two sort orders (user-major, and a
permutation into item-major order), as the JAX package keeps it; the ELBO
and the segment sweeps read it. The dense sweep reads `dense_y`, the
count matrix as uint8 (like the reference's yval_t, env.hh:20).

`dense_y` rows are padded to a multiple of 512 when N > 4096, exactly as
the JAX layout does (ML-1M: 6040 -> 6144 rows). Its shape keeps M columns:
the CUDA sweep kernel masks the ragged item edge itself. Its row *stride*
is rounded up to 16 bytes (`dense_count_matrix`), so the kernel loads Y in
16-byte runs; nothing pads or copies Y per step.

Catalogs too wide to densify get the hybrid layout (device.py:85-125 of
the JAX package): the top-T items by degree form a dense uint8 head block
[npad, T] that the same kernel sweeps, and the remaining nonzeros form the
tail stream (ops/tail.py::TailStream). Both Y blocks are scattered on the
device, so the host never holds a multi-GB matrix.

The head's width T: on the CPU the JAX package's (`head_width`). On a
CUDA device `head_width` is only the cap, and `card_head_width` keeps the
top items in groups of 128 while each group costs the card more on the
sparse passes than on the dense kernel, which sweeps every cell of the
head block, zero or not; the costs are kernel #1's route's, which the
precision and the factor count choose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hgaprec_tpu_torch.data.ratings import RatingsStore
from hgaprec_tpu_torch.ops.dense_fused import dense_kernel
from hgaprec_tpu_torch.ops.tail import TailStream, build_tail_stream, upload
from hgaprec_tpu_torch.trace import note, span


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
    # hybrid head/tail split (ops/sweep.py::sweep_hybrid): column j of the
    # head block is item head_items[j]; the tail holds the other nonzeros
    head_items: Optional[torch.Tensor] = None     # i32[T]
    head_dense_y: Optional[torch.Tensor] = None   # u8[npad, T]
    tail: Optional[TailStream] = None
    # the CSR sweep kernel's item-pass streams, built from the fields above
    # at first use and kept here, by their sizing
    # (ops/segment_fused.py::slab_stream)
    slab_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def nnz_padded(self) -> int:
        return self.u_ids.shape[0]


def dense_count_matrix(rows: int, m: int, device) -> torch.Tensor:
    """Zeroed uint8 [rows, m] view whose row stride is m rounded up to a
    multiple of 16 bytes (the padding bytes stay zero)."""
    stride = -(-m // 16) * 16
    return torch.zeros((rows, stride), dtype=torch.uint8,
                       device=device)[:, :m]


def head_width(n: int, m: int, hybrid_head_items: int,
               head_limit_bytes: int, dense_row_multiple: int = 512) -> int:
    """Head items T for the hybrid layout (device.py:88-100 of the JAX
    package): min(hybrid_head_items, m), clipped to the byte budget over
    npad rows and to a multiple of 512 columns; 0 (no head) when the
    budget cannot fit min(T, 512) columns."""
    if hybrid_head_items <= 0 or m <= 0:
        return 0
    t = min(hybrid_head_items, m)
    npad = -(-max(n, 1) // dense_row_multiple) * dense_row_multiple
    budget = head_limit_bytes // max(npad, 1)
    if budget < min(t, 512):
        return 0
    t = min(t, budget)
    if t >= 512:
        t = (t // 512) * 512
    return t


# The card's break-even density of a group of head columns, by kernel #1's
# route for the head (ops/dense_fused.py::dense_kernel): a group whose
# nonzeros fill more than this share of its npad x HEAD_GROUP cells costs
# more on the sparse passes than on the dense kernel, which sweeps every
# cell, zero or not. Each is the dense kernel's seconds a cell over the
# sparse passes' seconds a nonzero, least-squares slopes of the layers'
# device time in the replayed step against the head's cells and the
# tail's nonzeros over T = 128-4096, scripts/head_width_costs.py on the
# EchoNest benchmark draw (1,019,318 x 384,546, 48,373,586 nonzeros),
# NVIDIA H100 80GB HBM3 at 700 W. The narrow routes were measured at
# K = 100, the resident wide kernel's at K = 300 (the sparse passes on
# their wide lanes). The cluster kernel's and the unfused route's widths
# were not measured: there the head keeps the JAX width.
BREAK_EVEN_DENSITY = {
    "f32": 7.421e-12 / 1.791e-10,        # "highest", K = 100: 4.14%
    "wgmma": 1.327e-12 / 1.586e-10,      # bf16, K = 100: 0.84%
    "wide_f32": 3.580e-11 / 3.385e-10,   # "highest", K = 300: 10.58%
    "wide": 8.831e-12 / 3.993e-10,       # bf16, K = 300: 2.21%
}
# the head's unit: the dense kernels' stationary tile
# (ops/dense_fused.py: KERNELS["f32"].tile, KERNELS["wgmma"].tile)
HEAD_GROUP = 128


def card_head_width(degrees: np.ndarray, npad: int, t_max: int,
                    precision: str = "highest", kaug: int = 0) -> int:
    """Head items T on a CUDA device: the items in descending degree
    (`top_degree_items`' order), taken in groups of HEAD_GROUP while a
    group's nonzeros fill more than BREAK_EVEN_DENSITY of its npad x
    HEAD_GROUP cells, never past t_max (the last group clipped to it).
    Degrees fall, so the first group that does not pay ends the head; 0
    when none pays. The density is that of kernel #1's route at
    `precision` for `kaug` packed values (K, K + 2 with bias; the default,
    0, as any width up to 128, takes the narrow routes'); a route with
    none measured keeps t_max."""
    density = BREAK_EVEN_DENSITY.get(
        dense_kernel(kaug, precision == "default"))
    if density is None:
        return t_max
    top = -np.sort(-np.asarray(degrees, np.int64))[:t_max]
    pays = density * npad * HEAD_GROUP
    t = 0
    while t < top.size and top[t:t + HEAD_GROUP].sum() > pays:
        t = min(t + HEAD_GROUP, top.size)
    return t


def _scatter_counts(rows: int, cols: int, u: np.ndarray, c: np.ndarray,
                    y: np.ndarray, device) -> torch.Tensor:
    """uint8 [rows, cols] (16-byte row stride) holding min(y, 255) at
    (u, c), scattered on the device."""
    out = dense_count_matrix(rows, cols, device)
    out[upload(u.astype(np.int64), device),
        upload(c.astype(np.int64), device)] = \
        upload(np.minimum(y, 255).astype(np.uint8), device)
    return out


def build_device_data(store: RatingsStore, device, *,
                      pad_multiple: int = 1024,
                      dense_row_multiple: int = 512,
                      dense_limit_bytes: int = 10 << 30,
                      hybrid_head_items: int = 0,
                      head_limit_bytes: int = 4 << 30,
                      precision: str = "highest",
                      kaug: int = 0) -> DeviceData:
    """Build the static-shape device tensors from a finalized host store.

    `dense_y` is built when the catalog densifies (n * m <=
    dense_limit_bytes). hybrid_head_items > 0 additionally splits the
    nonzeros into a head block over the top-T items by degree and a tail
    stream; when the head budget cannot fit 512 columns no head is built,
    and a catalog that neither densifies nor gets a head keeps only the
    COO (the JAX package's layout rules). On a CUDA device T is
    `card_head_width`'s at `precision` (the sweep's matmul precision) and
    `kaug` (K, K + 2 with bias), within the JAX width; no group that pays
    gives no head. Spanned as `layout`, its parts as `layout.*`
    (trace.py); T and the head's share
    of the nonzeros are then noted as `layout.head_items` and
    `layout.head_share` (`head_notes`)."""
    n, m = store.n, store.m
    with span("layout"):
        with span("layout.select"):
            t = head_width(n, m, hybrid_head_items, head_limit_bytes,
                           dense_row_multiple) if store.coo_u.size > 0 else 0
            head_ids = None
            if t > 0:
                degrees = np.bincount(store.coo_i, minlength=m)
                if torch.device(device).type == "cuda":
                    npad = -(-n // dense_row_multiple) * dense_row_multiple
                    t = card_head_width(degrees, npad, t, precision,
                                        kaug)
                if t > 0:
                    head_ids = top_degree_items(degrees, t)
        data = build_layout(store.coo_u, store.coo_i, store.coo_y, n, m,
                            device, head_ids=head_ids,
                            dense=(n * m <= dense_limit_bytes and n > 0
                                   and m > 0),
                            pad_multiple=pad_multiple,
                            dense_row_multiple=dense_row_multiple)
    note_head(data)
    return data


def head_notes(data: DeviceData) -> dict:
    """A layout's hybrid head: {"layout.head_items": its width T (0: no
    head), "layout.head_share": its share of the layout's nonzeros (0.0
    without a head)}."""
    t = 0 if data.head_items is None else int(data.head_items.numel())
    share = 0.0
    if t:
        nnz = int((data.y > 0).sum())   # the COO's padding holds y = 0
        share = 1.0 - data.tail.nnz / max(nnz, 1)
    return {"layout.head_items": t, "layout.head_share": share}


def note_head(data: DeviceData) -> None:
    """Note a layout's `head_notes` in the trace (trace.py)."""
    for name, value in head_notes(data).items():
        note(name, value)


def top_degree_items(degrees: np.ndarray, t: int) -> np.ndarray:
    """i32[t]: the t items of highest degree (ties to the lower id),
    ascending: the head set of the hybrid layout."""
    with span("layout.sort"):
        return np.sort(np.argsort(-degrees, kind="stable")[:t]).astype(
            np.int32)


def build_layout(u: np.ndarray, i: np.ndarray, y: np.ndarray, n: int, m: int,
                 device, *, head_ids: Optional[np.ndarray] = None,
                 dense: bool = False, pad_multiple: int = 1024,
                 dense_row_multiple: int = 512,
                 pad_row: Optional[int] = None) -> DeviceData:
    """The device layout of a user-sorted (user, item) COO over n user rows
    and m items: the dual-sorted COO, `dense_y` when `dense`, and with
    `head_ids` the hybrid head block over those items and the tail stream
    of the other nonzeros. A user shard (parallel/sharded.py) passes its
    own rows with local user ids and the global head set. The COO's
    padding entries (y = 0) sit at `pad_row` (default: the last row)."""
    u = u.astype(np.int32)
    i = i.astype(np.int32)
    y = y.astype(np.float32)
    npad = -(-max(n, 1) // dense_row_multiple) * dense_row_multiple

    head_items = head_dense = tail = None
    if head_ids is not None:
        head_items, head_dense, tail = head_and_tail(u, i, y, m, npad,
                                                     head_ids, device)

    dense_y = None
    if dense:
        big = n * m > (1 << 28)
        # scatter on the device: the host never holds the [N, M] matrix
        with span("layout.head"):
            dense_y = _scatter_counts(npad if (big or n > 4096) else n, m, u,
                                      i, y, device)

    with span("layout.coo"):
        coo = sorted_coo(u, i, y, n if pad_row is None else pad_row + 1, m,
                         device, pad_multiple)
    return DeviceData(**coo, dense_y=dense_y, head_items=head_items,
                      head_dense_y=head_dense, tail=tail)


def head_and_tail(u: np.ndarray, i: np.ndarray, y: np.ndarray, m: int,
                  npad: int, head_ids: np.ndarray, device):
    """(head_items, head_dense_y, tail) of the hybrid layout: the uint8
    [npad, T] block over the items `head_ids` and the tail stream of the
    other nonzeros of the (int32 user, int32 item, f32 count) COO."""
    with span("layout.head"):
        col_of = np.full(m, -1, np.int32)
        col_of[head_ids] = np.arange(head_ids.size, dtype=np.int32)
        in_head = col_of[i] >= 0
        head_dense = _scatter_counts(npad, head_ids.size, u[in_head],
                                     col_of[i[in_head]], y[in_head], device)
        head_items = upload(head_ids, device)
    with span("layout.tail"):
        rest = ~in_head
        tail = build_tail_stream(u[rest], i[rest], y[rest], device)
    return head_items, head_dense, tail


def sorted_coo(u: np.ndarray, i: np.ndarray, y: np.ndarray, n: int, m: int,
               device, pad_multiple: int = 1024):
    """DeviceData's COO fields from a user-sorted (user, item) stream:
    padded to a multiple of pad_multiple (at least one block) with y = 0
    at the last user and item, so both sort orders stay ascending, plus
    the permutation into (item, user) order."""
    nnz = u.size
    p = max(pad_multiple, -(-max(nnz, 1) // pad_multiple) * pad_multiple)
    u = np.concatenate([u.astype(np.int32),
                        np.full(p - nnz, max(n - 1, 0), np.int32)])
    i = np.concatenate([i.astype(np.int32),
                        np.full(p - nnz, max(m - 1, 0), np.int32)])
    y = np.concatenate([y.astype(np.float32), np.zeros(p - nnz, np.float32)])
    with span("layout.sort"):
        item_order = np.lexsort((u, i)).astype(np.int32)
    return dict(u_ids=upload(u, device), i_ids=upload(i, device),
                y=upload(y, device), item_order=upload(item_order, device),
                i_ids_sorted=upload(i[item_order], device),
                u_ids_by_item=upload(u[item_order], device))
