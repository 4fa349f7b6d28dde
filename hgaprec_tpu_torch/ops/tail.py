"""The big-sparse tail: its layout and the plain version of its sweep.

Counterpart of `hgaprec_tpu/ops/mxu_tail.py`. The hybrid sweep
(ops/sweep.py::sweep_hybrid) runs the dense kernel over the head block of
top-degree items; the remaining nonzeros, the tail, run through two
half-sweeps, one per sort order:

  * the user-sorted half, with primary table P = [A | ba | 1] and other
    table O = [B | 1 | bb], gives acc_a (and acc_ba in column K);
  * the item-sorted half, with P = [B | 1 | bb] and O = [A | ba | 1],
    gives acc_b (and acc_bb in column K+1).

Per nonzero j of a half, with r = p_j: s_j = <P[r], O[o_j]>, w_j =
y_j / max(s_j, 1e-30) and out[r] += w_j * P[r] (.) O[o_j]. The augmented
columns make s_j = A.B + ba + bb (the reference's K+2 phi slots,
hgaprec.cc:223-239) and deliver the bias statistics with no extra pass.
Both halves meet every nonzero with the same w_j, so the f32 kernel route
(ops/tail_fused.py) forms it once, in the user-sorted half, and the
item-sorted half reads it back through `TailStream.order`.

The JAX package compacts ids and cuts the stream into windows because
the TPU cannot gather across tiles; the port keeps raw ids and
full-size tables, and its output lands in full index space.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hgaprec_tpu_torch.trace import span

_CLAMP = 1e-30


@dataclasses.dataclass(frozen=True)
class TailStream:
    """The tail nonzeros with raw ids, in both sort orders."""
    u: torch.Tensor            # i32[PT] user ids, sorted (user, item)
    i: torch.Tensor            # i32[PT] item ids
    y: torch.Tensor            # f32[PT] counts
    i_by_item: torch.Tensor    # i32[PT] item ids, sorted (item, user)
    u_by_item: torch.Tensor    # i32[PT] user ids
    y_by_item: torch.Tensor    # f32[PT]
    # the user-sorted position of each item-sorted entry: u[order] ==
    # u_by_item, and so on
    order: torch.Tensor        # i32[PT]
    # the f32 route's item-pass streams, built from the fields above at
    # first use and kept here, by their sizing
    # (ops/segment_fused.py::slab_stream)
    slab_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def nnz(self) -> int:
        return self.u.shape[0]


def build_tail_stream(u: np.ndarray, i: np.ndarray, y: np.ndarray,
                      device) -> TailStream:
    """Both sort orders of a user-sorted COO stream, built on the host
    and moved to `device`. The item order is a stable sort by item, so
    users stay ascending within an item (the order of the JAX package's
    item-sorted compact stream, mxu_tail.py:164)."""
    u = np.ascontiguousarray(u, np.int32)
    i = np.ascontiguousarray(i, np.int32)
    y = np.ascontiguousarray(y, np.float32)
    with span("layout.sort"):
        order = np.argsort(i, kind="stable")
    return TailStream(u=upload(u, device), i=upload(i, device),
                      y=upload(y, device), i_by_item=upload(i[order], device),
                      u_by_item=upload(u[order], device),
                      y_by_item=upload(y[order], device),
                      order=upload(order.astype(np.int32), device))


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`, the copy spanned as `layout.copy`."""
    x = np.ascontiguousarray(x)
    with span("layout.copy"):
        return torch.from_numpy(x).to(device)


def augment(x: torch.Tensor, col_a: Optional[torch.Tensor],
            col_b: Optional[torch.Tensor], width: int,
            dtype=torch.float32) -> torch.Tensor:
    """[R, K] -> [R, width]: [x | col_a | col_b | 0 ...] (mxu_tail.py:
    214-224). Callers pass [A | ba | 1] and [B | 1 | bb]; without bias
    the row is [x | 0 ...]."""
    r, k = x.shape
    out = torch.zeros((r, width), dtype=dtype, device=x.device)
    out[:, :k] = x
    if col_a is not None:
        out[:, k] = col_a
        out[:, k + 1] = col_b
    return out


def half_sweep_reference(p_tab: torch.Tensor, o_tab: torch.Tensor,
                         p_ids: torch.Tensor, o_ids: torch.Tensor,
                         y: torch.Tensor, rows: int,
                         block: int = 1 << 20) -> torch.Tensor:
    """f32 [rows, width]: out[r] = sum over j with p_ids[j] == r of
    w_j * P[r] (.) O[o_ids[j]], w_j = y_j / max(<P[r], O[o_ids[j]]>, 1e-30).

    Tables of any float dtype are read as f32 (a bf16 table is rounded
    where the kernel rounds it: once, before the sweep). Blocks of
    nonzeros bound the [block, width] temporaries."""
    out = torch.zeros((rows, p_tab.shape[1]), dtype=torch.float32,
                      device=p_tab.device)
    for j0 in range(0, p_ids.shape[0], block):
        pj = p_ids[j0:j0 + block].long()
        prod = p_tab[pj].float() * o_tab[o_ids[j0:j0 + block].long()].float()
        w = y[j0:j0 + block] / torch.clamp_min(prod.sum(1), _CLAMP)
        out.index_add_(0, pj, w[:, None] * prod)
    return out


Halves = Callable[[torch.Tensor, torch.Tensor, TailStream],
                  Tuple[torch.Tensor, torch.Tensor]]


def halves_reference(a_t: torch.Tensor, b_t: torch.Tensor,
                     stream: TailStream) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc_a, acc_b): both half-sweeps in plain torch ops on the augmented
    tables a_t = [A | ba | 1], b_t = [B | 1 | bb]: the user-sorted one with
    a_t primary, the item-sorted one with b_t primary."""
    return (half_sweep_reference(a_t, b_t, stream.u, stream.i, stream.y,
                                 a_t.shape[0]),
            half_sweep_reference(b_t, a_t, stream.i_by_item,
                                 stream.u_by_item, stream.y_by_item,
                                 b_t.shape[0]))


def tail_tables(a_lin, b_lin, ba_lin, bb_lin, bf16: bool):
    """The bias-augmented factor tables [A | ba | 1], [B | 1 | bb] in bf16
    ("default") or f32 ("highest"), their rows zero-padded to whole
    16-byte chunks (the kernel loads a row in 16-byte pieces)."""
    k = a_lin.shape[1]
    bias = ba_lin is not None
    quantum = 8 if bf16 else 4
    width = -(-(k + 2 if bias else k) // quantum) * quantum
    dt = torch.bfloat16 if bf16 else torch.float32
    ones_a = torch.ones_like(ba_lin) if bias else None
    ones_b = torch.ones_like(bb_lin) if bias else None
    return (augment(a_lin, ba_lin, ones_a, width, dt),
            augment(b_lin, ones_b, bb_lin, width, dt))


def run_tail_sweep(halves: Halves, a_lin, b_lin, ba_lin, bb_lin,
                   stream: TailStream, bf16: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Both halves of a tail sweep through `halves` (the plain version or
    the kernels' wrapper) on the augmented tables. Returns (acc_a [N, K],
    acc_b [M, K], acc_ba [N] | None, acc_bb [M] | None), the finished
    y * phi sums: the contract of `mxu_tail_sweep` (mxu_tail.py:287-340).
    An empty stream returns zeros and runs nothing."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    bias = ba_lin is not None
    if stream.nnz == 0:
        z = a_lin.new_zeros
        return (z((n, k)), z((m, k)), z((n,)) if bias else None,
                z((m,)) if bias else None)
    acc_a, acc_b = halves(*tail_tables(a_lin, b_lin, ba_lin, bb_lin, bf16),
                          stream)
    if bias:
        return acc_a[:, :k], acc_b[:, :k], acc_a[:, k], acc_b[:, k + 1]
    return acc_a[:, :k], acc_b[:, :k], None, None


def tail_sweep_reference(a_lin, b_lin, ba_lin, bb_lin, stream: TailStream,
                         bf16: bool = False):
    """The tail sweep in plain torch ops (same contract as the kernel's
    `ops/tail_fused.py::tail_sweep`)."""
    return run_tail_sweep(halves_reference, a_lin, b_lin, ba_lin, bb_lin,
                          stream, bf16)
