"""The CSR segment sweep: its layout and the plain version of its kernel.

Counterpart of `docs/design/pallas_csr_sweep.py::sweep_pallas`, the
single-pass sweep whose correctness baseline is the segment path
(`hgaprec_tpu/ops/sweep.py::sweep_segment`). One sweep is two passes over
every nonzero of the dual-sorted COO, with bias-augmented f32 tables
A = [A | ba | 1] and B = [B | 1 | bb] (ops/tail.py::tail_tables):

  * the user pass, over the user-sorted stream (u_ids, i_ids, y), finds
    w_j = y_j / max(<A[u_j], B[i_j]>, 1e-30), keeps w, and gives
    acc_a = A (.) segsum_u(w B[i]), acc_ba in column K;
  * the item pass reads w in item order (w[item_order]) and gives
    acc_b = B (.) segsum_i(w A[u]), acc_bb in column K+1.

The layout is `DeviceData`'s own (data/device.py): the user-sorted COO,
`item_order`, `i_ids_sorted` and `u_ids_by_item`. The kernel cuts each
sorted stream into fixed ranges of nonzeros, so it needs no row pointers;
padding entries (y = 0, ids = last row) get w = 0 and add nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hgaprec_tpu_torch.data.device import DeviceData

_CLAMP = 1e-30


def segment_sweep_reference(a_tab: torch.Tensor, b_tab: torch.Tensor,
                            data: DeviceData, block: int = 1 << 20
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out_a f32 [n, kq], out_b f32 [m, kq]): the kernel's function in
    plain torch ops, both passes. a_tab [n, kq], b_tab [m, kq] are the
    augmented tables (any float dtype, read as f32). Products and w are
    f32 as in the kernel; the row sums run in f64 and are rounded to f32
    once. An f32 `index_add_` would not do as a reference: on the card
    its atomics add a popular item's ~10^6 terms one by one onto a large
    partial sum, which drifted by 2e-4 relative from an f64 sum at
    EchoNest shape while the kernel's fixed-order f32 sums stayed within
    2e-6. Blocks of nonzeros bound the [block, kq] temporaries."""
    a_tab, b_tab = a_tab.float(), b_tab.float()
    p = data.u_ids.shape[0]
    w = torch.empty(p, dtype=torch.float32, device=a_tab.device)
    out_a = torch.zeros(a_tab.shape, dtype=torch.float64, device=a_tab.device)
    out_b = torch.zeros(b_tab.shape, dtype=torch.float64, device=a_tab.device)
    for j0 in range(0, p, block):                    # user pass
        u = data.u_ids[j0:j0 + block].long()
        prod = a_tab[u] * b_tab[data.i_ids[j0:j0 + block].long()]
        wj = data.y[j0:j0 + block] / torch.clamp_min(prod.sum(1), _CLAMP)
        w[j0:j0 + block] = wj
        out_a.index_add_(0, u, (wj[:, None] * prod).double())
    for j0 in range(0, p, block):                    # item pass
        i = data.i_ids_sorted[j0:j0 + block].long()
        prod = b_tab[i] * a_tab[data.u_ids_by_item[j0:j0 + block].long()]
        wj = w[data.item_order[j0:j0 + block].long()]
        out_b.index_add_(0, i, (wj[:, None] * prod).double())
    return out_a.float(), out_b.float()
