"""CSR segment sweep: the CUDA kernel's wrapper.

Port of `docs/design/pallas_csr_sweep.py::sweep_pallas` (TPU kernel
`_sweep_pass_kernel`). One call runs both passes of a segment sweep over
`DeviceData`'s dual-sorted COO (ops/segment.py): the user pass finds and
keeps the weights w_j = y_j / max(<A[u], B[i]>, 1e-30) and sums acc_a; the
item pass reads w through each entry's user-sorted position and sums
acc_b. Tables are f32 always, as in the JAX segment path.

The kernel (`csrc/segment_sweep.cu`) is bounded by the random row gathers,
one opposite-side row per nonzero in each pass (kq * 4 bytes). The TPU
kernel keeps the whole opposite-side table on chip; on the H100 only a
slab of the user table fits in the 50 MB L2. So the item pass runs over
its own stream (`slab_stream`): the users cut into contiguous slabs whose
A rows and weights fit in SLAB_BYTES, the stream in (slab, item, user)
order, each (slab, item) pair summed into a row of a pair buffer, and each
item's pair rows added in slab order. Both passes cut their stream into
ranges of RANGE nonzeros, one lane group each, with a cp.async ring of
rows in flight; runs cut by a range meet in a fixed-order fix-up, so no
float atomics and the same bits on every launch.

The same two passes are the f32 route of the hybrid's tail
(ops/tail_fused.py::tail_halves): `user_pass` and `item_pass` run there on
the tail's dual-sorted stream and its own slab stream.

On a CUDA tensor `fused_segment_sweep` launches the kernel or raises; only
a CPU tensor takes `ops/segment.py::segment_sweep_reference`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops.segment import segment_sweep_reference
from hgaprec_tpu_torch.ops.tail import tail_tables
from hgaprec_tpu_torch.trace import note, span

RANGE = 128            # nonzeros per range (a multiple of 32)
SLAB_BYTES = 24 << 20  # a slab's A rows and weights: half the H100's L2
# values of a row a lane of a wide pass holds (eight 16-byte chunks of f32,
# four of bf16): wider rows are cut into column windows
WIDE_CAP = 32
# the widest row one window takes (csrc/row_sweep.cuh's kOneWindowMax): a
# wider row's dot sweep finds its weights first, into scratch of nnz floats
ONE_WINDOW_MAX = 32 * WIDE_CAP
# groups of 16 lanes an SM holds (csrc/row_sweep.cuh's kFillGroupsPerSm): a
# dot pass over fewer ranges than the card holds such groups takes 32 lanes
FILL_GROUPS_PER_SM = 32

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "hpf_segment_user_pass_f32": [_VP] * 9 + [_LL] + [_INT] * 4 + [_VP],
    "hpf_segment_item_pass_f32": [_VP] * 12 + [_LL] + [_INT] * 4 + [_VP],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A C entry of the kernel library, its argument types set once."""
    fn = getattr(build.load_library(), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass(frozen=True)
class SlabStream:
    """The item pass's stream: a dual-sorted COO's item-sorted order stably
    re-sorted by the slab of each entry's user, so in (slab, item, user)
    order, with each entry's (slab, item) pair numbered in that order.
    With a `fill` (slab_stream), the entries of items too sparse to pay
    for their pair rows come first, in (item, user) order, one pair per
    item; the slabs follow."""
    pair: torch.Tensor            # i32[P] the entry's pair: 0, 0, 1, ...
    u: torch.Tensor               # i32[P] user ids
    order: torch.Tensor           # i32[P] positions in the user-sorted COO
    pair_item: torch.Tensor       # i32[pairs] the item of each pair
    # item i's pairs, in slab order: item_pairs[item_start[i]:item_start[i+1]]
    item_start: torch.Tensor      # i32[m + 1]
    item_pairs: torch.Tensor      # i32[pairs]
    slabs: int                    # slabs holding an entry in slab order
    cold: int = 0                 # entries in the leading (item, user) part

    @property
    def pairs(self) -> int:
        return self.pair_item.shape[0]


def user_slabs(u_ids: torch.Tensor, n: int, kq: int,
               slab_bytes: int) -> torch.Tensor:
    """i64 [n]: the slab of each user. Users are cut in id order into
    contiguous slabs of a budget of `slab_bytes`, each user costing its A
    row (kq * 4 bytes) and its weights (4 bytes per entry of u_ids, which
    lie together in the user-sorted stream): a slab takes the users whose
    running cost starts inside its budget, so it holds at most slab_bytes
    plus one user. Slab ids rise with the user id and may skip a number
    where one user costs more than the budget."""
    cost = 4 * torch.bincount(u_ids.long(), minlength=n) + 4 * kq
    return (torch.cumsum(cost, 0) - cost) // slab_bytes


def _run_starts(slab: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
    """bool [P]: where a run of equal (slab, item) starts."""
    start = torch.ones_like(slab, dtype=torch.bool)
    start[1:] = (slab[1:] != slab[:-1]) | (item[1:] != item[:-1])
    return start


def slab_stream(u_ids: torch.Tensor, item_order: torch.Tensor,
                i_by_item: torch.Tensor, u_by_item: torch.Tensor,
                cache: dict, n: int, m: int, kq: int,
                slab_bytes: int = SLAB_BYTES, fill: int = 0) -> SlabStream:
    """The item pass's stream of a dual-sorted COO (the user-sorted user
    ids, the user-sorted position of each item-sorted entry, and the
    item-sorted item and user ids: `DeviceData`'s COO or a `TailStream`)
    for tables of n user and m item rows of kq floats, built on the
    stream's device once per (n, m, kq, slab_bytes, fill) and kept in the
    stream's `cache`. The item order is sorted by (item, user), so a
    stable sort by slab gives (slab, item, user).

    An item whose entries span p slabs costs p pair rows, each written
    and read once, where plain item order costs one; slab order saves it
    an HBM gather of A per entry. With fill > 0 an item keeps slab order
    only where its entries outnumber fill times its p - 1 extra pair rows;
    the others lead the stream in (item, user) order, one pair each. A
    build is spanned as `slabs.build` and noted (trace.py): its slabs as
    `slabs.count`, the item pass's pair buffer as `slabs.pair_rows` and
    `slabs.pair_bytes` (a row of kq f32 a pair, as `item_pass` allocates
    it); a cache hit notes nothing."""
    key = (n, m, kq, slab_bytes, fill)
    got = cache.get(key)
    if got is None:
        with span("slabs.build"):
            got = cache[key] = _build_slab_stream(
                u_ids, item_order, i_by_item, u_by_item, n, m, kq,
                slab_bytes, fill)
            note("slabs.count", got.slabs)
            note("slabs.pair_rows", got.pairs)
            note("slabs.pair_bytes", got.pairs * kq * 4)
    return got


def _build_slab_stream(u_ids, item_order, i_by_item, u_by_item, n, m, kq,
                       slab_bytes, fill) -> SlabStream:
    """`slab_stream`'s stream, built on the device."""
    slab = user_slabs(u_ids, n, kq, slab_bytes)[u_by_item.long()]
    cold = 0
    if fill > 0:
        # users ascend within an item, slabs with them: (item, slab) runs
        # are contiguous in item order
        starts = _run_starts(slab, i_by_item)
        spans = torch.bincount(i_by_item[starts].long(), minlength=m)
        keep = torch.bincount(i_by_item.long(), minlength=m) > \
            fill * (spans - 1)
        hot = keep[i_by_item.long()]
        slab = torch.where(hot, slab + 1, 0)
        cold = int((~hot).sum())
    slab, perm = torch.sort(slab, stable=True)
    i = i_by_item[perm]
    run_start = _run_starts(slab, i)
    pair_item = i[run_start]
    item_start = torch.zeros(m + 1, dtype=torch.int64, device=slab.device)
    item_start[1:] = torch.cumsum(torch.bincount(pair_item.long(),
                                                 minlength=m), 0)
    return SlabStream(
        pair=(torch.cumsum(run_start, 0) - 1).int(),
        u=u_by_item[perm], order=item_order[perm],
        pair_item=pair_item, item_start=item_start.int(),
        item_pairs=torch.sort(pair_item, stable=True).indices.int(),
        slabs=int(torch.unique_consecutive(slab[cold:]).numel()), cold=cold)


def data_slabs(data: DeviceData, n: int, m: int, kq: int,
               slab_bytes: int = SLAB_BYTES) -> SlabStream:
    """`slab_stream` of `DeviceData`'s COO, kept in `data.slab_cache`."""
    return slab_stream(data.u_ids, data.item_order, data.i_ids_sorted,
                       data.u_ids_by_item, data.slab_cache, n, m, kq,
                       slab_bytes)


class Plan(NamedTuple):
    """A pass's shape on the card: groups of `lanes` lanes, `chunks`
    16-byte chunks a lane, cover one column window of a row; a row has
    `windows` of them, each a group of its own; with `weights` the pass's
    weights are found over the whole row by a kernel of their own first."""
    lanes: int
    chunks: int
    windows: int = 1
    weights: bool = False


def pass_plan(kq: int, bf16: bool = False, dot: bool = True,
              ranges: Optional[int] = None, sms: int = 0) -> Plan:
    """The shape the kernels give a pass over rows of kq values (a whole
    number of 16-byte chunks), as `csrc/segment_sweep.cu::pass_by_width`,
    `csrc/tail_bf16.cu` and `csrc/row_sweep.cuh::wide_plan` pick it. Up
    to 256 values, f32 rows two chunks a lane of 4, 8, 16 or 32 lanes and
    bf16 rows one chunk a lane of 8, 16 or 32 (the fewest that cover the
    row). Past 256, the fewest column windows that keep a lane within
    WIDE_CAP values, then in each the group of 16 or 32 lanes whose
    ceil(chunks / lanes) chunks a lane leave the fewest idle (16 only where
    it leaves fewer), so less than one chunk a lane is idle. `dot`: the
    pass finds its weights (the user pass, the tail), which then come
    first where a row takes more than one window. Given the stream's
    `ranges` and the card's `sms`, a dot pass whose ranges do not fill
    the card's 16-lane groups takes 32 lanes (`row_sweep.cuh::fill_plan`):
    a range's own time then decides, and it is shorter at 32 lanes."""
    per = 8 if bf16 else 4
    if kq <= 256:
        lanes = next(g for g in (4, 8, 16, 32) if 2 * per * g >= kq) \
            if not bf16 else next(g for g in (8, 16, 32) if per * g >= kq)
        return Plan(lanes, 1 if bf16 else 2)
    chunks, cap = kq // per, WIDE_CAP // per
    windows = -(-chunks // (32 * cap))
    each = -(-chunks // windows)
    c16, c32 = -(-each // 16), -(-each // 32)
    lanes, k = (16, c16) if c16 <= cap and 16 * c16 < 32 * c32 else \
        (32, c32)
    if lanes == 16 and windows == 1 and dot and ranges is not None and \
            ranges < sms * FILL_GROUPS_PER_SM:
        lanes, k = 32, c32
    return Plan(lanes, k, windows, dot and kq > ONE_WINDOW_MAX)


def _check(a_tab, b_tab, data: DeviceData, slab_bytes: int):
    if a_tab.dim() != 2 or b_tab.dim() != 2 or \
            a_tab.shape[1] != b_tab.shape[1]:
        raise ValueError(f"tables {tuple(a_tab.shape)}, {tuple(b_tab.shape)}"
                         " must be [n, kq] and [m, kq]")
    if a_tab.dtype != torch.float32 or b_tab.dtype != torch.float32:
        raise ValueError(f"tables must be float32, got {a_tab.dtype}, "
                         f"{b_tab.dtype}")
    kq = a_tab.shape[1]
    if kq % 4:
        raise ValueError(f"table width {kq} is not a multiple of 4 "
                         f"(16-byte rows)")
    if slab_bytes <= 0:
        raise ValueError(f"slab budget {slab_bytes} must be positive")
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


@dataclasses.dataclass(frozen=True)
class Scratch:
    """The kernel's working buffers for a stream of p > 0 entries: the
    weights and two boundary slots per range of RANGE."""
    w: torch.Tensor               # f32[p]
    brow: torch.Tensor            # i32[slots]
    bacc: torch.Tensor            # f32[slots, kq]

    @staticmethod
    def make(p: int, kq: int, device) -> "Scratch":
        slots = 2 * -(-p // RANGE)
        return Scratch(torch.empty(p, dtype=torch.float32, device=device),
                       torch.empty(slots, dtype=torch.int32, device=device),
                       torch.empty((slots, kq), dtype=torch.float32,
                                   device=device))


def user_pass(p_tab, o_tab, p_ids, o_ids, y, out, sc: Scratch,
              tail: bool = False) -> None:
    """The user pass on the card over a stream sorted by its primary ids
    p_ids (ascending), with other-side ids o_ids and counts y: w into sc.w
    and out[r] = P[r] (.) sum_{p_j = r} w_j O[o_j] into out. Rows no entry
    touches are left as they were, or with tail=True zeroed by the kernel
    (which then takes the kernel's ring shape for the hybrid's tail).
    `fused_segment_sweep` runs it on `DeviceData`'s user-sorted COO, the
    tail's f32 route on either half's stream."""
    kq, nnz = p_tab.shape[1], p_ids.shape[0]
    with torch.cuda.device(p_tab.device):
        stream = torch.cuda.current_stream(p_tab.device).cuda_stream
        err = _entry("hpf_segment_user_pass_f32")(
            p_ids.data_ptr(), o_ids.data_ptr(), y.data_ptr(),
            p_tab.data_ptr(), o_tab.data_ptr(), out.data_ptr(),
            sc.w.data_ptr(), sc.brow.data_ptr(), sc.bacc.data_ptr(), nnz,
            kq, RANGE, out.shape[0] if tail else 0, int(tail), stream)
    if err != 0:
        raise RuntimeError(f"segment sweep user pass failed: cudaError "
                           f"{err} (nnz={nnz}, kq={kq})")


def item_pass(a_tab, b_tab, slabs: SlabStream, out_b, sc: Scratch,
              tail: bool = False) -> None:
    """The item pass on the card, after the user pass filled sc.w: every
    row of out_b written (zero for an item with no entry). tail=True takes
    the kernel's ring shape for the hybrid's tail."""
    kq = a_tab.shape[1]
    m = b_tab.shape[0]
    pacc = torch.empty((slabs.pairs, kq), dtype=torch.float32,
                       device=a_tab.device)
    with torch.cuda.device(a_tab.device):
        stream = torch.cuda.current_stream(a_tab.device).cuda_stream
        err = _entry("hpf_segment_item_pass_f32")(
            slabs.pair.data_ptr(), slabs.u.data_ptr(), slabs.order.data_ptr(),
            sc.w.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(),
            pacc.data_ptr(), slabs.item_start.data_ptr(),
            slabs.item_pairs.data_ptr(), out_b.data_ptr(), sc.brow.data_ptr(),
            sc.bacc.data_ptr(), slabs.pair.shape[0], m, kq, RANGE, int(tail),
            stream)
    if err != 0:
        raise RuntimeError(f"segment sweep item pass failed: cudaError "
                           f"{err} ({slabs.slabs} slabs, {slabs.pairs} "
                           f"pairs, nnz={slabs.pair.shape[0]}, kq={kq})")


def fused_segment_sweep(a_tab: torch.Tensor, b_tab: torch.Tensor,
                        data: DeviceData, slab_bytes: int = SLAB_BYTES):
    """(out_a f32 [n, kq], out_b f32 [m, kq]): one segment sweep over
    `data`'s COO with the augmented f32 tables a_tab [n, kq], b_tab
    [m, kq] (kq a multiple of 4); ids in range and sorted as
    `build_device_data` lays them out. Untouched rows are zero.
    `slab_bytes` sizes the item pass's user slabs (`slab_stream`)."""
    _check(a_tab, b_tab, data, slab_bytes)
    if a_tab.device.type == "cpu":
        return segment_sweep_reference(a_tab, b_tab, data)
    if a_tab.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_tab.device}")
    (n, kq), m = a_tab.shape, b_tab.shape[0]
    p = data.u_ids.shape[0]
    out_a = torch.zeros((n, kq), dtype=torch.float32, device=a_tab.device)
    out_b = torch.empty((m, kq), dtype=torch.float32, device=a_tab.device)
    if p == 0:
        return out_a, out_b.zero_()
    slabs = data_slabs(data, n, m, kq, slab_bytes)
    sc = Scratch.make(p, kq, a_tab.device)
    user_pass(a_tab, b_tab, data.u_ids, data.i_ids, data.y, out_a, sc)
    item_pass(a_tab, b_tab, slabs, out_b, sc)
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
