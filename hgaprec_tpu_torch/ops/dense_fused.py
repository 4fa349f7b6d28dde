"""Fused dense CAVI sweep: the CUDA kernel's wrapper and its plain version.

Port of `hgaprec_tpu/ops/dense_pallas.py::fused_dense_sweep`. For linear
factors A = exp(Elog theta) [N, K], B = exp(Elog beta) [M, K] and the
uint8 count matrix Y, with W = Y / max(A B^T, 1e-30):

    raw_a = W B,  raw_b = W^T A     [, rowsum W, colsum W with bias]

The caller multiplies by A and B (and the bias expectations) to get the
CAVI sufficient statistics (ops/sweep.py).

Hand-written kernels replace the TPU kernel
`hgaprec_tpu/ops/dense_pallas.py::_kernel`, chosen by precision and by
the packed width kq (K, plus 2 with bias, zero-padded):

  * bf16 ("default"): `dense_wgmma_kernel` of `csrc/dense_wgmma.cu`
    (wgmma products on TMA-fed tiles), every width up to 256;
  * f32 ("highest", the default precision of `ModelConfig` and the CLI)
    up to kq = 128 (K <= 128, K <= 126 with bias; K = 100 runs at 112):
    `dense_split_kernel` of `csrc/dense_wgmma.cu`, f32-accurate products
    from three bf16 pieces of each factor on the same wgmma pipeline
    (`split_pieces` writes the piece tables);
  * the wide routes, rows padded to whole k-blocks of 64 values:
    `dense_res_kernel` of `csrc/dense_wgmma.cu` ("wide": bf16 rows of
    257-384 packed values, kq = 320 or 384; "wide_f32": f32 rows of
    129-320, kq = 192, 256 or 320, from the three pieces) keeps a CTA's
    64 stationary rows resident in shared memory, stages each moving
    tile once into a ring of k-block slots and forms S once per tile,
    split in half by k-steps between its two warpgroups, which split the
    output columns in half the other way; past those widths, below
    UNFUSED_FROM (1024) packed values, `dense_cluster_kernel` ("cluster":
    bf16 rows of 385-960, "cluster_f32": f32 rows of 321-960; it is built
    for rows up to 3072 and 2560), the same design on a thread-block
    cluster of c CTAs, each holding 1/c of the row's k-blocks and owning
    their output columns, the S partials summed through distributed
    shared memory; from 1024 values the unfused route of
    `csrc/dense_unfused.cu` ("unfused", "unfused_f32"): per
    slab of users (`unfused_plan`) `dense_w_kernel` forms S and W into
    an HBM slab of W (W's three bf16 pieces on the f32 route), then
    `dense_contract_kernel` forms W B and adds W^T A, three GEMM-shaped
    wgmma passes that issue the function's own 6 N M kq products;
  * `dense_wide_kernel` of `csrc/dense_wgmma.cu` ("wide_stream",
    "wide_stream_f32"; column windows of 256 bf16 or 128 f32, S formed
    per window with both operands' k-blocks streamed by TMA, any width)
    is on no route: `chip_smoke.py` times the unfused route beside it at
    ML-1M shape.
  * `csrc/dense_simt.cu` (register-tiled FP32 FMAs fed by a cp.async
    ring, any Y row stride) computes the f32 function up to kq = 256 and
    no route takes it: it is the yardstick `chip_smoke.py` times the f32
    routes against.

The choice is by width between hand-written kernels, not a fallback: a
launch that fails raises. A sweep costs 8 N M kq FLOPs (four products of
2 N M kq: both of the narrow kernels' two deterministic roles recompute
S; the resident and cluster wide kernels form S once a role as well),
6 N M kq on the unfused route (S once, W through HBM), six bf16 products
each on the f32 routes, against two uint8 reads of Y,
so it is compute-bound on the H100. The two-role design trades the
fourth product for sums without atomics and no item-count limit. The two narrow wgmma
kernels are also built once per stage of the stage probe
(`ops/dense_probe.py`), whose prod stage is the production kernel itself.

On a CUDA tensor `fused_dense_sweep` launches a kernel or raises; only
a CPU tensor takes `fused_dense_sweep_reference`, the same function in
blocked torch ops.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hgaprec_tpu_torch.ops import build

KP_MAX = 256           # widest packed row of the narrow kernels
SPLIT_KQ_MAX = 128     # widest packed row of the f32 route's wgmma kernel
# the packed widths of the resident wide kernel's instantiations; wider
# rows take the streamed wide kernel
RES_WIDTHS = {"wide": (320, 384), "wide_f32": (192, 256, 320)}
# the cluster kernel's shares: the fewest and the most k-blocks of 64
# values one CTA of a cluster holds (its instantiations), and the most
# CTAs a cluster has; wider rows take the streamed wide kernel
CLUSTER_SHARES = {"cluster": (4, 6), "cluster_f32": (3, 5)}
CLUSTER_MAX = 8
# the unfused route's budget for W's slab in bytes (its pieces included):
# the slabs are as many users as fit, whole multiples of 128
UNFUSED_W_BYTES = 2 << 30
# the packed width (rows padded to k-blocks of 64) from which both
# precisions take the unfused route in place of the cluster kernel: it
# measured faster there at ML-1M K = 1000 and 2000 and Netflix K = 1000
# (PERF.md, section 6)
UNFUSED_FROM = 1024
UNFUSED_KERNELS = ("unfused", "unfused_f32")
_BF16_KERNELS = ("wgmma", "wide", "cluster", "wide_stream", "unfused")
_PIECE_KERNELS = ("f32", "wide_f32", "cluster_f32", "wide_stream_f32",
                  "unfused_f32")


class _Kernel(NamedTuple):
    entry: str         # the library's C entry point
    probe: Optional[str]   # the entry of its stage probe's instantiations
    probe_kq: int      # the packed width the probe's stages are built for
    tile: int          # stationary rows per CTA, the unit splits_for plans in
    per_sm: int        # CTAs resident on one SM
    min_chunk: int     # fewest tiles of moving rows one CTA sweeps when split
    window: int = 0    # output columns per CTA (the streamed wide kernels)
    moving: int = 64   # moving rows per tile (the wide kernels)


KERNELS = {
    # bf16: dense_wgmma_kernel (one 384-thread CTA per SM); its stages are
    # built at kq = 112 only
    "wgmma": _Kernel("hpf_dense_wgmma_bf16", "hpf_dense_wgmma_probe_bf16",
                     112, 128, 1, 8),
    # f32 up to kq = 128: dense_split_kernel (one 256-thread CTA per SM);
    # its stages are built at kq = 112 only
    "f32": _Kernel("hpf_dense_split_f32", "hpf_dense_split_probe_f32", 112,
                   128, 1, 8),
    # f32 up to kq = 256: csrc/dense_simt.cu (one 256-thread CTA per SM),
    # the f32 routes' yardstick; no stages
    "simt": _Kernel("hpf_dense_simt_f32", None, 0, 128, 1, 8),
    # the resident wide kernel, dense_res_kernel (one 256-thread CTA per
    # SM, 64 stationary rows): bf16 at kq = 320, 384 (64 moving rows a
    # tile), f32 at kq = 192, 256, 320 (the pieces, 32 moving rows); no
    # stages
    "wide": _Kernel("hpf_dense_res_bf16", None, 0, 64, 1, 8, 0, 64),
    "wide_f32": _Kernel("hpf_dense_res_f32", None, 0, 64, 1, 8, 0, 32),
    # past them the cluster kernel, dense_cluster_kernel (clusters of c
    # 256-thread CTAs, one CTA per SM, on 64 stationary rows): bf16 (64
    # moving rows a tile) and f32 (the pieces, 32); no stages
    "cluster": _Kernel("hpf_dense_cluster_bf16", None, 0, 64, 1, 8, 0, 64),
    "cluster_f32": _Kernel("hpf_dense_cluster_f32", None, 0, 64, 1, 8, 0,
                           32),
    # past those widths the streamed wide kernel, dense_wide_kernel (one
    # 256-thread CTA per SM and column window), bf16 and f32 (the pieces)
    "wide_stream": _Kernel("hpf_dense_wide_bf16", None, 0, 128, 1, 8, 256),
    "wide_stream_f32": _Kernel("hpf_dense_wide_f32", None, 0, 128, 1, 8,
                               128),
    # from UNFUSED_FROM packed values the unfused route (csrc/
    # dense_unfused.cu): per slab of users dense_w_kernel and the two
    # dense_contract_kernel passes, tiles of 192 rows (three consumer
    # warpgroups) by 256 columns (bf16) or 128 by 128 (f32); no stages
    "unfused": _Kernel("hpf_dense_unfused_bf16", None, 0, 192, 1, 8),
    "unfused_f32": _Kernel("hpf_dense_unfused_f32", None, 0, 128, 1, 8),
}
_CLAMP = 1e-30
# (a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq, ldy, split_a, split_b
# [, stage], stream)
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
# the unfused entries: (a, b, y, acc_a, acc_b, w, n, m, kq, ldy,
# slab_rows, ldw, stream)
_UNFUSED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES = {
    **{k.entry: _ARGS + [ctypes.c_void_p] for k in KERNELS.values()},
    **{KERNELS[k].entry: _UNFUSED_ARGS for k in UNFUSED_KERNELS},
    **{k.probe: _ARGS + [ctypes.c_int, ctypes.c_void_p]
       for k in KERNELS.values() if k.probe},
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


def split_pieces(x: torch.Tensor) -> torch.Tensor:
    """The three bf16 pieces of f32 `x`, [3, *x.shape]: x1 = bf16(x),
    x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), rounded to nearest, each
    difference exact in f32, so that x1 + x2 + x3 is within 2^-27 |x| of
    x for normal values. The f32 route's kernel multiplies pieces."""
    out = torch.empty((3,) + tuple(x.shape), dtype=torch.bfloat16,
                      device=x.device)
    rest = x
    for p in range(3):
        out[p] = rest
        if p < 2:
            rest = rest - out[p].float()
    return out


def _unpack(acc_a, acc_b, k: int, bias: bool):
    if bias:
        return acc_a[:, :k], acc_b[:, :k], acc_a[:, k], acc_b[:, k + 1]
    return acc_a[:, :k], acc_b[:, :k]


def packed_width(kaug: int, kernel: str) -> int:
    """The zero-padded width kq of the packed rows `kernel` takes for
    `kaug` values (K, plus 2 with bias). The wgmma kernels stage rows as
    128-byte-swizzled k-blocks of 64 values (TMA zero-fills the rest of a
    last partial block): bf16 ("wgmma") is built for kq = 64, 112, 128 and
    256, f32 ("f32") for 64, 112 and 128 (K = 100 takes 112, with or
    without bias), the resident wide kernel for RES_WIDTHS ("wide" 320
    and 384, "wide_f32" 192, 256 and 320), the cluster kernel
    (`cluster_shape`) c equal shares of whole k-blocks, and the streamed
    wide kernels ("wide_stream", "wide_stream_f32") and the unfused route
    ("unfused", "unfused_f32") any whole number of k-blocks. "simt"
    copies rows in 16-byte chunks (multiples of 4 values; the kernel
    loops over this true width) up to 256. A kernel
    refuses a wider row with a ValueError that names the kernel its route
    takes there."""
    if kernel in ("wide_stream", "wide_stream_f32") + UNFUSED_KERNELS:
        return -(-kaug // 64) * 64
    if kernel in CLUSTER_SHARES:
        c, kb = cluster_shape(kaug, kernel)
        return 64 * c * kb
    widths = {"wgmma": (64, 112, 128, KP_MAX),
              "f32": (64, 112, SPLIT_KQ_MAX), **RES_WIDTHS}.get(kernel)
    if widths is None:
        kq = -(-kaug // 4) * 4
        widest = KP_MAX
    else:
        kq = next((w for w in widths if kaug <= w), kaug)
        widest = widths[-1]
    if kq > widest:
        _too_wide(kq, widest, kaug, kernel)
    return kq


def _too_wide(kq: int, widest: int, kaug: int, kernel: str):
    """Refuse a row of kq values wider than `kernel`'s widest, naming the
    kernel its route takes."""
    raise ValueError(f"packed factor width {kq} > {widest} for the "
                     f"{kernel} kernel (its route takes the "
                     f"{dense_kernel(kaug, kernel in _BF16_KERNELS)} "
                     f"kernel there)")


def cluster_shape(kaug: int, kernel: str) -> Tuple[int, int]:
    """(c, kb): the cluster of the cluster kernel ("cluster",
    "cluster_f32") for `kaug` values: c = max(2, ceil(kq0 / (64 most)))
    CTAs (kq0: kaug padded to whole k-blocks of 64 values, `most` the
    widest share of CLUSTER_SHARES: 320 f32, 384 bf16 values) of
    kb = ceil(kq0 / (64 c)) k-blocks each, at least its fewest; the
    packed width is 64 c kb (csrc/dense_wgmma.cu, cluster_shape, takes
    the cluster back from it). Raises ValueError past CLUSTER_MAX CTAs."""
    fewest, most = CLUSTER_SHARES[kernel]
    blocks = -(-kaug // 64)
    c = max(2, -(-blocks // most))
    if c > CLUSTER_MAX:
        _too_wide(64 * blocks, 64 * most * CLUSTER_MAX, kaug, kernel)
    return c, max(fewest, -(-blocks // c))


def cluster_size(kq: int, kernel: str) -> int:
    """CTAs a cluster of `kernel` has at packed width kq: c of
    `cluster_shape` for the cluster kernel, 1 for the others."""
    return cluster_shape(kq, kernel)[0] if kernel in CLUSTER_SHARES else 1


def dense_kernel(kaug: int, bf16: bool) -> str:
    """The kernel (a key of KERNELS) a sweep takes for `kaug` values:
    bf16 "wgmma" up to 256 packed values, the resident wide kernel
    ("wide") up to 384, the cluster kernel ("cluster") up to 960 and the
    unfused route ("unfused") from UNFUSED_FROM (1024 once padded to
    whole k-blocks); f32 `f32_kernel`'s."""
    if not bf16:
        return f32_kernel(kaug)
    if kaug <= KP_MAX:
        return "wgmma"
    return _wide_kernel(kaug, "wide", "cluster", "unfused")


def f32_kernel(kaug: int) -> str:
    """The f32 route's kernel (a key of KERNELS) for `kaug` values: the
    split-product wgmma kernel ("f32") up to kq = 128, the resident wide
    kernel's f32 route ("wide_f32") up to 320, the cluster kernel's
    ("cluster_f32") up to 960, the unfused route ("unfused_f32") from
    UNFUSED_FROM. dense_simt.cu ("simt") and the streamed kernel
    ("wide_stream_f32") are on no route."""
    if kaug <= SPLIT_KQ_MAX:
        return "f32"
    return _wide_kernel(kaug, "wide_f32", "cluster_f32", "unfused_f32")


def _wide_kernel(kaug: int, res: str, cluster: str, unfused: str) -> str:
    if kaug <= RES_WIDTHS[res][-1]:
        return res
    if -(-kaug // 64) * 64 < UNFUSED_FROM:
        return cluster
    return unfused


def windows(kq: int, kernel: str) -> int:
    """Column windows of a launch of `kernel` on rows of kq values: one
    for the narrow and the resident wide kernels (dense_simt.cu's own
    windows are launches of its own), ceil(kq / window) for the streamed
    ones."""
    w = KERNELS[kernel].window
    return -(-kq // w) if w else 1


def wide_plan(n: int, m: int, kaug: int, kernel: str) -> Dict[str, float]:
    """What a launch of a wide kernel ("wide", "wide_f32", "cluster",
    "cluster_f32", "wide_stream", "wide_stream_f32", "unfused",
    "unfused_f32") on an N x M sweep of `kaug` values issues and stages,
    from its plan: kq; CTAs a cluster; windows; S formations per
    (stationary, moving) pair; `issued`, the FLOPs of its tensor-core
    products (both roles; x 6 bf16 products on the f32 routes); `staged`,
    the bytes its TMA loads bring into shared memory (every CTA's
    stationary rows and every moving tile and Y tile it sweeps: the
    streamed kernel restages the stationary k-blocks per moving tile and
    the moving tile per window, the resident one stages each once, the
    cluster kernel each factor once and Y once per CTA of a cluster; the
    unfused route its three passes' k-blocks, `unfused_plan`)."""
    kq = packed_width(kaug, kernel)
    if kernel in UNFUSED_KERNELS:
        plan = unfused_plan(n, m, kq, kernel)
        return dict(kq=kq, cluster=1, windows=1, s_forms=1,
                    issued=plan["issued"],
                    staged=sum(plan["staged"].values()))
    spec = KERNELS[kernel]
    nwin = windows(kq, kernel)
    c = cluster_size(kq, kernel)
    pieces = 3 if kernel.endswith("f32") else 1
    x, z = spec.tile, spec.moving
    staged = 0
    for nx, nz in ((n, m), (m, n)):          # user role, item role
        tiles_x, tiles_z = -(-nx // x), -(-nz // z)
        pairs = tiles_x * tiles_z
        if nwin == 1:
            staged += (tiles_x * pieces * x * kq * 2
                       + pairs * (pieces * z * kq * 2 + c * x * z))
        else:
            s_items = (kq // 64) * pieces * (x + z) * 128
            c_items = sum(pieces * min(spec.window, kq - w * spec.window)
                          * z * 2 + x * z for w in range(nwin))
            staged += pairs * (nwin * s_items + c_items)
    forms = 1 if nwin == 1 else nwin
    issued = 4 * n * m * kq * (forms + 1) * (6 if pieces == 3 else 1)
    return dict(kq=kq, cluster=c, windows=nwin, s_forms=forms,
                issued=issued, staged=staged)


def unfused_plan(n: int, m: int, kq: int, kernel: str,
                 slab_rows: Optional[int] = None) -> Dict:
    """The unfused route's slabs and what they move, for an N x M sweep of
    packed width kq (whole k-blocks of 64) by `kernel` ("unfused",
    "unfused_f32"): `slab_rows`, the users a slab holds (a whole multiple
    of 128: as many as W's slab fits in UNFUSED_W_BYTES, its pieces
    included, unless `slab_rows` is given, as the tests and chip_smoke.py
    do to force several slabs; never more than N rounded up to 128);
    `slabs`, their row ranges [u0, u1) in order, covering the users;
    `ldw`, W's row stride (M padded to 8 values); `issued`, the FLOPs of
    the tensor-core products (6 N M kq, x 6 bf16 products on the f32
    route: the function's own); `w_written` and `w_read`, W's bytes to
    HBM and back (written once, read by both contractions); `staged`, the
    bytes each pass's TMA loads bring into shared memory (every CTA's
    k-blocks of both operands, all pieces, zero-filled edges included)."""
    pieces = 3 if kernel == "unfused_f32" else 1
    rows, cols = KERNELS[kernel].tile, 256 if pieces == 1 else 128
    ldw = -(-m // 8) * 8
    if slab_rows is None:
        slab_rows = max(1, UNFUSED_W_BYTES // (pieces * ldw * 2 * 128)) * 128
    if slab_rows <= 0 or slab_rows % 128:
        raise ValueError(f"slab_rows={slab_rows} is not a whole multiple of "
                         f"128 rows")
    slab_rows = min(slab_rows, max(128, -(-n // 128) * 128))
    slabs = [(u0, min(u0 + slab_rows, n)) for u0 in range(0, n, slab_rows)]
    stage = pieces * (rows + cols) * 128       # one k-block of both operands
    staged = dict(w=0, contract_a=0, contract_b=0)
    for u0, u1 in slabs:
        tiles = -(-(u1 - u0) // rows)
        staged["w"] += tiles * -(-m // cols) * (kq // 64) * stage
        staged["contract_a"] += tiles * -(-kq // cols) * -(-m // 64) * stage
        staged["contract_b"] += (-(-m // rows) * -(-kq // cols) *
                                 -(-(u1 - u0) // 64) * stage)
    w_written = pieces * n * m * 2
    return dict(kq=kq, slab_rows=slab_rows, slabs=slabs, ldw=ldw,
                issued=6 * n * m * kq * (6 if pieces == 3 else 1),
                w_written=w_written, w_read=2 * w_written, staged=staged)


def check_tma_layout(dense_y: torch.Tensor) -> None:
    """The wgmma kernels (every route's kernel) load Y with TMA,
    which needs a row stride and a base that are multiples of 16 bytes
    (the Trainer's layouts are: data/device.py, dense_count_matrix).
    Raises ValueError otherwise; there is no byte-load fallback."""
    if dense_y.stride(0) % 16 or dense_y.data_ptr() % 16:
        raise ValueError(
            f"the wgmma kernels load Y with TMA: its row stride "
            f"({dense_y.stride(0)} bytes) and base must be multiples of 16 "
            f"bytes (build Y with data.device.dense_count_matrix)")


def splits_for(n: int, m: int, sms: int, kernel: str,
               nwin: int = 1, kq: int = 0) -> Tuple[int, int]:
    """(split_a, split_b): chunks per user-role and item-role CTA loop.

    One CTA per stationary tile leaves most of the card idle when N and M
    are small (ML-1M, wgmma: 48 + 29 CTAs for 132 SMs), so each role's
    moving loop is cut into chunks of at least `min_chunk` tiles, aiming
    at about four CTAs per resident slot. At Netflix shape the chunks are
    thousands of tiles long and the item role splits in two; at the
    EchoNest head (4096 items) the item role splits in nine. The streamed
    wide kernels run `nwin` column windows of each, which count toward
    the four. The cluster kernel at packed width `kq` runs c CTAs per
    role block (cluster_size), so the card holds sms // c clusters at
    once: its splits fill that many slots with whole clusters. The
    resident and cluster wide kernels, whose CTAs are few and long at
    small shapes, take the split that `_resident_splits` finds fills the
    card's last wave best."""
    spec = KERNELS[kernel]
    tiles_a, tiles_b = -(-n // spec.tile), -(-m // spec.tile)
    slots = spec.per_sm * sms // cluster_size(kq, kernel)
    chunk = max(spec.min_chunk,
                -(-2 * tiles_a * tiles_b * nwin // (4 * slots)))
    split = (-(-tiles_b // chunk), -(-tiles_a // chunk))
    if (kernel in RES_WIDTHS or kernel in CLUSTER_SHARES) and \
            tiles_a * split[0] + tiles_b * split[1] <= 16 * slots:
        return _resident_splits(n, m, slots, spec.tile, spec.moving,
                                spec.min_chunk * spec.tile)
    return split


def _makespan(costs, slots: int) -> float:
    """When the last of CTAs of these costs ends, each started in order
    on the first of `slots` resident slots to come free (how the card
    hands out blocks when one fits per SM)."""
    free = [0.0] * slots
    for c in costs:
        heapq.heapreplace(free, free[0] + c)
    return max(free)


@functools.lru_cache(maxsize=None)
def _resident_splits(n: int, m: int, slots: int, tile: int, moving: int,
                     min_rows: int) -> Tuple[int, int]:
    """(split_a, split_b) for the resident wide kernel: of the splits that
    give both roles' chunks one length (in moving tiles of `moving` rows,
    at least `min_rows` rows, as csrc/dense_roles.cuh cuts them), the one
    whose CTAs end soonest in order on `slots` slots (item role first),
    each costing its moving tiles plus two for its stationary tile's load;
    fewer CTAs on a tie."""
    tiles_a, tiles_b = -(-n // tile), -(-m // tile)
    za, zb = -(-n // moving), -(-m // moving)

    def costs(tiles_x, z, split):
        ln = -(-z // split)
        return [2 + max(0, min(z, (s + 1) * ln) - s * ln)
                for _ in range(tiles_x) for s in range(split)]
    best = None
    for split_a in range(1, zb + 1):
        ln = -(-zb // split_a)
        if split_a > 1 and ln * moving < min_rows:
            break
        split_b = -(-za // max(ln, -(-min_rows // moving)))
        ctas = tiles_a * split_a + tiles_b * split_b
        if split_a > 1 and ctas > 16 * slots:
            break
        key = (_makespan(costs(tiles_b, za, split_b) +
                         costs(tiles_a, zb, split_a), slots), ctas)
        if best is None or key < best[0]:
            best = (key, (split_a, split_b))
    return best[1]


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
    contraction products, accumulating in f32. On a CUDA tensor every
    route's kernel needs Y's row stride and base at multiples of 16 bytes
    (`check_tma_layout`). Returns 2 or 4 f32 tensors.
    """
    _check(a_lin, b_lin, dense_y, ba_lin, bb_lin)
    if dense_y.device.type == "cpu":
        return fused_dense_sweep_reference(a_lin, b_lin, dense_y, ba_lin,
                                           bb_lin, bf16=bf16)
    if dense_y.device.type != "cuda":
        raise ValueError(f"no kernel for device {dense_y.device}")
    kaug = a_lin.shape[1] + (2 if ba_lin is not None else 0)
    kernel = dense_kernel(kaug, bf16)
    acc_a, acc_b = launch_dense(a_lin, b_lin, dense_y, ba_lin, bb_lin,
                                kernel=kernel)
    if a_lin.shape[0] and b_lin.shape[0]:     # an empty side launches nothing
        fused_dense_sweep.launches += 1
        fused_dense_sweep.launches_by_kernel[kernel] += 1
    return _unpack(acc_a, acc_b, a_lin.shape[1], ba_lin is not None)


def launch_dense(a_lin, b_lin, dense_y, ba_lin=None, bb_lin=None, *,
                 kernel: str, stage: Optional[int] = None,
                 slab_rows: Optional[int] = None):
    """Pack the factors, launch `kernel` (a key of KERNELS) on the card and
    return the raw packed outputs (f32 [N, kq], [M, kq]). An int `stage`
    (ops/dense_probe.py's STAGES) runs that kernel built for that stage of
    the stage probe, on rows packed to the probe's width (112, for both
    wgmma kernels; "simt" has no stages). `slab_rows` (the unfused route
    only) sets the users of a slab (`unfused_plan`). Inputs are checked
    by the caller; the wgmma kernels' Y layout is checked here."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    spec = KERNELS[kernel]
    kq = packed_width(k + 2 if ba_lin is not None else k, kernel)
    if stage is not None:
        if spec.probe is None:
            raise ValueError(f"the {kernel} kernel has no probe stages")
        if kq > spec.probe_kq:
            raise ValueError(f"the {kernel} probe's stages take packed rows "
                             f"of at most {spec.probe_kq} values, not {kq}")
        kq = spec.probe_kq          # its stages are built for this width
    if kernel != "simt":
        check_tma_layout(dense_y)
    a, b = _pack(a_lin, b_lin, ba_lin, bb_lin, kq,
                 torch.bfloat16 if kernel in _BF16_KERNELS
                 else torch.float32)
    if kernel in _PIECE_KERNELS:
        a, b = split_pieces(a), split_pieces(b)
    acc_a = torch.empty((n, kq), dtype=torch.float32, device=a.device)
    acc_b = torch.empty((m, kq), dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return acc_a.zero_(), acc_b.zero_()
    if kernel in UNFUSED_KERNELS:
        _launch_unfused(a, b, dense_y, acc_a, acc_b, kernel, slab_rows)
        return acc_a, acc_b
    split_a, split_b = splits_for(
        n, m, torch.cuda.get_device_properties(a.device).multi_processor_count,
        kernel, windows(kq, kernel), kq)
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


def _launch_unfused(a, b, dense_y, acc_a, acc_b, kernel, slab_rows):
    """The unfused route on the packed tables a, b ([3, rows, kq] pieces
    on the f32 route): one C call runs every slab of `unfused_plan` in
    order on the current stream, W's slab scratch from the caching
    allocator (a captured graph keeps it in its pool). Raises
    RuntimeError naming the kernel, the shape and the slab on a failed
    launch."""
    n, m, kq = acc_a.shape[0], acc_b.shape[0], acc_a.shape[1]
    plan = unfused_plan(n, m, kq, kernel, slab_rows)
    w = torch.empty((3 if kernel == "unfused_f32" else 1, plan["slab_rows"],
                     plan["ldw"]), dtype=torch.bfloat16, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _entry(KERNELS[kernel].entry)(
            a.data_ptr(), b.data_ptr(), dense_y.data_ptr(), acc_a.data_ptr(),
            acc_b.data_ptr(), w.data_ptr(), n, m, kq, dense_y.stride(0),
            plan["slab_rows"], plan["ldw"], stream)
    if err != 0:
        raise RuntimeError(
            f"dense sweep launch failed: cudaError {err} (kernel={kernel}: "
            f"dense_w_kernel, dense_contract_kernel; n={n}, m={m}, kq={kq}, "
            f"slab of {plan['slab_rows']} rows, {len(plan['slabs'])} slabs)")


fused_dense_sweep.launches = 0
fused_dense_sweep.launches_by_kernel = {kernel: 0 for kernel in KERNELS}


# each wgmma kernel's production instantiations in the machine code: the
# pattern and what its number times gives the packed width (the resident
# wide kernel's k-blocks x 64; the cluster kernel's: the width of one CTA's
# share; the streamed ones': the window width); the unfused route's (unit
# 0) are keyed by pass: 0 dense_w_kernel, 1 and 2 dense_contract_kernel's
# roles 0 (W B) and 1 (W^T A)
_PRODUCTION = {"wgmma": (r"dense_wgmma_kernelILi(\d+)ELi0EE", 1),
               "f32": (r"dense_split_kernelILi(\d+)ELi0EE", 1),
               "wide": (r"dense_res_kernelILi1ELi(\d+)ELi64EE", 64),
               "wide_f32": (r"dense_res_kernelILi3ELi(\d+)ELi32EE", 64),
               "cluster": (r"dense_cluster_kernelILi1ELi(\d+)ELi64EE", 64),
               "cluster_f32": (r"dense_cluster_kernelILi3ELi(\d+)ELi32EE",
                               64),
               "wide_stream": (r"dense_wide_kernelILi1ELi(\d+)EE", 1),
               "wide_stream_f32": (r"dense_wide_kernelILi3ELi(\d+)EE", 1),
               "unfused": (r"dense_w_kernelILi1ELi3EE|"
                           r"dense_contract_kernelILi1ELi3ELi([01])EE", 0),
               "unfused_f32": (r"dense_w_kernelILi3ELi2EE|"
                               r"dense_contract_kernelILi3ELi2ELi([01])EE",
                               0)}


def hgmma_counts() -> Dict[str, Dict[int, int]]:
    """{kernel: {kq: count}}: warpgroup tensor-core instructions (HGMMA)
    in the machine code of each wgmma kernel ("wgmma" bf16, "f32" split,
    the resident "wide" and "wide_f32", the cluster kernel's "cluster"
    and "cluster_f32", the streamed "wide_stream" and "wide_stream_f32",
    the unfused route's "unfused" and "unfused_f32"), by production
    instantiation (packed width kq; a CTA's share for the cluster kernel,
    the window width for the streamed ones, the pass for the unfused
    route; the stage probe's other stages are not counted): a width whose
    count is zero had its products folded away."""
    counts: Dict[str, Dict[int, int]] = {k: {} for k in _PRODUCTION}
    cur = None
    for line in build.sass().splitlines():
        if "Function :" in line:
            cur = None
            for kernel, (pattern, unit) in _PRODUCTION.items():
                hit = re.search(pattern, line)
                if hit:
                    cur = counts[kernel]
                    kq = (int(hit.group(1)) * unit if unit else
                          0 if hit.group(1) is None else 1 + int(hit.group(1)))
                    cur[kq] = 0
        elif cur is not None and "HGMMA" in line:
            cur[kq] += 1
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
