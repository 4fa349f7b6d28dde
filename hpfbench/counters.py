"""Operations, bytes and peaks: the yardstick of the roofline metrics.

Every count is worked out from the configuration's shapes and the
nonzeros handed to a layer, so it reads the same work whatever route or
kernel implements it. A CAVI sweep over nnz nonzeros at K factors makes
three products of 2 nnz K operations (the denominators A B^T, then W B
and W^T A). Its least bytes read each input once, as the layout hands it,
and write each output once:

  * dense block (the whole Y, or the hybrid's head of T items): the uint8
    Y block, rows x cols bytes, the two factor tables and the two outputs;
  * sparse stream (the hybrid's tail, or every nonzero on the CSR route):
    ids and count, 12 bytes a nonzero, the two tables and the two outputs.

Factor tables are read at the configuration's precision ("highest": 4
bytes, "default": bf16, 2 bytes); outputs are float32.

One peak serves both precisions: 989 TFLOP/s, the H100 SXM's dense bf16
tensor-core rate. The f32-accurate route issues its products on the bf16
tensor cores, so any lower figure is a property of one route, which a
better route could beat past 100%. HBM: 3.35 TB/s. Both are NVIDIA's
published figures for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def sweep_flops(nnz: int, k: int) -> float:
    return 6.0 * nnz * k


def table_bytes(precision: str) -> int:
    return 4 if precision == "highest" else 2


def dense_bytes(rows: int, cols: int, k: int, precision: str) -> float:
    return float(rows * cols +
                 (table_bytes(precision) + 4) * k * (rows + cols))


def sparse_bytes(nnz: int, n: int, m: int, k: int, precision: str) -> float:
    return float(12 * nnz + (table_bytes(precision) + 4) * k * (n + m))


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS)
