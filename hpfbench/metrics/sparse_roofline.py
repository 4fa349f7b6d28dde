"""sparse_roofline (%): the sparse kernels' share of their roofline.

The bound of the sweep over the sparse stream (the hybrid's tail, or
every nonzero on the CSR route), counters.py, over the device seconds per
iteration of the kernels that the sparse sources define: one layer for
the f32 tail and the CSR sweep, which run the same passes. None where the
cell's route hands them no nonzero or the trace shows none of them.
"""

from hpfbench import counters, trace

# the sources whose kernels this layer claims (run.py checks that every
# launched kernel of the program's sources is claimed by some layer)
KERNEL_SOURCES = ("segment_sweep.cu", "tail_bf16.cu", "row_sweep.cuh")


def bound_s(ctx: dict) -> float:
    nnz = ctx["info"]["sparse_nnz"]
    return counters.bound_s(
        counters.sparse_bytes(nnz, ctx["n"], ctx["m"], ctx["k"],
                              ctx["precision"]),
        counters.sweep_flops(nnz, ctx["k"]))


def read(ctx: dict):
    if ctx["info"]["sparse_nnz"] == 0:
        return None
    kernels = trace.defined_kernels(trace.sources(ctx["csrc_dir"],
                                                  KERNEL_SOURCES))
    seconds = ctx["trace"].seconds_of(kernels) / ctx["iterations"]
    return 100.0 * bound_s(ctx) / seconds if seconds > 0 else None
