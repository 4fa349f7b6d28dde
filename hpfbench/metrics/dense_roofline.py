"""dense_roofline (%): the dense kernel's share of its roofline.

The bound of the sweep over the dense block (the whole Y on the dense
route, the head on the hybrid), counters.py, over the device seconds per
iteration of the kernels that the dense sources define. None where the
cell's route has no dense block or the trace shows none of its kernels.
"""

from hpfbench import counters, trace

# the sources whose kernels this layer claims (run.py checks that every
# launched kernel of the program's sources is claimed by some layer)
KERNEL_SOURCES = ("dense_*.cu", "dense_*.cuh")


def bound_s(ctx: dict) -> float:
    info = ctx["info"]
    return counters.bound_s(
        counters.dense_bytes(info["dense_rows"], info["dense_cols"],
                             ctx["k"], ctx["precision"]),
        counters.sweep_flops(info["dense_nnz"], ctx["k"]))


def read(ctx: dict):
    if ctx["info"]["dense_nnz"] == 0:
        return None
    kernels = trace.defined_kernels(trace.sources(ctx["csrc_dir"],
                                                  KERNEL_SOURCES))
    seconds = ctx["trace"].seconds_of(kernels) / ctx["iterations"]
    return 100.0 * bound_s(ctx) / seconds if seconds > 0 else None
