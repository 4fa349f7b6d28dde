"""glue_ms (ms): device milliseconds per iteration of every operation
that is not a kernel of the program's CUDA sources: the step glue's
PyTorch kernels (exp, digamma, sums, the Gamma updates, the hybrid's
scatter-add, the dense route's packing), copies and fills."""

from hpfbench import trace


def read(ctx: dict):
    kernels = trace.defined_kernels(
        trace.sources(ctx["csrc_dir"], trace.PROGRAM_SOURCES))
    seconds = ctx["trace"].seconds_of(kernels, inside=False)
    return 1e3 * seconds / ctx["iterations"]
