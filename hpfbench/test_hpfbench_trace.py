"""The reading of a traced window, on the CPU with fake traces: kernel
names, busy time and idle gaps, the layers' readers, the check that
every launched kernel of the program's CUDA sources belongs to a kernel
layer, and the check of the multi-step's counters."""

import pytest

from hpfbench import manifest, program, run, trace

BENCH = manifest.load()
DENSE = ("void (anonymous namespace)::dense_split_kernel<112, 0>"
         "(CUtensorMap_st, float*, int)")
SPARSE = ("void (anonymous namespace)::segment_pass_kernel<16, 2, true, "
          "(anonymous namespace)::Ring<4, 4, true> >(int const*, long long)")
GLUE = "digamma_vectorized4_kernel"


def _trace(device):
    return trace.Trace(device=device, host=[("hpfbench.replay_chunk", 0.0,
                                             100.0)], start=0.0, end=100.0)


def test_kernel_names():
    assert trace.kernel_name(DENSE) == "dense_split_kernel"
    assert trace.kernel_name(SPARSE) == "segment_pass_kernel"
    assert trace.kernel_name(GLUE) == GLUE
    assert trace.kernel_of(DENSE, {"dense_split_kernel"})


def test_busy_and_idle():
    tr = _trace([(DENSE, 10.0, 30.0), (GLUE, 20.0, 40.0),
                 (SPARSE, 70.0, 80.0)])
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.window_s == pytest.approx(100e-6)
    gaps = tr.idle_gaps(2)
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6])
    assert gaps[0][0] == "host: hpfbench.replay_chunk"
    assert tr.launched({"dense_split_kernel", "other"}) == \
        {"dense_split_kernel"}


def _ctx(tr):
    return {"trace": tr, "iterations": 2, "k": 100, "precision": "highest",
            "nnz": 1000, "n": 100, "m": 50, "csrc_dir": program.csrc_dir(),
            "info": {"dense_rows": 100, "dense_cols": 10, "dense_nnz": 600,
                     "sparse_nnz": 400}, "layout_s": 1.5}


def test_layer_readers_split_the_kernels():
    tr = _trace([(DENSE, 0.0, 10.0), (SPARSE, 10.0, 30.0),
                 (GLUE, 30.0, 70.0)])
    ctx = _ctx(tr)
    read = {name: manifest.module("metrics", name).read for name in
            ("dense_roofline", "sparse_roofline", "glue_ms")}
    assert read["glue_ms"](ctx) == pytest.approx(40e-6 * 1e3 / 2)
    dense = manifest.module("metrics", "dense_roofline")
    assert read["dense_roofline"](ctx) == pytest.approx(
        100 * dense.bound_s(ctx) / 5e-6)
    sparse = manifest.module("metrics", "sparse_roofline")
    assert read["sparse_roofline"](ctx) == pytest.approx(
        100 * sparse.bound_s(ctx) / 10e-6)
    # a trace with none of the layer's kernels, or a route that hands the
    # layer no nonzero, reads nothing (never a share of 0)
    assert read["sparse_roofline"](_ctx(_trace([(DENSE, 0.0, 1.0)]))) \
        is None
    assert read["dense_roofline"](_ctx(_trace([(GLUE, 0.0, 1.0)]))) is None
    ctx["info"] = {**ctx["info"], "sparse_nnz": 0}
    assert read["sparse_roofline"](ctx) is None


def test_every_kernel_of_the_program_is_claimed():
    defined = trace.defined_kernels(trace.sources(program.csrc_dir(),
                                                  trace.PROGRAM_SOURCES))
    assert {"dense_split_kernel", "segment_pass_kernel",
            "tail_bf16_kernel"} <= defined
    tr = _trace([(f"void {name}<1>(int)", 0.0, 1.0) for name in defined])
    assert run.unclaimed_kernels(tr, program.csrc_dir(), BENCH) == []


def test_a_kernel_no_layer_claims_is_found(tmp_path):
    (tmp_path / "dense_new.cu").write_text(
        "__global__ void dense_new_kernel(float* x) {}\n")
    (tmp_path / "head_gather.cu").write_text(
        "__global__ void __launch_bounds__(256) gather_kernel(int n) {}\n")
    tr = _trace([("void dense_new_kernel(float*)", 0.0, 1.0),
                 ("void (anonymous namespace)::gather_kernel<2>(int)", 1.0,
                  2.0), (GLUE, 2.0, 3.0)])
    assert run.unclaimed_kernels(tr, str(tmp_path), BENCH) == \
        ["gather_kernel"]


@pytest.mark.parametrize("got, replayed, cuda, ok", [
    ({"eager_steps": 1, "captures": 1, "replays": 9}, True, True, True),
    ({"eager_steps": 1, "captures": 2, "replays": 8}, True, True, False),
    ({"eager_steps": 2, "captures": 1, "replays": 8}, True, True, False),
    ({"eager_steps": 0, "captures": 0, "replays": 0}, False, True, False),
    ({"eager_steps": 0, "captures": 0, "replays": 0}, False, False, True),
    ({"eager_steps": 1, "captures": 1, "replays": 9}, False, False, False),
])
def test_check_counts(got, replayed, cuda, ok):
    if ok:
        run.check_counts(got, 10, replayed, cuda)
    else:
        with pytest.raises(run.Failed):
            run.check_counts(got, 10, replayed, cuda)
