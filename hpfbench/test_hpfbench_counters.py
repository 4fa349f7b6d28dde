"""The op and byte counters against the figures worked out from the
shapes (EchoNest head T = 4096 over 1,019,318 users, its f32 tail, its
CSR sweep of 48,373,586 nonzeros; Netflix's whole Y, the dense route's
count)."""

import pytest

from hpfbench import counters, manifest

K = 100
EN_N, EN_M, EN_NNZ = 1_019_318, 384_546, 48_373_586
# the tail of the head T = 4096 at seed 3200000000 (on the card)
EN_TAIL = 9_642_613
NF_N, NF_M, NF_NNZ = 480_189, 17_770, 100_480_507


def test_peaks():
    assert counters.PEAK_FLOPS == 989e12
    assert counters.HBM_BYTES_PER_S == 3.35e12
    assert counters.table_bytes("highest") == 4
    assert counters.table_bytes("default") == 2


@pytest.mark.parametrize("what, nbytes, gb, ms", [
    ("netflix dense", counters.dense_bytes(NF_N, NF_M, K, "highest"),
     8.93, 2.67),
    ("echonest head", counters.dense_bytes(EN_N, 4096, K, "highest"),
     4.99, 1.49),
    ("echonest f32 tail", counters.sparse_bytes(EN_TAIL, EN_N, EN_M, K,
                                                "highest"), 1.24, 0.37),
    ("echonest csr sweep", counters.sparse_bytes(EN_NNZ, EN_N, EN_M, K,
                                                 "highest"), 1.70, 0.51),
])
def test_bounds_are_memory_bound(what, nbytes, gb, ms):
    assert nbytes / 1e9 == pytest.approx(gb, abs=0.006), what
    flops = counters.sweep_flops(NF_NNZ, K)
    bound = counters.bound_s(nbytes, flops)
    assert bound == nbytes / counters.HBM_BYTES_PER_S
    assert bound * 1e3 == pytest.approx(ms, abs=0.006), what


def test_operations():
    assert counters.sweep_flops(NF_NNZ, K) == 6 * NF_NNZ * K
    # a compute-bound count: operations over the peak
    assert counters.bound_s(1.0, 989e12) == pytest.approx(1.0)


def _ctx(info, n, m):
    return {"info": info, "n": n, "m": m, "k": K, "precision": "highest"}


def test_metric_bounds_read_the_layout():
    dense = manifest.module("metrics", "dense_roofline")
    sparse = manifest.module("metrics", "sparse_roofline")
    hybrid = {"dense_rows": EN_N, "dense_cols": 4096,
              "dense_nnz": EN_NNZ - EN_TAIL, "sparse_nnz": EN_TAIL}
    assert dense.bound_s(_ctx(hybrid, EN_N, EN_M)) * 1e3 == \
        pytest.approx(1.49, abs=0.006)
    assert sparse.bound_s(_ctx(hybrid, EN_N, EN_M)) * 1e3 == \
        pytest.approx(0.37, abs=0.006)
    whole = {"dense_rows": NF_N, "dense_cols": NF_M, "dense_nnz": NF_NNZ,
             "sparse_nnz": 0}
    assert dense.bound_s(_ctx(whole, NF_N, NF_M)) * 1e3 == \
        pytest.approx(2.67, abs=0.006)
    assert sparse.read(_ctx(whole, NF_N, NF_M)) is None
