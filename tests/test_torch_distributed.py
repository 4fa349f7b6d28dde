"""parallel/distributed.py and per-rank ingest against the JAX package's.

Single process here: initialize_from_env is a no-op without a launch,
is_primary / local_device_slice / host_user_rows give the JAX package's
row partition, and load_dataset(user_rows=...) keeps the same rows and
global id maps as hgaprec_tpu/data/ratings.py (tests/test_distributed.py
is the model). An explicit file:// world of one shows the init path.
"""

import numpy as np
import pytest
import torch.distributed as dist

from hgaprec_tpu.data.ratings import load_dataset as j_load
from hgaprec_tpu.data.synthetic import write_pf_dataset
from hgaprec_tpu.parallel import distributed as jdist
from hgaprec_tpu_torch.data.ratings import load_dataset as t_load
from hgaprec_tpu_torch.parallel import distributed


def test_single_process_is_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_from_env("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize_from_env("cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("n,ndev", [(100, None), (53, 8), (41, 3),
                                    (6040, 2)])
def test_primary_and_rows_equal_jax(n, ndev):
    assert distributed.is_primary() == jdist.is_primary()
    assert distributed.rank() == 0
    assert distributed.local_device_slice(n) == jdist.local_device_slice(n)
    assert distributed.host_user_rows(n, ndev) == \
        jdist.host_user_rows(n, ndev or 1)


def test_world_of_one_from_explicit_arguments(tmp_path):
    """A file:// rendezvous in place of the environment; gloo on the CPU."""
    assert distributed.initialize_from_env(
        "cpu", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
        rank=0)
    try:
        assert dist.get_backend() == "gloo"
        assert distributed.is_primary() and distributed.rank() == 0
        assert distributed.host_user_rows(41) == slice(0, 41)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pf")
    write_pf_dataset(str(d), np.random.default_rng(4), 400, 200, k=6,
                     scale=6.0)
    return str(d)


def _same_store(t, j):
    assert t.n == j.n and t.m == j.m
    assert t.user2seq == j.user2seq and t.movie2seq == j.movie2seq
    assert t.local_user_rows == j.local_user_rows
    for f in ("coo_u", "coo_i", "coo_y", "row_ptr"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)


@pytest.mark.parametrize("rows", ["none", "slice", "callable"])
def test_user_rows_ingest_equals_jax(pf_dir, rows):
    """The vectorized ingest (> 10k rows) sliced by a seq-id range or by
    a callable of the actual n: the same COO and global maps as the JAX
    package's load_dataset."""
    full, _, _ = t_load(pf_dir, 400, 200, False, 1)
    assert full.nratings > 10000
    n = full.n
    user_rows = {"none": None, "slice": slice(0, n // 2),
                 "callable": lambda actual: slice(actual // 2, actual)}[rows]
    t, tv, tt = t_load(pf_dir, 400, 200, False, 1, user_rows=user_rows)
    j, jv, jt = j_load(pf_dir, 400, 200, False, 1, user_rows=user_rows)
    _same_store(t, j)
    assert tv == jv and tt == jt
    if user_rows is not None:
        rng = t.local_user_rows
        assert 0 < t.nratings < full.nratings
        sel = (full.coo_u >= rng.start) & (full.coo_u < rng.stop)
        np.testing.assert_array_equal(t.coo_u, full.coo_u[sel])


def test_user_rows_ingest_scalar_path(tmp_path):
    """Below 10k rows the per-row ingest runs, then the same slice."""
    write_pf_dataset(str(tmp_path), np.random.default_rng(5), 40, 30, k=3,
                     scale=2.0)
    t, _, _ = t_load(str(tmp_path), 40, 30, False, 1,
                     user_rows=slice(10, 25))
    j, _, _ = j_load(str(tmp_path), 40, 30, False, 1,
                     user_rows=slice(10, 25))
    assert t.nratings < 10000
    _same_store(t, j)
