"""Port data layer == JAX data layer on the same inputs (exact equality)."""

import numpy as np
import pytest
import torch

from hgaprec_tpu.data.device import build_device_data as j_build
from hgaprec_tpu.data.ratings import RatingsStore as JStore
from hgaprec_tpu.data.ratings import leave_one_out_map as j_loo
from hgaprec_tpu.data.ratings import load_dataset as j_load
from hgaprec_tpu.data.ratings import validation_users_of_movie as j_vum
from hgaprec_tpu.data.synthetic import write_pf_dataset as j_write
from hgaprec_tpu_torch.data.device import build_device_data as t_build
from hgaprec_tpu_torch.data.ratings import RatingsStore as TStore
from hgaprec_tpu_torch.data.ratings import leave_one_out_map as t_loo
from hgaprec_tpu_torch.data.ratings import load_dataset as t_load
from hgaprec_tpu_torch.data.ratings import validation_users_of_movie as t_vum
from hgaprec_tpu_torch.data.synthetic import write_pf_dataset as t_write


def _assert_stores_equal(js, ts):
    for f in ("coo_u", "coo_i", "coo_y", "row_ptr"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), f)
    for f in ("user2seq", "seq2user", "movie2seq", "seq2movie"):
        assert getattr(ts, f) == getattr(js, f), f


def _assert_device_equal(jd, td):
    for f in ("u_ids", "i_ids", "y", "item_order", "i_ids_sorted",
              "u_ids_by_item", "dense_y"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), f)


@pytest.mark.parametrize("n,m,density,binary", [
    (40, 30, 0.3, False),
    (53, 17, 0.5, True),
    (4200, 12, 0.5, False),     # N > 4096: dense_y rows padded to 512
])
def test_store_and_device_data_equal(n, m, density, binary):
    rng = np.random.default_rng(n)
    u, i = np.nonzero(rng.random((n, m)) < density)
    y = rng.integers(1, 6, size=u.size)
    stores = []
    for cls in (JStore, TStore):
        s = cls(n, m, binary=binary, rating_threshold=3)
        s.add_training(u * 7 + 1, i * 3 + 2, y)    # non-contiguous ext ids
        s.finalize()
        stores.append(s)
    js, ts = stores
    _assert_stores_equal(js, ts)
    jd = j_build(js, pad_multiple=64)
    td = t_build(ts, "cpu", pad_multiple=64)
    _assert_device_equal(jd, td)
    assert td.dense_y.dtype == torch.uint8
    assert td.dense_y.stride(0) % 16 == 0      # 16-byte rows for the kernel
    if n > 4096:
        assert ts.n > 4096 and td.dense_y.shape == (4608, ts.m)


def test_load_dataset_equal(tmp_path):
    # both writers, same seed: byte-identical files
    j_write(str(tmp_path / "j"), np.random.default_rng(3), 70, 45, k=3,
            scale=4.0, test_frac=0.15, valid_frac=0.1)
    t_write(str(tmp_path / "t"), np.random.default_rng(3), 70, 45, k=3,
            scale=4.0, test_frac=0.15, valid_frac=0.1)
    for f in ("train.tsv", "validation.tsv", "test.tsv", "test_users.tsv"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    js, jv, jt = j_load(str(tmp_path / "j"), 70, 45, False, 1)
    ts, tv, tt = t_load(str(tmp_path / "j"), 70, 45, False, 1)
    _assert_stores_equal(js, ts)
    assert tv == jv and tt == jt
    assert t_loo(tt) == j_loo(jt) and t_vum(tv) == j_vum(jv)
    _assert_device_equal(j_build(js), t_build(ts, "cpu"))


def test_undensifiable_layouts_raise():
    """Kept under its slice-1 name: the layouts that raised then are now
    built as the JAX package builds them: the hybrid fields, and the
    COO-only layout when neither dense_y nor a head fits."""
    s = TStore(4, 4)
    s.add_training([1, 2, 3], [1, 2, 2], [1, 3, 2])
    s.finalize()
    js = JStore(4, 4)
    js.add_training([1, 2, 3], [1, 2, 2], [1, 3, 2])
    js.finalize()
    hd = t_build(s, "cpu", hybrid_head_items=8, dense_limit_bytes=1)
    jhd = j_build(js, hybrid_head_items=8, dense_limit_bytes=1)
    assert hd.dense_y is None and jhd.dense_y is None
    np.testing.assert_array_equal(hd.head_items.numpy(),
                                  np.asarray(jhd.head_items))
    np.testing.assert_array_equal(hd.head_dense_y.numpy(),
                                  np.asarray(jhd.head_dense_y))
    assert hd.head_dense_y.shape == (512, 2) and hd.tail.nnz == 0
    # no head fits the budget and the catalog does not densify: COO only
    coo = t_build(s, "cpu", hybrid_head_items=8, dense_limit_bytes=1,
                  head_limit_bytes=100)
    jcoo = j_build(js, hybrid_head_items=8, dense_limit_bytes=1,
                   head_limit_bytes=100)
    assert jcoo.dense_y is None and jcoo.head_dense_y is None
    assert coo.dense_y is None and coo.head_dense_y is None
    assert coo.head_items is None and coo.tail is None
    np.testing.assert_array_equal(coo.u_ids.numpy(), np.asarray(jcoo.u_ids))
