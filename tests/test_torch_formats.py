"""The port's baseline-bridge formats == the JAX package's.

Each case of tests/test_formats.py (and the rest of `data/formats.py`'s
surface) runs against both packages' modules on the same inputs; the
results, and the bytes of every file written, must be equal.
"""

import os

import numpy as np
import pytest

from conftest import make_synthetic
from hgaprec_tpu.data import formats as jformats
from hgaprec_tpu_torch.data import formats as tformats
from test_torch_step import port_store


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))
            if (d / name).is_file()}


def _lda_training_matrix(fm, store, validation, d):
    n = fm.write_lda_training_matrix(store, str(d / "l.tsv"))
    return n, _files(d)


def _vwlda_training_matrix(fm, store, validation, d):
    n = fm.write_vwlda_training_matrix(store, str(d / "l.tsv"))
    return n, _files(d)


def _nmf_training_matrix(fm, store, validation, d):
    n = fm.write_nmf_training_matrix(store, str(d / "t.tsv"))
    return n, _files(d)


def _chi_matrixmarket(fm, store, validation, d):
    out = [fm.write_chi_training_matrix(store, validation, str(d))]
    for wals_c in (10, 3):
        sub = d / f"wals{wals_c}"
        sub.mkdir()
        out.append(fm.write_chi_training_matrix(store, validation, str(sub),
                                                wals=True, wals_c=wals_c))
        out.append(_files(sub))
    return out, _files(d)


def _mm_load_rowmajor(fm, store, validation, d):
    (d / "f.mm").write_text("%%MatrixMarket matrix array real general\n%\n"
                            "2 3\n1.5 2.5 3.5\n4.5 5.5 6.5\n")
    (d / "short.mm").write_text("%%MatrixMarket\n3 2\n1 2 3\n")
    return (fm.mm_load_rowmajor(str(d / "f.mm"), 2, 3),
            fm.mm_load_rowmajor(str(d / "short.mm"), 3, 2))


def _lda_factor_import(fm, store, validation, d):
    (d / "gamma.tsv").write_text("1 3\n2 2\n4 4\n")
    (d / "beta.tsv").write_text("0 -1 -2 -3\n-3 -2 -1 0\n")
    return fm.load_lda_factors(3, 4, 2, str(d / "gamma.tsv"),
                               str(d / "beta.tsv"))


def _vwlda_factor_import(fm, store, validation, d):
    (d / "gamma.tsv").write_text("1 3\n2 2\n4 4\n")
    (d / "beta.tsv").write_text("h\n" * 11 + "0 0.5 1.5\n1 2 1\n2 1 1\n"
                                "3 0.25 4\n")
    return fm.load_vwlda_factors(3, 4, 2, str(d / "gamma.tsv"),
                                 str(d / "beta.tsv"))


def _dense_table(fm, store, validation, d):
    (d / "t.tsv").write_text("hdr\n7 1 2 x 3\n8 4 5 6\n9 7\n")
    return [fm.load_dense_table(str(d / "t.tsv"), 3, 3, **kw) for kw in (
        {}, dict(skipcols=1, skiprows=1), dict(skiprows=1, transpose=True))]


def _ctr_import(fm, store, validation, d):
    (d / "final-U.dat").write_text("1 2\n3 4\n")
    (d / "final-V.dat").write_text("5 6\n7 8\n9 10\n")
    (d / "user_map.dat").write_text("100,0\n101,1\n")
    (d / "item_map.dat").write_text("200,0\n201,1\n202,2\n")
    return fm.load_ctr_factors(2, 3, 2, str(d))


def _nmf_load_factors(fm, store, validation, d):
    (d / "theta.tsv").write_text("h1\nh2\n1 2\n3 4\n5 6\n")
    (d / "beta.tsv").write_text("h1\nh2\n10 20 30 40\n50 60 70 80\n")
    (d / "beta2.tsv").write_text("h1\nh2\n10 50\n20 60\n30 70\n40 80\n")
    return (fm.nmf_load_factors(3, 4, 2, str(d / "theta.tsv"),
                                str(d / "beta.tsv")),
            fm.nmf_load_factors(3, 4, 2, str(d / "theta.tsv"),
                                str(d / "beta2.tsv")))


def _apply_ctr_maps(fm, store, validation, d):
    theta = np.asarray([[1.0, 1], [2, 2]])
    beta = np.asarray([[3.0, 3], [4, 4], [5, 5]])
    return fm.apply_ctr_maps(theta, beta, {100: 1, 101: 0},
                             {200: 2, 201: 0, 202: 1}, {0: 100, 1: 101},
                             {0: 200, 1: 201, 2: 202}, 2, 3)


def _ctr_map_csvs(fm, store, validation, d):
    umap = {store.seq2user[u]: (u * 7) % store.n for u in range(store.n)}
    imap = {store.seq2movie[i]: i for i in range(0, store.m, 2)}
    fm.write_ctr_map_csvs(str(d), umap, imap, store.seq2user,
                          store.seq2movie, store.n, store.m)
    return _files(d)


def _commands(fm, store, validation, d):
    out = [fm.chi_command(tool, "/out", 7, graphchi_root="/gc",
                          minval=1, maxval=5)
           for tool in ("als", "wals", "climf", "biassgd", "pmf", "nmf")]
    out.append(fm.vwlda_command("/out", 7, 20, 15, vw_binary="/bin/vw"))
    return out


CASES = {f.__name__[1:]: f for f in (
    _lda_training_matrix, _vwlda_training_matrix, _nmf_training_matrix,
    _chi_matrixmarket, _mm_load_rowmajor, _lda_factor_import,
    _vwlda_factor_import, _dense_table, _ctr_import, _nmf_load_factors,
    _apply_ctr_maps, _ctr_map_csvs, _commands)}


def assert_same(a, b, where="result"):
    """Equal values and types, recursively through tuples, lists, dicts
    and arrays (arrays bitwise, with their dtype and shape)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for key in a:
            assert_same(a[key], b[key], f"{where}[{key!r}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_formats_equal(tmp_path, rng, case):
    js, validation, _ = make_synthetic(rng, n=20, m=15, density=0.4)
    results = []
    for name, fm, store in (("jax", jformats, js),
                            ("torch", tformats, port_store(js))):
        d = tmp_path / name
        d.mkdir()
        results.append(CASES[case](fm, store, validation, d))
    assert_same(results[1], results[0])
