"""The port's native helpers (data/native.py) against the Python paths and
the JAX package's: the TSV checkpoint writer writes the same bytes as the
port's Python writer and as the JAX package's `_save_mat`, and the native
parser returns what the NumPy parser does."""

import os
import time

import numpy as np
import pytest

from hgaprec_tpu.data import native as j_native
from hgaprec_tpu.io.checkpoint import _save_mat as j_save_mat
from hgaprec_tpu_torch.data import native
from hgaprec_tpu_torch.data.ratings import _fast_parse_3col, _parse_tsv
from hgaprec_tpu_torch.io import checkpoint as ckpt


def _need_native():
    if not native.available():
        pytest.skip("g++ unavailable: the native helpers cannot be built")


def _need_jax_native(monkeypatch):
    """Load the JAX package's native writer in this process. Its first
    load can race with another test process's build of the same library
    (written in place) and then stays failed for the process, leaving
    `_save_mat` on its printf path, which may differ from the native
    formatter by one ulp; that build has finished by now, so load again."""
    for _ in range(5):
        if j_native._load() is not None:
            return
        monkeypatch.setattr(j_native, "_tried", False)
        time.sleep(0.5)
    if j_native._load() is None:
        pytest.fail("the JAX package's native TSV writer cannot be loaded "
                    "while the port's can: the byte comparison needs both")


def _values(rng, rows, cols):
    x = rng.gamma(0.3, 3.0, (rows, cols)).astype(np.float32)
    edge = [0.0, 1e-30, 12345.6789, 2.0e10, -0.75, 5e-9, 0.5, 123456789.0]
    x.flat[:min(x.size, 8)] = edge[:x.size]
    return x


@pytest.mark.parametrize("shape", [(257, 7), (40000, 3), (31, 1), (1, 5)])
def test_native_writer_bytes_equal_python_and_jax(tmp_path, monkeypatch,
                                                  shape):
    _need_native()
    _need_jax_native(monkeypatch)
    rng = np.random.default_rng(shape[0])
    x = _values(rng, *shape)
    if shape[1] == 1:
        x = x[:, 0]                      # 1-D: one value per row
    idmap = {i: int(e) for i, e in enumerate(
        rng.integers(0, 10 ** 9, max(shape)))}
    paths = {k: str(tmp_path / f"{k}.tsv") for k in ("native", "py", "jax")}
    ckpt._save_mat(paths["native"], x, idmap)
    j_save_mat(paths["jax"], x, idmap)
    monkeypatch.setattr(native, "write_tsv_mat", lambda *a: False)
    ckpt._save_mat(paths["py"], x, idmap)
    with open(paths["native"], "rb") as f:
        want = f.read()
    for k in ("py", "jax"):
        with open(paths[k], "rb") as f:
            assert f.read() == want, k
    first = want.split(b"\n", 1)[0].split(b"\t")
    assert first[0] == b"0" and int(first[1]) == idmap[0]
    assert len(want.splitlines()) == max(shape)


def test_native_library_is_the_ports_own():
    _need_native()
    path = native.library_path()
    assert os.path.basename(path) == "libfastload_torch.so"
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(".native_build")


@pytest.mark.parametrize("sep", ["\t", " ", "::"])
def test_native_parse_equals_numpy_parse(tmp_path, sep):
    _need_native()
    rng = np.random.default_rng(len(sep))
    rows = np.stack([rng.integers(1, 10 ** 6, 5000),
                     rng.integers(1, 10 ** 5, 5000),
                     rng.integers(1, 6, 5000)], axis=1)
    path = str(tmp_path / "train.tsv")
    with open(path, "w") as f:
        f.write("".join(sep.join(str(v) for v in r) + "\n" for r in rows))
    got = native.parse_tsv3(path)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(_parse_tsv(path), rows)
    if sep != "::":                     # the NumPy tokenizer splits on space
        np.testing.assert_array_equal(_fast_parse_3col(path), got)
