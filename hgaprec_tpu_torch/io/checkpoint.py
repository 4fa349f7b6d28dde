"""Checkpoint I/O (port of `hgaprec_tpu/io/checkpoint.py`).

Two formats, with the JAX package's file names and keys:

  * Reference-compatible TSVs — `{name}.tsv` (E[v]), `{name}_shape.tsv`,
    `{name}_rate.tsv` with rows `seq \\t externalID \\t v0 ... vK-1` at
    %.8f (gpbase.hh:389-398, matrix.hh:1140-1166; 1-D arrays one value per
    row, matrix.hh:726-744).
  * A native .npz with the complete state + iteration counter, keyed
    `theta.shape`, `theta.rate`, `theta.e`, `theta.elog`, ...,
    `theta_prior_e`, ...; each package loads the other's.

The TSV writer is the threaded native one (`data/native.py`) where g++
builds it, else a Python loop that writes the same bytes.

The writers take host arrays (models/state.py::state_to_numpy), so a
save can run on a thread while the device state moves on.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np

from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.data import native
from hgaprec_tpu_torch.models.state import state_from_numpy


def _fixed8(v: float) -> str:
    """One value as `native/fastsave.cc::fmt_fixed8` writes it: %.8f with
    the fraction rounded half up from v * 1e8 in double precision, and
    printf's %.8f where |v| >= 9e9 or v is not finite. So the native
    writer and this fallback write the same bytes."""
    sign = "-" if v < 0 else ""
    v = abs(v) if v < 0 else v
    if not v < 9e9:
        return sign + "%.8f" % v
    s = int(v * 1e8 + 0.5)
    return f"{sign}{s // 100000000}.{s % 100000000:08d}"


def _save_mat(path: str, x: np.ndarray, idmap: Dict[int, int]) -> None:
    x = np.atleast_2d(np.asarray(x, np.float32))
    if x.shape[0] == 1 and x.size > 1:
        x = x.T  # 1-D arrays saved one value per row (matrix.hh:726-744)
    ext = np.fromiter((idmap.get(i, i) for i in range(x.shape[0])),
                      np.int64, x.shape[0])
    # the threaded native writer first (data/native.py), as the JAX
    # package does (hgaprec_tpu/io/checkpoint.py:34-47)
    if native.write_tsv_mat(path, x, ext):
        return
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            vals = "\t".join(_fixed8(v) for v in x[i].tolist())
            f.write(f"{i}\t{int(ext[i])}\t{vals}\n")


def save_gam_tsv(outdir: str, name: str, arrays: Mapping[str, np.ndarray],
                 field: str, idmap: Dict[int, int]) -> None:
    """GP*::save_state (gpbase.hh:389-398, 743-752, 971-980)."""
    _save_mat(os.path.join(outdir, f"{name}.tsv"), arrays[f"{field}.e"],
              idmap)
    _save_mat(os.path.join(outdir, f"{name}_shape.tsv"),
              arrays[f"{field}.shape"], idmap)
    _save_mat(os.path.join(outdir, f"{name}_rate.tsv"),
              arrays[f"{field}.rate"], idmap)


def save_model_tsv(outdir: str, arrays: Mapping[str, np.ndarray],
                   cfg: ModelConfig, seq2user: Dict[int, int],
                   seq2movie: Dict[int, int]) -> None:
    """HGAPRec::save_model (hgaprec.cc:2137-2158)."""
    if cfg.hier:
        save_gam_tsv(outdir, "hbeta", arrays, "beta", seq2movie)
        save_gam_tsv(outdir, "betarate", arrays, "beta_rate", seq2movie)
        save_gam_tsv(outdir, "htheta", arrays, "theta", seq2user)
        save_gam_tsv(outdir, "thetarate", arrays, "theta_rate", seq2user)
    else:
        save_gam_tsv(outdir, "beta", arrays, "beta", seq2movie)
        save_gam_tsv(outdir, "theta", arrays, "theta", seq2user)
    if cfg.bias:
        save_gam_tsv(outdir, "betabias", arrays, "beta_bias", seq2movie)
        save_gam_tsv(outdir, "thetabias", arrays, "theta_bias", seq2user)


def save_npz(path: str, arrays: Mapping[str, np.ndarray],
             iteration: int) -> None:
    np.savez(path, iteration=np.asarray(iteration), **arrays)


def load_npz(path: str, cfg: ModelConfig, device):
    """Returns (state on `device`, iteration). Missing e/elog are
    recomputed from shape/rate."""
    with np.load(path) as z:
        arrays = {key: z[key] for key in z.files if key != "iteration"}
        iteration = int(z["iteration"])
    return state_from_numpy(arrays, cfg, device), iteration

