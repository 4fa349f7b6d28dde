"""Checkpoint I/O (port of `hgaprec_tpu/io/checkpoint.py`).

Two formats, with the JAX package's file names and keys:

  * Reference-compatible TSVs — `{name}.tsv` (E[v]), `{name}_shape.tsv`,
    `{name}_rate.tsv` with rows `seq \\t externalID \\t v0 ... vK-1` at
    %.8f (gpbase.hh:389-398, matrix.hh:1140-1166; 1-D arrays one value per
    row, matrix.hh:726-744).
  * A native .npz with the complete state + iteration counter, keyed
    `theta.shape`, `theta.rate`, `theta.e`, `theta.elog`, ...,
    `theta_prior_e`, ...; each package loads the other's.

`load_model_tsv` reads the TSVs back (written by either package) into a
template state, the fallback of `Trainer.load_model` when no npz exists.

The TSV writer is the threaded native one (`data/native.py`) where g++
builds it, else a Python loop that writes the same bytes.

The writers take host arrays (models/state.py::state_to_numpy), so a
save can run on a thread while the device state moves on.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping

import numpy as np
import torch

from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.data import native
from hgaprec_tpu_torch.models.state import Gam, ModelState, state_from_numpy
from hgaprec_tpu_torch.ops.gamma import expectations


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


def _load_mat(path: str) -> np.ndarray:
    """f64 [rows, cols] of a `seq \t externalID \t v0 ...` TSV."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows.append([float(v) for v in parts[2:]])
    return np.asarray(rows, dtype=np.float64)


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
    if cfg.mle:
        for field, idmap in (("theta_mle", seq2user), ("beta_mle", seq2movie)):
            if field in arrays:
                _save_mat(os.path.join(outdir, f"{field}.tsv"), arrays[field],
                          idmap)


def load_model_tsv(indir: str, cfg: ModelConfig,
                   template: ModelState) -> ModelState:
    """HGAPRec::load_beta_and_theta (hgaprec.cc:2114-2135) into a copy of
    `template`, on the template's device.

    Each family keeps its own loader, as in the JAX package
    (hgaprec_tpu/io/checkpoint.py:93-155): theta/beta of BPF read shape
    and a global rate (GPMatrixGR::load, gpbase.hh:754-764), the HPF
    families shape and per-row rate, both recomputing the expectations;
    the biases read E[v] only (GPMatrix::load, gpbase.hh:410-415). Leaves
    with no file keep the template's tensors. A 1-D family (the HPF
    activity/popularity rates) is read back at its template's shape,
    where the JAX loader keeps an [N, 1] shape whose expectations then
    broadcast to [N, N]."""
    dt = getattr(torch, cfg.dtype)
    dev = template.theta.e.device

    def read(name: str, like: torch.Tensor) -> torch.Tensor:
        x = _load_mat(os.path.join(indir, f"{name}.tsv"))
        return torch.tensor(x.reshape(like.shape), dtype=dt, device=dev)

    def load_shape_rate(name: str, g: Gam) -> Gam:
        shape = read(f"{name}_shape", g.shape)
        rate = read(f"{name}_rate", g.rate)
        e, elog = expectations(shape, rate)
        return Gam(shape, rate, e.contiguous(), elog.contiguous())

    def load_ev_only(name: str, g: Gam) -> Gam:
        return dataclasses.replace(g, e=read(name, g.e))

    kw = {}
    if cfg.hier:
        kw["theta_rate"] = load_shape_rate("thetarate", template.theta_rate)
        kw["beta_rate"] = load_shape_rate("betarate", template.beta_rate)
        kw["theta"] = load_shape_rate("htheta", template.theta)
        kw["beta"] = load_shape_rate("hbeta", template.beta)
    else:
        kw["theta"] = load_shape_rate("theta", template.theta)
        kw["beta"] = load_shape_rate("beta", template.beta)
    if cfg.bias:
        kw["theta_bias"] = load_ev_only("thetabias", template.theta_bias)
        kw["beta_bias"] = load_ev_only("betabias", template.beta_bias)
    if cfg.mle:
        if template.theta_mle is not None:
            kw["theta_mle"] = read("theta_mle", template.theta_mle)
        if template.beta_mle is not None:
            kw["beta_mle"] = read("beta_mle", template.beta_mle)
    return dataclasses.replace(template, **kw)


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

