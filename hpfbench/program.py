"""The system under test, as the benchmark drives it: the port's layout,
state types, fused multi-step and kernel library (`hgaprec_tpu_torch`).

The modules of the benchmark that import the port are this one, which
drives it, and `spans.py`, which reads its span record. The layout is
the port's own `build_device_data`, which decides whether the catalog
densifies and how wide the hybrid head is, given the arguments the
Trainer (models/engine.py) hands it: the matmul precision and the packed
width (K, + 2 with bias). The one choice made here is
the Trainer's, which the port keeps inline and the benchmark cannot call
without building a Trainer: the head is asked for (`hybrid_head_items`)
under `hybrid`, and under `auto` when users x items does not fit
`dense_limit_bytes`. The step's route is the port's `_resolve_mode`,
inside the multi-step.
"""

from __future__ import annotations

import os
import time
import types
from typing import Dict

import numpy as np
import torch

from hgaprec_tpu_torch.config import ModelConfig, set_matmul_precision
from hgaprec_tpu_torch.data.device import build_device_data
from hgaprec_tpu_torch.models.state import Gam, ModelState
# make_multi_step is the runs' entry: the benchmark calls it from here
from hgaprec_tpu_torch.models.step import (  # noqa: F401
    GraphMultiStep, make_multi_step)
from hgaprec_tpu_torch.ops import build
from hpfbench.refs.hpf import GAMS, PARTS, PRIORS


def load_kernels() -> None:
    """Build (the first run in a checkout) or load the kernel library."""
    build.load_library()


def model_config(cfg: dict, traffic: dict, n: int, m: int) -> ModelConfig:
    lay = cfg["layout"]
    mcfg = ModelConfig(n=n, m=m, k=cfg["k"], variant=cfg["model"],
                       sweep=traffic["sweep"],
                       matmul_precision=traffic["matmul_precision"],
                       hybrid_head_items=lay["hybrid_head_items"],
                       dense_limit_bytes=lay["dense_limit_bytes"],
                       head_limit_bytes=lay["head_limit_bytes"],
                       **cfg["priors"])
    set_matmul_precision(mcfg.matmul_precision)
    return mcfg


def layout(mcfg: ModelConfig, u: np.ndarray, i: np.ndarray, y: np.ndarray,
           device):
    """(DeviceData, info, seconds): the layout the Trainer would build,
    what each kernel layer is handed (`info`), and the host seconds of
    `build_device_data`, ended by a synchronize."""
    n, m = mcfg.n, mcfg.m
    will_densify = n * m <= mcfg.dense_limit_bytes
    head = (mcfg.hybrid_head_items if mcfg.sweep == "hybrid" or
            (mcfg.sweep == "auto" and not will_densify) else 0)
    # the fields of a finalized RatingsStore that the layout reads
    store = types.SimpleNamespace(n=n, m=m, coo_u=u, coo_i=i, coo_y=y)
    t0 = time.perf_counter()
    data = build_device_data(store, device, hybrid_head_items=head,
                             dense_limit_bytes=mcfg.dense_limit_bytes,
                             head_limit_bytes=mcfg.head_limit_bytes,
                             precision=mcfg.matmul_precision,
                             kaug=mcfg.k + 2 * mcfg.bias)
    if data.y.is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nnz = int(u.shape[0])
    if data.head_dense_y is not None:
        tail = data.tail.nnz
        t = int(data.head_items.shape[0])
        info = {"dense_rows": n, "dense_cols": t, "dense_nnz": nnz - tail,
                "sparse_nnz": tail}
    elif data.dense_y is not None:
        info = {"dense_rows": n, "dense_cols": m, "dense_nnz": nnz,
                "sparse_nnz": 0}
    else:
        info = {"dense_rows": 0, "dense_cols": 0, "dense_nnz": 0,
                "sparse_nnz": nnz}
    return data, info, seconds


def model_state(leaves: Dict[str, torch.Tensor]) -> ModelState:
    """The port's state over these tensors (no copies: the step writes
    into them)."""
    gams = {g: Gam(*(leaves[f"{g}.{p}"] for p in PARTS)) for g in GAMS}
    return ModelState(theta_bias=None, beta_bias=None, theta_mle=None,
                      beta_mle=None, **gams,
                      **{p: leaves[p] for p in PRIORS})


def leaves(state: ModelState) -> Dict[str, torch.Tensor]:
    out = {f"{g}.{p}": getattr(getattr(state, g), p)
           for g in GAMS for p in PARTS}
    out.update({p: getattr(state, p) for p in PRIORS})
    return out


def counts(multi: GraphMultiStep) -> Dict[str, int]:
    return {"eager_steps": multi.eager_steps, "captures": multi.captures,
            "replays": multi.replays}


def csrc_dir() -> str:
    """The port's CUDA sources, whose kernel names the metrics read."""
    return os.path.abspath(build.CSRC_DIR)
