"""Native NMF (port of `hgaprec_tpu/ops/nmf.py`) — replaces the
reference's bundled libNMF.

The reference optionally links University-of-Vienna libNMF and runs its
multiplicative-update NMF ("mu") on a dense dump of the training
matrix (hgaprec.cc:891-917, src/nmflib/). Here it is the Lee–Seung loop
as f32 `torch.matmul` products: plain products that the JAX package also
leaves to XLA, so no hand-written kernel.

W: [N, K] user factors, H: [K, M] item factors, V ≈ W H (Frobenius).
The initial factors come from a `torch.Generator` seeded with `seed`, so
they differ from the JAX package's `jax.random` draws;
`multiplicative_updates` takes the start explicitly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_EPS = 1e-9


def multiplicative_updates(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                           iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` rounds of H <- H (Wᵀ V) / (Wᵀ W H), then
    W <- W (V Hᵀ) / (W H Hᵀ), from (w, h); returns the new (w, h)."""
    for _ in range(iters):
        h = h * (w.T @ v) / ((w.T @ w) @ h + _EPS)
        w = w * (v @ h.T) / (w @ (h @ h.T) + _EPS)
    return w, h


def nmf(dense_counts, k: int, device, iters: int = 100, seed: int = 0
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Factorize the (dense) count matrix on `device`; returns
    (theta [N,K], beta [M,K]) for the Scorer (prediction_score_nmf,
    hgaprec.cc:1877-1886 scores theta[n]·beta[m])."""
    v = torch.as_tensor(np.asarray(dense_counts), dtype=torch.float32,
                        device=device)
    n, m = v.shape
    gen = torch.Generator(device=v.device).manual_seed(seed)

    def uniform(*size):     # U[1e-3, 1), the JAX package's init range
        return 1e-3 + (1.0 - 1e-3) * torch.rand(
            *size, generator=gen, dtype=v.dtype, device=v.device)

    w0 = uniform(n, k)
    h0 = uniform(k, m)
    w, h = multiplicative_updates(v, w0, h0, iters)
    return w.cpu().numpy(), h.T.contiguous().cpu().numpy()
