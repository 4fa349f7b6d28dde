"""Streamed masked top-k and rank counter over item chunks.

Port of `hgaprec_tpu/eval/topk.py:22-179`. For catalogs above
DEVICE_TOPK_THRESHOLD items (EchoNest M = 384,546) the [users, M] score
matrix is never built: items are scored in chunks of 16,384 with an f32
`torch.matmul` (the JAX package leaves this product to XLA, so it needs
no hand-written kernel), train and validation entries are set to 0.0,
out-of-catalog columns score -1, and a running `torch.topk` keeps the
best k. The rank counter makes one pass over the same chunks.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from hgaprec_tpu_torch.eval.score import Scorer


def _chunks(sc: Scorer, users: torch.Tensor, mask_cols: torch.Tensor,
            item_chunk: int) -> Iterator[Tuple[int, torch.Tensor]]:
    """(c0, f32 scores [S, item_chunk]) for each item chunk, masked
    entries 0.0 and columns past M -1.0 (topk.py:41-62)."""
    m = sc.sv.shape[0]
    su = sc.su[users]
    bu = sc.bias_u[users] if sc.bias_u is not None else None
    rows = torch.arange(users.shape[0], device=su.device)[:, None] \
        .expand_as(mask_cols)
    for c0 in range(0, m, item_chunk):
        c1 = min(c0 + item_chunk, m)
        blk = su @ sc.sv[c0:c1].T
        if bu is not None:
            blk = blk + bu[:, None] + sc.bias_i[None, c0:c1]
        scores = torch.full((users.shape[0], item_chunk), -1.0,
                            dtype=torch.float32, device=su.device)
        scores[:, :c1 - c0] = blk
        local = mask_cols - c0
        hit = (local >= 0) & (local < c1 - c0)
        scores[rows[hit], local[hit]] = 0.0
        yield c0, scores


def _mask_tensor(store, index, users: np.ndarray, device) -> torch.Tensor:
    from hgaprec_tpu_torch.eval.ranking import build_mask_matrix
    return torch.from_numpy(build_mask_matrix(store, index, users,
                                              round_to=64)
                            ).to(device=device, dtype=torch.long)


def masked_topk(sc: Scorer, store, index, users: np.ndarray, k: int = 100,
                item_chunk: int = 16384) -> Tuple[np.ndarray, np.ndarray]:
    """(values f32 [S, k], ids i32 [S, k]) of the masked ranking, with
    masked entries scored 0.0 (reference semantics: they sort to the
    bottom, not to -inf). Ties may come out in another order than
    `jax.lax.top_k` gives them."""
    dev = sc.su.device
    chunk = min(item_chunk, max(store.m, 128))
    u = torch.as_tensor(np.asarray(users, np.int64), device=dev)
    mask = _mask_tensor(store, index, users, dev)
    best_v = torch.full((u.shape[0], k), -float("inf"), device=dev)
    best_i = torch.full((u.shape[0], k), -1, dtype=torch.long, device=dev)
    for c0, scores in _chunks(sc, u, mask, chunk):
        v, i = torch.topk(scores, min(k, chunk), dim=1)
        best_v = torch.cat([best_v, v], dim=1)
        best_i = torch.cat([best_i, i + c0], dim=1)
        best_v, sel = torch.topk(best_v, k, dim=1)
        best_i = torch.gather(best_i, 1, sel)
    return (best_v.cpu().numpy(),
            best_i.to(torch.int32).cpu().numpy())


def item_ranks(sc: Scorer, store, index, users: np.ndarray,
               items: np.ndarray, limit_m: int = 0,
               item_chunk: int = 16384, pair_chunk: int = 4096
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Masked rank of items[j] for users[j] (paired arrays), streamed.

    rank = #{i != t, i < limit_m: s_i > s_t} + #{i < t, i < limit_m:
    s_i == s_t}, the position a stable descending argsort gives
    (topk.py:88-154). The target score is an exact per-row dot, and the
    target's own column is excluded explicitly, so the streamed product
    need not reproduce it bit for bit. limit_m < M keeps gen_msr_csv's
    `m < M-1` quirk. Returns (ranks i32 [S], target scores f32 [S])."""
    limit_m = limit_m or store.m
    dev = sc.su.device
    chunk = min(item_chunk, max(store.m, 128))
    ranks = np.zeros(len(users), np.int32)
    tgts = np.zeros(len(users), np.float32)
    for lo in range(0, len(users), pair_chunk):
        uu = np.asarray(users[lo:lo + pair_chunk], np.int64)
        u = torch.as_tensor(uu, device=dev)
        t = torch.as_tensor(np.asarray(items[lo:lo + pair_chunk], np.int64),
                            device=dev)
        tgt = (sc.su[u] * sc.sv[t]).sum(1)
        if sc.bias_u is not None:
            tgt = tgt + sc.bias_u[u] + sc.bias_i[t]
        acc = torch.zeros(u.shape[0], dtype=torch.int64, device=dev)
        mask = _mask_tensor(store, index, uu, dev)
        for c0, scores in _chunks(sc, u, mask, chunk):
            col = torch.arange(c0, c0 + chunk, device=dev)[None, :]
            live = (col < limit_m) & (col != t[:, None])
            gt = live & (scores > tgt[:, None])
            tie = live & (scores == tgt[:, None]) & (col < t[:, None])
            acc += gt.sum(1) + tie.sum(1)
        ranks[lo:lo + len(uu)] = acc.cpu().numpy()
        tgts[lo:lo + len(uu)] = tgt.cpu().numpy()
    return ranks, tgts
