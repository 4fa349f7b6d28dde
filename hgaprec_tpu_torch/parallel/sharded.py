"""Multi-GPU CAVI: user-row data parallelism over a process group.

Port of `hgaprec_tpu/parallel/sharded.py` on torch.distributed, one rank
per device:

  * the user axis is cut into equal row blocks, one per rank (the last
    block padded; `row_mask` zeroes its padding rows' expectations);
  * theta-side state (theta, xi, theta_bias, theta_mle, the priors in
    effect) holds the rank's own rows; beta-side state is replicated;
  * each rank sweeps its own nonzeros with local user ids through the
    single-device sweep and its kernels (dense, hybrid head and tail, CSR
    segment sweep);
  * the only traffic per iteration is the all-reduce of the item-side
    statistics ([M, K], and [M] with bias) and of the K-length user-axis
    column sums (`models/step.py::cavi_step(..., group, row_mask)`), the
    coupling of CAVI's factor sums (hgaprec.cc:944-953, 1398-1411).

The JAX package traces one SPMD program over a mesh, so every shard's
arrays are padded to the global maximum shapes; here each rank runs its
own eager program and keeps its own lengths. Only the state's rows are
padded, so the gathered state has the shape of the single-device one.

A rank's iterations between two reports (`ShardedRun.multi_step`, the
JAX package's `fori_loop` over the shard-mapped step) go through the
run's `models/step.py::GraphMultiStep`: over NCCL one eager step, one
captured step with its all-reduces inside the CUDA graph, and replays of
it for every other step; over gloo and on the CPU the loop, since gloo's
all-reduce of a CUDA tensor is a round trip through the host that no
capture can hold (`_gloo_cuda`). `ShardedRun.close()` drops the graph,
which holds work of the group's communicator, before the group goes.

The ranking eval shards the items instead (`sharded_masked_topk`): each
rank scores its item block, masks it, takes a local top-k, and an
all-gather and merge give the global top-k. Where each rank ingested only
its own users, the evaluated users' rows are gathered first (`user_view`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.data.device import (DeviceData, build_layout,
                                           card_head_width, head_width,
                                           note_head, top_degree_items)
from hgaprec_tpu_torch.data.ratings import RatingsStore
from hgaprec_tpu_torch.models.state import (ARRAY_FIELDS, GAM_FIELDS, Gam,
                                            ModelState, init_arrays,
                                            state_from_numpy)
from hgaprec_tpu_torch.models.step import (GraphMultiStep, cavi_step,
                                           make_multi_step)

_PARTS = ("shape", "rate", "e", "elog")


def _gloo_cuda(x: torch.Tensor, group) -> bool:
    """gloo takes CUDA tensors for all_reduce only: every other collective
    of a gloo group runs on a host copy."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' tensors concatenated along dim 0 in rank order, on x's
    device. Every rank passes the same shape."""
    if _gloo_cuda(x, group):
        return all_gather_rows(x.cpu(), group).to(x.device)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over the group (a new tensor on x's device)."""
    y = x.cpu().clone() if _gloo_cuda(x, group) else x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def rows_per_rank(n: int, world: int) -> int:
    """Rows of each rank's block: the user axis padded to a multiple of
    the world size, the partition of distributed.host_user_rows."""
    return -(-n // world)


def _row_sharded(key: str, cfg: ModelConfig) -> bool:
    """Whether the state array `key` (npz naming) holds one row per user:
    every theta-side array but a global per-factor rate (BPF theta)."""
    return key.startswith("theta") and (key != "theta.rate" or cfg.hier)


@dataclasses.dataclass
class ShardedRun:
    group: object
    cfg: ModelConfig           # the true user count: the step reads cfg.n
    true_n: int
    n_local: int               # rows of every rank's block
    data: DeviceData           # this rank's nonzeros, local user ids
    row_mask: torch.Tensor     # f32[n_local]: 1 on real rows, 0 on padding
    state: ModelState          # theta-side: this rank's rows; beta: replica
    # the run's fused multi-step (default: make_multi_step(cfg))
    runner: Optional[GraphMultiStep] = None

    def __post_init__(self):
        if self.runner is None:
            self.runner = make_multi_step(self.cfg)

    def step(self) -> ModelState:
        """One sharded iteration, eager."""
        return cavi_step(self.state, self.data, self.cfg, self.group,
                         self.row_mask)

    def multi_step(self, n_steps: int) -> ModelState:
        """n_steps sharded iterations back to back, no host sync between,
        through the run's runner: replayed from one captured step (its
        all-reduces inside the graph) over NCCL on a card, the loop over
        gloo (its collectives cannot be captured: module docstring) and
        on the CPU. Every rank calls it with the same n_steps."""
        return self.runner(self.state, self.data, n_steps, self.group,
                           self.row_mask)

    def close(self) -> None:
        """Drop the captured step's graph and its memory pool (the graph
        holds work of the group's communicator, so this comes before the
        group is destroyed); a later multi_step captures anew."""
        self.runner.reset()

    def unsharded_state(self, leaves: str = "full") -> ModelState:
        """The global state on this rank's device, padding rows stripped,
        for eval and checkpoints. Every rank must call it with the same
        `leaves`, since each row-sharded leaf is one all-gather:

          * "full": every leaf, the state a single-device run holds (the
            replicated beta side is the run's own tensors, not a copy);
          * "eval": only the expectations the scorer reads (e of each
            Gamma family, and the point matrices); shape, rate, elog and
            the priors are None, so a checkpoint from it fails loudly.
        """
        if leaves not in ("full", "eval"):
            raise ValueError(f"leaves must be 'full' or 'eval', not "
                             f"{leaves!r}")
        n = self.true_n

        def pull(key: str, t):
            if t is None:
                return None
            if not _row_sharded(key, self.cfg):
                return t
            return all_gather_rows(t, self.group)[:n]

        st = self.state
        kw: Dict[str, object] = {}
        for f in GAM_FIELDS:
            g = getattr(st, f)
            kw[f] = None if g is None else Gam(**{
                p: (pull(f"{f}.{p}", getattr(g, p))
                    if leaves == "full" or p == "e" else None)
                for p in _PARTS})
        for f in ARRAY_FIELDS:
            keep = leaves == "full" or f in ("theta_mle", "beta_mle")
            kw[f] = pull(f, getattr(st, f)) if keep else None
        return ModelState(**kw)


def build_sharded_data(store: RatingsStore, n_local: int, group, device, *,
                       dense: bool = True, dense_limit_bytes: int = 10 << 30,
                       hybrid_head_items: int = 0,
                       head_limit_bytes: int = 4 << 30,
                       precision: str = "highest",
                       kaug: int = 0) -> DeviceData:
    """This rank's layout (sharded.py:205-374 of the JAX package): the
    nonzeros of users [rank * n_local, (rank + 1) * n_local) with local
    user ids, built by data/device.py::build_layout.

      * dense_y [n_local, M] when the catalog densifies (the global
        n_padded * M within dense_limit_bytes), its rows padded as the
        single-device layout pads them;
      * else, with hybrid_head_items > 0, the hybrid layout: the head
        block over the GLOBAL top-T items by degree (degrees all-reduced
        over the group, so every rank holds the same head set and the
        same T: the JAX width, which depends only on n_local, M and the
        byte budget, and on a CUDA device data/device.py::
        card_head_width's within it, from the global degrees and user
        rows at `precision` and `kaug`), and this rank's tail stream
        (local user ids, global item ids);
      * the dual-sorted COO, its padding entries on the last real row.

    The store may hold every user's nonzeros or only this rank's
    (load_dataset(user_rows=...)): rows are picked by global user id."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    n, m = store.n, store.m
    lo = rank * n_local
    a, b = np.searchsorted(store.coo_u, [lo, lo + n_local])
    u, i, y = store.coo_u[a:b] - lo, store.coo_i[a:b], store.coo_y[a:b]
    want_dense = dense and world * n_local * m <= dense_limit_bytes and m > 0
    head_ids = None
    if not want_dense and hybrid_head_items > 0:
        t = head_width(n_local, m, hybrid_head_items, head_limit_bytes)
        if t > 0:
            deg = torch.from_numpy(np.bincount(i, minlength=m)
                                   .astype(np.int64)).to(device)
            deg = all_reduce(deg, group).cpu().numpy()
            if torch.device(device).type == "cuda":
                t = card_head_width(deg, -(-world * n_local // 512) * 512,
                                    t, precision, kaug)
            if t > 0:
                head_ids = top_degree_items(deg, t)
    real_rows = max(0, min(n - lo, n_local))
    data = build_layout(u, i, y, n_local, m, device, head_ids=head_ids,
                        dense=want_dense, pad_row=max(real_rows - 1, 0))
    note_head(data)
    return data


def build_sharded_run(store: RatingsStore, cfg: ModelConfig, group, device,
                      seed: int = 0,
                      arrays: Optional[Dict[str, np.ndarray]] = None
                      ) -> ShardedRun:
    """A rank's share of a sharded run over `group` on `device`.

    The layout decision is the single-device Trainer's (models/engine.py),
    taken on the padded user count. The initial state is drawn on the
    host at the true n (models/state.py::init_arrays, the same draws on
    every rank), or taken from `arrays` (npz keys, e.g. a resumed
    checkpoint); each rank keeps its own rows. The step sees the true n
    (the bias rate is 0.3 + n, hgaprec.cc:1265-1270); only the arrays are
    padded."""
    device = torch.device(device)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n = store.n
    n_local = rows_per_rank(n, world)
    n_padded = n_local * world
    dense = cfg.resolve_sweep() == "dense"
    will_densify = dense and n_padded * store.m <= cfg.dense_limit_bytes \
        and store.m > 0
    head = (cfg.hybrid_head_items if cfg.sweep == "hybrid" or
            (cfg.sweep == "auto" and not will_densify) else 0)
    lo = rank * n_local
    rows = store.local_user_rows
    if rows is not None and (rows.start > lo or
                             rows.stop < min(lo + n_local, n)):
        # a per-rank store that misses rows of this rank's block would
        # silently drop training data
        raise ValueError(
            f"store.local_user_rows={rows} does not cover this rank's rows "
            f"[{lo}, {lo + n_local}); ingest with "
            f"user_rows=parallel.distributed.host_user_rows")
    data = build_sharded_data(store, n_local, group, device, dense=dense,
                              dense_limit_bytes=cfg.dense_limit_bytes,
                              hybrid_head_items=head,
                              head_limit_bytes=cfg.head_limit_bytes,
                              precision=cfg.matmul_precision,
                              kaug=cfg.k + 2 * cfg.bias)
    if arrays is None:
        arrays = init_arrays(dataclasses.replace(cfg, n=n), seed)

    def own_rows(key: str, v: np.ndarray) -> np.ndarray:
        if not _row_sharded(key, cfg):
            return v
        block = np.zeros((n_local,) + v.shape[1:], v.dtype)
        mine = v[lo:lo + n_local]
        block[:mine.shape[0]] = mine      # padding rows stay zero
        return block

    state = state_from_numpy({k: own_rows(k, np.asarray(v))
                              for k, v in arrays.items()}, cfg, device)
    row_mask = ((lo + torch.arange(n_local, device=device)) < n).float()
    return ShardedRun(group=group, cfg=cfg, true_n=n, n_local=n_local,
                      data=data, row_mask=row_mask, state=state)


class UserView(RatingsStore):
    """The training rows of some users, gathered from every rank's share
    of a per-rank store, with the item degrees of the whole store: what
    the ranking eval reads of those users (their masks, their count of
    ranked items, ranking.tsv's filter and itemrank.tsv's degrees). The
    id maps are the store's own (they are global on every rank)."""

    def __init__(self, store: RatingsStore, coo: np.ndarray,
                 item_deg: np.ndarray):
        super().__init__(store.max_n, store.max_m, store.binary,
                         store.rating_threshold)
        for f in ("user2seq", "seq2user", "movie2seq", "seq2movie"):
            setattr(self, f, getattr(store, f))
        self._u, self._i, self._y = coo
        self.finalize()
        self._item_deg = item_deg

    def item_degrees(self) -> np.ndarray:
        return self._item_deg


def user_view(store: RatingsStore, users: np.ndarray, group,
              device) -> UserView:
    """`users`' training rows from every rank of `group` (each rank holds
    its own users' rows, load_dataset(user_rows=...)) and the item
    degrees all-reduced over it. Every rank must call it with the same
    users."""
    sel = np.isin(store.coo_u, np.asarray(users))
    mine = torch.from_numpy(np.stack([store.coo_u[sel], store.coo_i[sel],
                                      store.coo_y[sel]]).astype(np.int64))
    width = int(all_reduce(torch.tensor([mine.shape[1]], device=device),
                           group, dist.ReduceOp.MAX)[0])
    padded = torch.full((3, width), -1, dtype=torch.int64, device=device)
    padded[:, :mine.shape[1]] = mine.to(device)
    coo = all_gather_rows(padded[None], group).permute(1, 0, 2) \
        .reshape(3, -1).cpu().numpy()
    deg = all_reduce(torch.from_numpy(store.item_degrees()).to(device),
                     group)
    return UserView(store, coo[:, coo[0] >= 0], deg.cpu().numpy())


def sharded_masked_topk(sc, group, users: np.ndarray, mask_cols: np.ndarray,
                        k: int = 100):
    """Global masked top-k with the items sharded over `group`
    (sharded.py:547-617 of the JAX package).

    sc: eval.score.Scorer (replicated on every rank); users: [S];
    mask_cols: [S, D] global item ids to force to score 0.0 (reference
    semantics, hgaprec.cc:1729-1737), padded with out-of-range values.
    Each rank scores its block of ceil(M / W) items in f32, sets masked
    entries to 0.0 and columns past M to -1.0, keeps a local top-k, and
    the [W, S, k_local] candidates are all-gathered and merged. Returns
    (vals f32 [S, k'], ids i32 [S, k']), k' = min(k, W * k_local)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    m = sc.sv.shape[0]
    m_local = -(-m // world)
    k_local = min(k, m_local)
    c0, c1 = rank * m_local, min((rank + 1) * m_local, m)
    dev = sc.su.device
    u = torch.as_tensor(np.asarray(users, np.int64), device=dev)
    scores = torch.full((u.shape[0], m_local), -1.0, dtype=torch.float32,
                        device=dev)
    if c1 > c0:
        blk = sc.su[u] @ sc.sv[c0:c1].T
        if sc.bias_u is not None:
            blk = blk + sc.bias_u[u][:, None] + sc.bias_i[None, c0:c1]
        scores[:, :c1 - c0] = blk
    local = torch.as_tensor(np.asarray(mask_cols, np.int64), device=dev) - c0
    hit = (local >= 0) & (local < c1 - c0)
    rows = torch.arange(u.shape[0], device=dev)[:, None].expand_as(local)
    scores[rows[hit], local[hit]] = 0.0
    v, i = torch.topk(scores, k_local, dim=1)
    s = u.shape[0]
    av = all_gather_rows(v[None], group).permute(1, 0, 2).reshape(s, -1)
    ai = all_gather_rows((i + c0)[None], group).permute(1, 0, 2) \
        .reshape(s, -1)
    vals, sel = torch.topk(av, min(k, av.shape[1]), dim=1)
    return (vals.cpu().numpy(),
            torch.gather(ai, 1, sel).to(torch.int32).cpu().numpy())
