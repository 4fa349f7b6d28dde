"""Ranking-based evaluation (port of `hgaprec_tpu/eval/ranking.py`).

Scores come from the model's device. Up to DEVICE_TOPK_THRESHOLD items
ranking runs on the host over full score rows; above it the streamed
top-k and rank counter of eval/topk.py run on the scores' device and the
[users, M] matrix never exists. The reference's bookkeeping and file
contracts:

  * compute_precision (hgaprec.cc:1703-1848): p@10/p@100 over sampled
    users, score 0 for train+validation items, top-100 rows appended to
    ranking.tsv when saving.
  * compute_itemrank (hgaprec.cc:1607-1701): itemrank.tsv + meanrank.txt.
    NOTE the reference computes `1 / (j+1)` in *integer* arithmetic
    (hgaprec.cc:1683), so its "reciprocal rank" only credits rank-0 hits;
    we reproduce that in meanrank.txt for parity and additionally report
    the true MRR in meanrank_true.txt.
  * gen_msr_csv (hgaprec.cc:1993-2085): leave-one-out pred.csv, including
    the reference's `m < _m-1` scoring loop (the last item keeps a
    default (item 0, score 0) slot in the sort).
  * compute_rmse (hgaprec.cc:1579-1604): rmse.txt + test_scores.tsv.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, TextIO

import numpy as np
import torch
import torch.distributed as dist

from hgaprec_tpu_torch.data.ratings import CountMap, RatingsStore
from hgaprec_tpu_torch.eval.score import Scorer, pair_scores, user_scores
from hgaprec_tpu_torch.eval.topk import item_ranks, masked_topk
from hgaprec_tpu_torch.parallel import sharded

# above this catalog size the [users, M] host matrix is replaced by the
# streamed device top-k (eval/topk.py)
DEVICE_TOPK_THRESHOLD = 65536


def sample_users(rng: np.random.Generator, n: int, count: int = 1000
                 ) -> np.ndarray:
    """hgaprec.cc:1715-1721: draw users (with replacement) into a set
    until it holds min(count, n/2); do-while semantics: at least one."""
    limit = min(count, n // 2)
    users = {int(rng.integers(0, n))}
    while len(users) < limit:
        users.add(int(rng.integers(0, n)))
    return np.asarray(sorted(users), dtype=np.int32)


class EvalIndex:
    """Per-user item arrays for validation masking and test lookups."""

    def __init__(self, validation: CountMap, test: CountMap,
                 store: RatingsStore):
        self.val_by_user: Dict[int, np.ndarray] = _group(validation)
        self.test_by_user: Dict[int, list] = {}
        for (u, m), v in test.items():
            self.test_by_user.setdefault(u, []).append((m, v))
        # flat sorted (u * M + m) keys for vectorized hit counting
        if test:
            ks = np.asarray([u * store.m + m for (u, m) in test.keys()],
                            np.int64)
            vs = np.asarray(list(test.values()))
            hit = np.asarray([store.test_hit(int(v)) for v in vs], bool)
            self.hit_keys = np.sort(ks[hit])
        else:
            self.hit_keys = np.zeros(0, np.int64)

    def val_items(self, n: int) -> np.ndarray:
        return self.val_by_user.get(n, _EMPTY)


_EMPTY = np.zeros(0, np.int64)


def _group(cmap: CountMap) -> Dict[int, np.ndarray]:
    tmp: Dict[int, list] = {}
    for (u, m) in cmap.keys():
        tmp.setdefault(u, []).append(m)
    return {u: np.asarray(sorted(v), np.int64) for u, v in tmp.items()}


def masked_user_scores(sc: Scorer, store: RatingsStore, index: EvalIndex,
                       users: np.ndarray) -> np.ndarray:
    """[S, M] host scores with train+validation entries forced to 0.0
    (hgaprec.cc:1729-1737)."""
    s = user_scores(sc, users).to("cpu", torch.float64).numpy()
    cols = build_mask_matrix(store, index, users)
    rows = np.broadcast_to(np.arange(cols.shape[0])[:, None], cols.shape)
    live = cols >= 0
    s[rows[live], cols[live]] = 0.0
    return s


def build_mask_matrix(store: RatingsStore, index: EvalIndex,
                      users: np.ndarray, round_to: int = 1) -> np.ndarray:
    """i32[S, D] of global item ids to zero-score, padded with -1e9.

    Vectorized over the store's user CSR (row_ptr/coo_i): one fancy-index
    fill for all train items plus one for the (tiny) validation lists.
    Train/validation duplicates are left in place (masking the same
    column twice is a no-op); `round_to` pads D up to a multiple.
    """
    users = np.asarray(users, np.int64)
    s_count = users.size
    pad_val = -(10 ** 9)
    rp = store.row_ptr
    starts = rp[users]
    cnt_t = (rp[users + 1] - starts).astype(np.int64)
    val_lists = [index.val_items(int(n)) for n in users]
    cnt_v = np.fromiter((v.size for v in val_lists), np.int64,
                        count=s_count) if s_count else np.zeros(0, np.int64)
    d = int((cnt_t + cnt_v).max()) if s_count else 1
    d = -(-max(d, 1) // round_to) * round_to
    cols = np.full((s_count, d), pad_val, np.int32)
    # flat fill of every user's train-item slice
    tot_t = int(cnt_t.sum())
    if tot_t:
        row_t = np.repeat(np.arange(s_count), cnt_t)
        within = np.arange(tot_t) - np.repeat(
            np.cumsum(cnt_t) - cnt_t, cnt_t)
        flat = np.repeat(starts, cnt_t) + within
        cols[row_t, within] = store.coo_i[flat]
    tot_v = int(cnt_v.sum())
    if tot_v:
        row_v = np.repeat(np.arange(s_count), cnt_v)
        within_v = np.arange(tot_v) - np.repeat(
            np.cumsum(cnt_v) - cnt_v, cnt_v)
        cols[row_v, cnt_t[row_v] + within_v] = np.concatenate(
            [v for v in val_lists if v.size])
    return cols


def top_candidates(sc: Scorer, store: RatingsStore, index: EvalIndex,
                   users: np.ndarray, topn: int, group=None):
    """(values [S, topn], ids [S, topn]) of the masked ranking: a host
    stable argsort over the full score rows, or the streamed top-k above
    DEVICE_TOPK_THRESHOLD items.

    group: a process group of more than one rank shards the items over
    it (parallel/sharded.py::sharded_masked_topk): every rank must call.
    The store must hold the users' training rows (of a per-rank store,
    parallel/sharded.py::user_view)."""
    topn_eff = min(topn, store.m)
    if group is not None and dist.get_world_size(group) > 1:
        return sharded.sharded_masked_topk(
            sc, group, users, build_mask_matrix(store, index, users),
            k=topn_eff)
    if store.m > DEVICE_TOPK_THRESHOLD:
        return masked_topk(sc, store, index, users, k=topn_eff)
    scores = masked_user_scores(sc, store, index, users)
    top_idx = np.argsort(-scores, axis=1, kind="stable")[:, :topn_eff]
    return np.take_along_axis(scores, top_idx, axis=1), top_idx


def compute_precision(sc: Scorer, store: RatingsStore, index: EvalIndex,
                      users: np.ndarray,
                      precision_file: Optional[TextIO],
                      ranking_path: Optional[str] = None,
                      topn: int = 100, group=None) -> Dict[str, float]:
    """One precision report; optionally writes ranking.tsv. With a
    `group` of several ranks every rank joins the item-sharded top-k."""
    top_vals, top_idx = top_candidates(sc, store, index, users, topn, group)
    topn_eff = top_idx.shape[1]
    # vectorized hit lookup against the sorted (u*M + m) test-hit keys —
    # same predicate as the reference's per-candidate map lookup +
    # test_hit threshold (hgaprec.cc:1764-1800)
    keys = (users.astype(np.int64)[:, None] * store.m
            + top_idx.astype(np.int64))
    hk = index.hit_keys
    if hk.size:
        pos = np.minimum(np.searchsorted(hk, keys), hk.size - 1)
        hit_mat = hk[pos] == keys
    else:
        hit_mat = np.zeros(keys.shape, bool)
    total_users = len(users)
    p10 = float(np.mean(hit_mat[:, :min(10, topn_eff)].sum(axis=1) / 10.0))
    p100 = float(np.mean(hit_mat[:, :min(100, topn_eff)].sum(axis=1)
                         / 100.0))
    if ranking_path:
        with open(ranking_path, "w") as f:
            for r, n in enumerate(users):
                n = int(n)
                for j in range(topn_eff):
                    mm = int(top_idx[r, j])
                    if store.r(n, mm) == 0:
                        f.write(f"{store.seq2user[n]}\t{store.seq2movie[mm]}"
                                f"\t{top_vals[r, j]:.5f}\t"
                                f"{int(hit_mat[r, j])}\n")
    if precision_file is not None:
        precision_file.write(f"{total_users}\t{p10:.5f}\t{p100:.5f}\n")
        precision_file.flush()
    return {"users": total_users, "p10": p10, "p100": p100}


def compute_itemrank(sc: Scorer, store: RatingsStore, index: EvalIndex,
                     users: np.ndarray, outdir: str) -> Dict[str, float]:
    """itemrank.tsv + meanrank.txt (hgaprec.cc:1607-1701).

    Small catalogs: host argsort of the [S, M] masked score matrix. Above
    DEVICE_TOPK_THRESHOLD items the per-(user, test item) ranks come from
    the streamed rank counter (eval/topk.py::item_ranks), the same
    position a stable argsort gives."""
    item_deg = store.item_degrees()
    # flatten (user-row, item, value) over hit test items
    pairs_u, pairs_m, rows_of = [], [], {}
    for n in users:
        n = int(n)
        for mm, v in index.test_by_user.get(n, ()):
            if store.test_hit(v):
                rows_of.setdefault(n, []).append(len(pairs_u))
                pairs_u.append(n)
                pairs_m.append(mm)
    if pairs_u and store.m > DEVICE_TOPK_THRESHOLD:
        ranks, tscores = item_ranks(sc, store, index, np.asarray(pairs_u),
                                    np.asarray(pairs_m))
    elif pairs_u:
        scores = masked_user_scores(sc, store, index, users)
        row_ix = {int(n): r for r, n in enumerate(users)}
        ranks = np.zeros(len(pairs_u), np.int64)
        tscores = np.zeros(len(pairs_u), np.float64)
        for r, n in enumerate(users):
            n = int(n)
            if n not in rows_of:
                continue
            order = np.argsort(-scores[r], kind="stable")
            rank_of = np.empty_like(order)
            rank_of[order] = np.arange(order.size)
            for p in rows_of[n]:
                ranks[p] = rank_of[pairs_m[p]]
                tscores[p] = scores[row_ix[n], pairs_m[p]]
    sum_rank = sum_rr_ref = sum_rr_true = 0.0
    total_users = 0
    with open(os.path.join(outdir, "itemrank.tsv"), "w") as f:
        for n, prows in rows_of.items():
            # items not in training (validation/test count as ranked,
            # hgaprec.cc:1666-1667)
            nranked = store.m - store.items_of_user(n).size
            ntest = 0
            rank_ui = rr_ref = rr_true = 0.0
            for p in prows:
                j = int(ranks[p])
                mm = pairs_m[p]
                ntest += 1
                f.write(f"{n}\t{mm}\t{tscores[p]:.5f}\t{j}\t"
                        f"{int(item_deg[mm])}\n")
                rank_ui += j + 1
                rr_ref += 1 // (j + 1)        # hgaprec.cc:1683 int division
                rr_true += 1.0 / (j + 1)
            if ntest > 0 and nranked > 0:
                sum_rank += (rank_ui / nranked) / ntest
                sum_rr_ref += rr_ref / ntest
                sum_rr_true += rr_true / ntest
                total_users += 1
    tu = max(total_users, 1)
    with open(os.path.join(outdir, "meanrank.txt"), "w") as f:
        f.write(f"{total_users}\t{sum_rank / tu:.5f}\t{sum_rr_ref / tu:.5f}\n")
    with open(os.path.join(outdir, "meanrank_true.txt"), "w") as f:
        f.write(f"{total_users}\t{sum_rank / tu:.5f}\t{sum_rr_true / tu:.5f}\n")
    return {"users": total_users, "meanrank": sum_rank / tu,
            "mrr": sum_rr_true / tu}


# above this many score-matrix cells gen_msr_csv switches from host
# argsort chunks to the streamed rank counter (eval/topk.py::item_ranks)
MSR_HOST_CELL_BUDGET = 1 << 28


def gen_msr_csv(sc: Scorer, store: RatingsStore,
                index: EvalIndex, leave_one_out: Dict[int, int],
                val_users_of_movie: Dict[int, int], outdir: str) -> None:
    """pred.csv for leave-one-out evaluation (hgaprec.cc:1993-2085).

    Above MSR_HOST_CELL_BUDGET score cells (NYT: N=1.6M, M=107k) the
    [chunk, M] host matrices are replaced by the streamed rank counter on
    the scores' device: one (user, heldout item) rank per user, no
    per-user argsort."""
    item_deg = store.item_degrees()
    lusers = np.asarray([n for n in range(store.n) if n in leave_one_out],
                        np.int64)
    litems = np.asarray([leave_one_out[int(n)] for n in lusers], np.int64)
    use_device = store.n * store.m > MSR_HOST_CELL_BUDGET

    def meta_of(n, test_item):
        train_items = store.items_of_user(n)
        vitems = np.setdiff1d(index.val_items(n), train_items)
        training = int(np.sum(train_items < store.m - 1) +
                       np.sum(vitems < store.m - 1))
        negatives = (store.m - 1) - training
        ntrain_users = int(item_deg[test_item]) \
            if test_item < store.m else 0
        nvalid = val_users_of_movie.get(test_item, 0)
        return training, negatives, ntrain_users + nvalid

    with open(os.path.join(outdir, "pred.csv"), "w") as f:
        f.write("User\tHeldOutItem\tHeldOutItemIndex\tUserNegatives\t"
                "UserCount\tItemCount\n")
        if use_device and lusers.size:
            # reference loop scores m in [0, M-1) (hgaprec.cc:2023-2032);
            # the phantom (item 0, score 0.0) slot sorts after every tie
            # (stable order), so it advances the rank only when 0 > target
            ranks, tgt = item_ranks(sc, store, index, lusers, litems,
                                    limit_m=store.m - 1)
            ranks = ranks + (tgt < 0.0).astype(np.int32)
            # Edge parity with the host path (only with negative scores,
            # which imported chi/ctr factors can give): for target item 0
            # with tgt < 0 the host argsort reports the phantom slot, the
            # first id-0 hit, at #{s > 0} + #{s == 0 before it}, while the
            # counter reports the real item's rank. Clamp those rows to
            # the host-computed phantom position.
            sel = np.nonzero((litems == 0) & (tgt < 0.0))[0]
            for r in sel:
                n = int(lusers[r])
                s_row = masked_user_scores(
                    sc, store, index, np.asarray([n], np.int32))[0]
                s_row = s_row[:store.m - 1]
                phantom = int(np.sum(s_row > 0.0) + np.sum(s_row == 0.0))
                ranks[r] = min(int(ranks[r]), phantom)
            # heldout item outside the scored range never matches: rank 0
            ranks = np.where(litems >= store.m - 1, 0, ranks)
            for n, test_item, rank in zip(lusers, litems, ranks):
                n, test_item = int(n), int(test_item)
                training, negatives, icount = meta_of(n, test_item)
                f.write(f"{store.seq2user[n]}\t{store.seq2movie[test_item]}"
                        f"\t{int(rank)}\t{negatives}\t{training}\t"
                        f"{icount}\n")
            return
        chunk = 1024
        last_ids = np.concatenate([np.arange(store.m - 1), [0]])
        for lo in range(0, lusers.size, chunk):
            sub = lusers[lo:lo + chunk].astype(np.int32)
            scores = masked_user_scores(sc, store, index, sub)
            for r, n in enumerate(sub):
                n = int(n)
                test_item = leave_one_out[n]
                # reference loop scores m in [0, M-1): the last item keeps
                # a default (item 0, score 0.0) slot in the sort
                sub_scores = np.concatenate([scores[r, :store.m - 1], [0.0]])
                training, negatives, icount = meta_of(n, test_item)
                order = np.argsort(-sub_scores, kind="stable")
                sorted_ids = last_ids[order]
                hits = np.nonzero(sorted_ids == test_item)[0]
                rank = int(hits[0]) if hits.size else 0
                f.write(f"{store.seq2user[n]}\t{store.seq2movie[test_item]}\t"
                        f"{rank}\t{negatives}\t{training}\t"
                        f"{icount}\n")


def compute_rmse(sc: Scorer, test: CountMap,
                 outdir: str, rmse_file: TextIO) -> float:
    """rmse.txt + test_scores.tsv (hgaprec.cc:1579-1604)."""
    if not test:
        return 0.0
    pairs = sorted(test.keys())
    u = np.asarray([p[0] for p in pairs], np.int64)
    i = np.asarray([p[1] for p in pairs], np.int64)
    y = np.asarray([test[p] for p in pairs], np.float64)
    s = pair_scores(sc, u, i).to("cpu", torch.float64).numpy()
    with open(os.path.join(outdir, "test_scores.tsv"), "w") as f:
        for v, sv in zip(y, s):
            f.write(f"{int(v)}\t{sv:.5f}\n")
    rmse = float(np.sqrt(np.mean((s - y) ** 2)))
    rmse_file.write(f"{rmse:.5f}\n")
    rmse_file.flush()
    return rmse
