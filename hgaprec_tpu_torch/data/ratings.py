"""Host-side ratings store: TSV ingest, external<->internal ID remap, splits.

Re-implements the behavior of the reference `Ratings` class
(hgaprec's src/ratings.{hh,cc}) on NumPy arrays instead of per-user
std::vector adjacency + hashmaps:

  * read():            ratings.cc:5-40  — train.tsv ingest + marginals
  * read_generic():    ratings.cc:63-119 — uid\tmid\trating rows; first-seen
                       contiguous remap (add_user/add_movie, ratings.hh:118-151);
                       rows dropped when the remap tables are full or when
                       input_rating_class(rating) == 0
  * input_rating_class / test_hit thresholds: ratings.hh:183-197
  * binary mode stores y = 1 (ratings.cc:99-100)
  * write_marginal_distributions(): ratings.cc:217-271 -> byusers/byitems.tsv
  * read_test_users(): ratings.cc:273-292

The store keeps the training matrix as user-major sorted COO (the CSR
row-pointer view is derived), which is the layout the device sweep consumes.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from hgaprec_tpu_torch.data import native

# A test/validation map: {(user_seq, item_seq) -> rating}, the reference's
# CountMap (env.hh typedef; loaded at hgaprec.cc:110-152).
CountMap = Dict[Tuple[int, int], int]


def _parse_tsv(path: str) -> np.ndarray:
    """Parse `uid \t mid \t rating` rows to an int64 [R, 3] array.

    Mirrors fscanf("%u\t%u\t%u\n") (ratings.cc:70). Tries the native
    mmap parser (data/native.py), then the vectorized NumPy tokenizer,
    then a line-by-line fallback. Extra columns are ignored.
    """
    out = native.parse_tsv3(path)
    if out is not None:
        return out
    out = _fast_parse_3col(path)
    if out is not None:
        return out
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.replace(",", "\t").split()
            rows.append((int(parts[0]), int(parts[1]), int(float(parts[2]))))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def _fast_parse_3col(path: str) -> Optional[np.ndarray]:
    """Vectorized fast path for clean whitespace-separated numeric files."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
        if not buf:
            return np.zeros((0, 3), dtype=np.int64)
        ncol = len(buf.split(b"\n", 1)[0].split())
        arr = np.array(buf.split(), dtype=np.float64)
    except Exception:
        return None
    if ncol >= 3 and arr.size % ncol == 0 and arr.size > 0:
        mat = arr.reshape(-1, ncol)
        if np.all(mat[:, :3] == np.floor(mat[:, :3])):
            return mat[:, :3].astype(np.int64)
    return None


class RatingsStore:
    """In-memory sparse user-item count store with contiguous remapping."""

    def __init__(self, max_n: int, max_m: int, binary: bool = False,
                 rating_threshold: int = 1):
        self.max_n = int(max_n)
        self.max_m = int(max_m)
        self.binary = binary
        self.rating_threshold = int(rating_threshold)
        # external -> seq and back (reference: _user2seq/_seq2user etc.,
        # ratings.hh:54-58)
        self.user2seq: Dict[int, int] = {}
        self.movie2seq: Dict[int, int] = {}
        self.seq2user: Dict[int, int] = {}
        self.seq2movie: Dict[int, int] = {}
        # training COO (user-major sorted after finalize)
        self._u: list = []
        self._i: list = []
        self._y: list = []
        self.coo_u: np.ndarray = np.zeros(0, np.int32)
        self.coo_i: np.ndarray = np.zeros(0, np.int32)
        self.coo_y: np.ndarray = np.zeros(0, np.int32)
        self.row_ptr: np.ndarray = np.zeros(1, np.int64)  # user CSR pointers
        self._rating_lookup: Dict[Tuple[int, int], int] = {}
        self._finalized = False
        # per-rank ingest: when set, the training COO holds only the seq
        # rows in this range (the id maps stay GLOBAL: seq assignment is
        # first-seen over the whole file, so every rank agrees on ids)
        self.local_user_rows: Optional[slice] = None

    # -- id remap ----------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.user2seq)

    @property
    def m(self) -> int:
        return len(self.movie2seq)

    def input_rating_class(self, v: int) -> int:
        """ratings.hh:191-197."""
        if not self.binary:
            return v
        return 1 if v >= self.rating_threshold else 0

    def test_hit(self, v: int) -> bool:
        """ratings.hh:183-189."""
        if self.binary:
            return v >= 1
        return v >= self.rating_threshold

    def _map_ids(self, uid: int, mid: int, create: bool) -> Optional[Tuple[int, int]]:
        un = self.user2seq.get(uid)
        mn = self.movie2seq.get(mid)
        if un is None:
            if not create or len(self.user2seq) >= self.max_n:
                return None
            un = len(self.user2seq)
            self.user2seq[uid] = un
            self.seq2user[un] = uid
        if mn is None:
            if not create or len(self.movie2seq) >= self.max_m:
                return None
            mn = len(self.movie2seq)
            self.movie2seq[mid] = mn
            self.seq2movie[mn] = mid
        return un, mn

    # -- ingest ------------------------------------------------------------
    def read_generic(self, path: str, cmap: Optional[CountMap],
                     user_rows=None) -> None:
        """ratings.cc:63-119. cmap None -> training store; else fill cmap.

        Note reference semantics: test/validation rows also create new ids
        when capacity remains (add_user/add_movie called for unseen ids).
        The first (training) read takes a fully vectorized path — the
        per-row loop would not scale to Netflix/EchoNest row counts.

        `user_rows` (training read only): a slice over SEQ user ids, or a
        callable (actual_n -> slice); only training rows whose user falls
        in the range are materialized (per-rank ingest, see
        parallel.distributed.host_user_rows). The external<->seq id maps
        still cover the full file, so id assignment is identical on every
        rank.
        """
        data = _parse_tsv(path)
        if cmap is None and self._ingest_fast(data, user_rows):
            return
        self._as_lists()
        for uid, mid, rating in data:
            uid, mid, rating = int(uid), int(mid), int(rating)
            # capacity check precedes the rating-class filter (ratings.cc:80-87)
            if ((uid not in self.user2seq and self.n >= self.max_n) or
                    (mid not in self.movie2seq and self.m >= self.max_m)):
                continue
            if self.input_rating_class(rating) == 0:
                continue
            un, mn = self._map_ids(uid, mid, create=True)
            y = 1 if self.binary else rating
            if cmap is None:
                self._u.append(un)
                self._i.append(mn)
                self._y.append(y)
            else:
                cmap[(un, mn)] = y
        if cmap is None and user_rows is not None:
            self._restrict_users(user_rows)

    def _restrict_users(self, user_rows) -> None:
        """Drop training rows outside this rank's seq-id range (the id
        maps are untouched: they must stay global)."""
        rows = user_rows(self.n) if callable(user_rows) else user_rows
        u = np.asarray(self._u, dtype=np.int64)
        keep = (u >= rows.start) & (u < rows.stop)
        self._u = u[keep]
        self._i = np.asarray(self._i, dtype=np.int64)[keep]
        self._y = np.asarray(self._y, dtype=np.int64)[keep]
        self.local_user_rows = rows

    def _ingest_fast(self, data: np.ndarray, user_rows=None) -> bool:
        """Take the vectorized path for a first training ingest of more
        than 10,000 rows when the capacity caps cannot bind: the caps
        couple user/item minting row by row (a row dropped for one side's
        capacity does not mint the other side's id, ratings.cc:80-84), so
        only then is the result the scalar path's. Returns whether it
        ingested."""
        if self.user2seq or data.shape[0] <= 10000:
            return False
        y_col = data[:, 2]
        live = (y_col >= self.rating_threshold) if self.binary \
            else (y_col > 0)
        if (np.unique(data[live, 0]).size <= self.max_n and
                np.unique(data[live, 1]).size <= self.max_m):
            self._ingest_vectorized(data, user_rows)
            return True
        return False

    def _as_lists(self) -> None:
        # the scalar paths append; a vectorized ingest left ndarrays
        if isinstance(self._u, np.ndarray):
            self._u, self._i, self._y = (self._u.tolist(), self._i.tolist(),
                                         self._y.tolist())

    def _ingest_vectorized(self, data: np.ndarray, user_rows=None) -> None:
        """First-seen-order remap + filters, NumPy-vectorized. Matches the
        scalar path exactly: the rating-class filter runs first, then ids
        are minted in row order until capacity, and rows referencing
        unminted ids are dropped (ratings.cc:80-101)."""
        uid, mid, y = data[:, 0], data[:, 1], data[:, 2]
        if self.binary:
            keep = y >= self.rating_threshold
            uid, mid, y = uid[keep], mid[keep], np.ones(keep.sum(), np.int64)
        else:
            keep = y > 0
            uid, mid, y = uid[keep], mid[keep], y[keep]

        def first_seen_remap(ids, cap):
            # seq id = order of first occurrence, capped at `cap`
            uniq, first = np.unique(ids, return_index=True)
            uniq_fs = uniq[np.argsort(first, kind="stable")][:cap]
            ext2seq = {int(e): k for k, e in enumerate(uniq_fs)}
            # vector map ids -> seq via sorted lookup table
            sorter = np.argsort(uniq_fs, kind="stable")
            lut_sorted = uniq_fs[sorter]     # values ascending
            # seq id of the value at sorted position p is sorter[p]
            pos = np.searchsorted(lut_sorted, ids)
            pos_c = np.clip(pos, 0, max(lut_sorted.size - 1, 0))
            valid = lut_sorted.size > 0
            valid = (lut_sorted[pos_c] == ids) if valid else                 np.zeros(ids.shape, bool)
            seq = np.where(valid, sorter[pos_c], -1)
            return ext2seq, seq, valid

        u_ext2seq, u_seq, u_ok = first_seen_remap(uid, self.max_n)
        m_ext2seq, m_seq, m_ok = first_seen_remap(mid, self.max_m)
        keep = u_ok & m_ok
        if user_rows is not None:
            # per-rank ingest: the remap above is global (computed from
            # the full column), only the materialized COO is sliced
            rows = (user_rows(len(u_ext2seq)) if callable(user_rows)
                    else user_rows)
            keep = keep & (u_seq >= rows.start) & (u_seq < rows.stop)
            self.local_user_rows = rows
        self.user2seq = u_ext2seq
        self.seq2user = {v: k for k, v in u_ext2seq.items()}
        self.movie2seq = m_ext2seq
        self.seq2movie = {v: k for k, v in m_ext2seq.items()}
        # keep ndarrays (a Python list of np.int64 objects costs ~30x the
        # memory at NYT/EchoNest row counts); finalize() accepts both
        self._u = u_seq[keep]
        self._i = m_seq[keep]
        self._y = y[keep]

    def add_training(self, u_ext: Iterable[int], i_ext: Iterable[int],
                     y: Iterable[int]) -> None:
        """Programmatic ingest (synthetic data, tests, in-memory catalogs).
        A first ingest of more than 10,000 rows takes the vectorized path
        where its result is the per-row loop's (`_ingest_fast`), so a
        45M-nonzero catalog ingests in seconds."""
        u_ext, i_ext, y = (np.asarray(v) for v in (u_ext, i_ext, y))
        if u_ext.size > 10000:
            data = np.stack([u_ext, i_ext, y], axis=1).astype(np.int64)
            if self._ingest_fast(data):
                return
        self._as_lists()
        for a, b, c in zip(u_ext.tolist(), i_ext.tolist(), y.tolist()):
            a, b, c = int(a), int(b), int(c)
            if ((a not in self.user2seq and self.n >= self.max_n) or
                    (b not in self.movie2seq and self.m >= self.max_m)):
                continue
            if self.input_rating_class(c) == 0:
                continue
            un, mn = self._map_ids(a, b, create=True)
            self._u.append(un)
            self._i.append(mn)
            self._y.append(1 if self.binary else c)

    def finalize(self) -> None:
        """Freeze training COO in user-major (user, item) sorted order.

        Counts saturate at 255: the reference stores ratings as uint8
        (yval_t, env.hh:20), so counts above 255 are not representable
        there either — it silently wraps mod 256 (an overflow artifact);
        we saturate instead, the deliberate deviation. Real datasets
        (ratings 1-5, click counts) never reach the cap; it only matters
        for heavy-tailed synthetic counts, and saturation keeps the COO
        and the uint8 dense sweep path numerically identical."""
        u = np.asarray(self._u, dtype=np.int32)
        i = np.asarray(self._i, dtype=np.int32)
        y = np.minimum(np.asarray(self._y, dtype=np.int32), 255)
        order = np.lexsort((i, u))
        self.coo_u, self.coo_i, self.coo_y = u[order], i[order], y[order]
        n = max(self.n, 1)
        counts = np.bincount(self.coo_u, minlength=n)
        self.row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self._finalized = True

    # -- queries (reference ratings.hh:153-181) ----------------------------
    @property
    def nratings(self) -> int:
        return int(self.coo_y.size if self._finalized else len(self._y))

    def r(self, n: int, m: int) -> int:
        """O(log deg) CSR lookup (reference uses a per-user hashmap,
        ratings.hh:153-165)."""
        s, e = self.row_ptr[n], self.row_ptr[n + 1]
        j = np.searchsorted(self.coo_i[s:e], m)
        if j < e - s and self.coo_i[s + j] == m:
            return int(self.coo_y[s + j])
        return 0

    def items_of_user(self, n: int) -> np.ndarray:
        s, e = self.row_ptr[n], self.row_ptr[n + 1]
        return self.coo_i[s:e]

    def user_degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int64)

    def item_degrees(self) -> np.ndarray:
        return np.bincount(self.coo_i, minlength=self.m).astype(np.int64)

    # -- marginals (ratings.cc:217-271) ------------------------------------
    def write_marginal_distributions(self, outdir: str) -> None:
        os.makedirs(outdir, exist_ok=True)
        deg_u = self.user_degrees()
        sum_u = np.zeros(self.n, np.int64)
        np.add.at(sum_u, self.coo_u, self.coo_y)
        with open(os.path.join(outdir, "byusers.tsv"), "w") as f:
            for s in range(self.n):
                if deg_u[s] == 0:
                    continue
                f.write(f"{s}\t{self.seq2user[s]}\t{deg_u[s]}\t{sum_u[s]}\n")
        deg_i = self.item_degrees()
        sum_i = np.zeros(self.m, np.int64)
        np.add.at(sum_i, self.coo_i, self.coo_y)
        with open(os.path.join(outdir, "byitems.tsv"), "w") as f:
            for s in range(self.m):
                if deg_i[s] == 0:
                    continue
                f.write(f"{s}\t{self.seq2movie[s]}\t{deg_i[s]}\t{sum_i[s]}\n")

    # -- test users (ratings.cc:273-292) -----------------------------------
    def read_test_users(self, path: str) -> np.ndarray:
        seqs = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                s = self.user2seq.get(int(line))
                if s is not None:
                    seqs.append(s)
        return np.unique(np.asarray(seqs, dtype=np.int32))


def load_dataset(datdir: str, max_n: int, max_m: int, binary: bool,
                 rating_threshold: int, user_rows=None
                 ) -> Tuple[RatingsStore, CountMap, CountMap]:
    """Reference main-flow load: train.tsv, then validation.tsv/test.tsv maps.

    Order matters for ID assignment parity: training first
    (Ratings::read, main.cc:246), then validation, then test
    (load_validation_and_test_sets, hgaprec.cc:110-152).

    `user_rows` (per-rank ingest): a slice over seq user ids, or a
    callable (actual_n -> slice), typically
    parallel.distributed.host_user_rows. Only this rank's training rows
    are materialized as COO; the id maps and the validation/test maps
    stay global (the likelihood and the stopping rule run in lockstep on
    every rank).
    """
    store = RatingsStore(max_n, max_m, binary, rating_threshold)
    store.read_generic(os.path.join(datdir, "train.tsv"), None,
                       user_rows=user_rows)
    store.finalize()
    # Reference parity: Ratings::read() resets env.n/env.m to the training
    # counts (ratings.cc:34-36), so later validation/test reads cannot mint
    # new ids — unseen users/items there are dropped (ratings.cc:80-84).
    store.max_n = store.n
    store.max_m = store.m
    validation: CountMap = {}
    test: CountMap = {}
    store.read_generic(os.path.join(datdir, "validation.tsv"), validation)
    store.read_generic(os.path.join(datdir, "test.tsv"), test)
    return store, validation, test


def leave_one_out_map(test: CountMap) -> Dict[int, int]:
    """hgaprec.cc:138-145: keep the last test item seen per user."""
    out: Dict[int, int] = {}
    for (n, m) in test.keys():
        out[n] = m
    return out


def validation_users_of_movie(validation: CountMap) -> Dict[int, int]:
    """hgaprec.cc:123-127: movie -> count of validation users."""
    out: Dict[int, int] = {}
    for (_, m) in validation.keys():
        out[m] = out.get(m, 0) + 1
    return out
