"""Format-specific raw-dataset ingest + heldout split creation.

The port's copy of `hgaprec_tpu/data/readers.py` (NumPy only).

Reference readers (used only in CREATE_TRAIN_TEST_SETS mode,
ratings.cc:11-26):

  * MovieLens TSV `uid \t mid \t rating` (read_movielens, ratings.cc:609-663)
    — we additionally accept the original ml-1m `::`-separated ratings.dat
  * Netflix per-movie files mv_XXXXXXX.txt: "mid:" header then
    "uid,rating,date" rows (read_netflix_movie, ratings.cc:549-607)
  * Mendeley users.dat: per-user ragged "len m1 m2 ..." rows, implicit
    rating 1 (read_mendeley, ratings.cc:465-547)
  * EchoNest/NYT string-keyed triplets "ustr \t istr \t count"
    (read_echonest/read_nyt, ratings.cc:294-463) — string ids densified
    in first-seen order like the reference's _str2id
  * metadata: MovieLens movies.dat `id::title::genres`, Netflix
    movie_titles.txt `id,year,title` (ratings.cc:666-791)

The reference never ships the splitter (it lives in commented-out
scratch.cc); create_train_test_sets() provides it natively with the Env
default ratios (heldout 0.2, validation 0.01 — env.hh:239-240) and a
leave-one-out option for the MSR protocol.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def read_movielens(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TSV or ml-1m ratings.dat (`uid::mid::rating::ts`)."""
    with open(path, "rb") as f:
        head = f.peek(256) if hasattr(f, "peek") else f.read(256)
    if b"::" in head[:256]:
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split("::")
                if len(parts) >= 3:
                    rows.append((int(parts[0]), int(parts[1]),
                                 int(float(parts[2]))))
        arr = np.asarray(rows, np.int64)
    else:
        from hgaprec_tpu_torch.data.ratings import _parse_tsv
        arr = _parse_tsv(path)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def read_netflix_dir(dirpath: str, max_movies: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All mv_*.txt files: 'mid:' header, then 'uid,rating,date' rows."""
    us, ms, ys = [], [], []
    files = sorted(glob.glob(os.path.join(dirpath, "mv_*.txt")))
    if max_movies:
        files = files[:max_movies]
    for path in files:
        with open(path) as f:
            header = f.readline().strip()
            mid = int(header.rstrip(":"))
            for line in f:
                parts = line.strip().split(",")
                if len(parts) >= 2:
                    us.append(int(parts[0]))
                    ms.append(mid)
                    ys.append(int(parts[1]))
    return (np.asarray(us, np.int64), np.asarray(ms, np.int64),
            np.asarray(ys, np.int64))


def read_mendeley(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """users.dat ragged rows 'len m1 m2 ...'; uid = 1-based line number,
    implicit rating 1 (ratings.cc:479-537)."""
    us, ms = [], []
    uid = 1
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ln = int(parts[0])
            items = [int(x) for x in parts[1:1 + ln]]
            us.extend([uid] * len(items))
            ms.extend(items)
            uid += 1
    ys = np.ones(len(us), np.int64)
    return np.asarray(us, np.int64), np.asarray(ms, np.int64), ys


def read_triplets(path: str, str2id: Optional[Dict[str, int]] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             Dict[str, int]]:
    """EchoNest train_triplets.txt / NYT nyt-clicks.tsv: string-keyed
    'ustr \t istr \t count' rows; ids minted first-seen starting at 1
    (one shared namespace, like the reference's _str2id)."""
    str2id = {} if str2id is None else str2id
    us, ms, ys = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            ustr, istr, y = parts[0], parts[1], int(float(parts[2]))
            if ustr not in str2id:
                str2id[ustr] = len(str2id) + 1
            if istr not in str2id:
                str2id[istr] = len(str2id) + 1
            us.append(str2id[ustr])
            ms.append(str2id[istr])
            ys.append(y)
    return (np.asarray(us, np.int64), np.asarray(ms, np.int64),
            np.asarray(ys, np.int64), str2id)


def read_movielens_metadata(path: str) -> Dict[int, Tuple[str, str]]:
    """movies.dat `id::title::genres` -> {ext_id: (title, genres)}."""
    out = {}
    with open(path, encoding="latin-1") as f:
        for line in f:
            parts = line.strip().split("::")
            if len(parts) >= 3:
                out[int(parts[0])] = (parts[1], parts[2])
    return out


def read_netflix_metadata(path: str) -> Dict[int, Tuple[str, str]]:
    """movie_titles.txt `id,year,title` -> {ext_id: (title, year)}."""
    out = {}
    with open(path, encoding="latin-1") as f:
        for line in f:
            parts = line.strip().split(",", 2)
            if len(parts) >= 3:
                out[int(parts[0])] = (parts[2], parts[1])
    return out


def read_mendeley_metadata(path: str) -> Dict[int, Tuple[str, str]]:
    """titles.dat: the 0-based LINE NUMBER is the external item id
    (read_mendeley_metadata, ratings.cc:771-790 — `id++` per line, no
    id column in the file)."""
    out = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for idx, line in enumerate(f):
            out[idx] = (line.strip(), "")
    return out


def read_nyt_metadata(path: str) -> Dict[int, Tuple[str, str]]:
    """nyt-titles.tsv as (title, genre)-shaped metadata for the
    cold-start/explore title chain (genre slot empty)."""
    return {k: (v, "") for k, v in read_nyt_titles(path).items()}


def read_nyt_titles(path: str) -> Dict[int, str]:
    """nyt-titles.tsv pipe-delimited `id|title` -> {ext_id: title}
    (ratings.cc:121-152)."""
    out = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.rstrip("\n").split("|", 1)
            if parts and parts[0].strip().isdigit():
                out[int(parts[0])] = parts[1].strip() if len(parts) > 1 \
                    else ""
    return out


def create_train_test_sets(u: np.ndarray, i: np.ndarray, y: np.ndarray,
                           outdir: str, *, heldout_ratio: float = 0.2,
                           validation_ratio: float = 0.01,
                           leave_one_out: bool = False,
                           seed: int = 0) -> Dict[str, int]:
    """Split raw ratings into the train/validation/test/test_users TSVs
    the training path consumes. Env default ratios (env.hh:239-240).

    leave_one_out: one random test item per user (the MSR protocol that
    gen_msr_csv assumes, hgaprec.cc:138-145)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    nr = u.size
    if leave_one_out:
        test_mask = np.zeros(nr, bool)
        order = rng.permutation(nr)
        seen = set()
        for j in order:
            if u[j] not in seen:
                seen.add(u[j])
                test_mask[j] = True
        rest = ~test_mask
        r = rng.random(nr)
        valid_mask = rest & (r < validation_ratio)
    else:
        r = rng.random(nr)
        test_mask = r < heldout_ratio
        valid_mask = (r >= heldout_ratio) & \
            (r < heldout_ratio + validation_ratio)
    train_mask = ~(test_mask | valid_mask)

    def dump(fname, mask):
        with open(os.path.join(outdir, fname), "w") as f:
            f.write("".join(f"{a}\t{b}\t{c}\n" for a, b, c in
                            zip(u[mask], i[mask], y[mask])))
        return int(mask.sum())

    counts = {
        "train": dump("train.tsv", train_mask),
        "validation": dump("validation.tsv", valid_mask),
        "test": dump("test.tsv", test_mask),
    }
    test_users = np.unique(u[test_mask])
    with open(os.path.join(outdir, "test_users.tsv"), "w") as f:
        f.write("".join(f"{a}\n" for a in test_users))
    counts["test_users"] = test_users.size
    return counts
