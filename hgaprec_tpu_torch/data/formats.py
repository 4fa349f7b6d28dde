"""Baseline-bridge file formats: exporters and factor importers.

The port's copy of `hgaprec_tpu/data/formats.py` (NumPy only).

Re-implements the reference's export/import surface so foreign factors
(graphchi ALS/WALS/CLIMF/SGD/PMF/NMF, lda-c, vowpal-wabbit LDA, CTR,
libNMF) can be scored by the native eval pipeline:

  * write_lda_training_matrix  (hgaprec.cc:274-311): "deg item:y ..." rows
  * write_vwlda_training_matrix (671-707): "| item:y ..." rows
  * write_nmf_training_matrix   (710-761): dense count dump with nrows/m
    header (the reference's dense export is reproduced for compatibility,
    not as a pattern)
  * write_chi_training_matrix   (313-416): MatrixMarket coordinate files
    chifull/chitrain/chivalidation.tsv, WALS confidence 1 + y*C encoding
  * mm_load_rowmajor            (matrix.hh:1268-1310): 3 header lines then
    whitespace values filling row-major
  * load_lda_factors            (763-796): gamma row-normalized, beta
    exp()'d (lda-c stores log probs)
  * load_vwlda_factors          (798-831): vw --readable_model layout
    (11 header rows, leading id column, transposed), both row-normalized
  * load_ctr_factors            (418-476): final-U.dat/final-V.dat + id
    map CSVs
  * nmf output loader           (matrix.hh:1370-1423 semantics)
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from hgaprec_tpu_torch.data.ratings import CountMap, RatingsStore


def _nonempty_users(store: RatingsStore) -> np.ndarray:
    return np.nonzero(store.user_degrees() > 0)[0]


def write_lda_training_matrix(store: RatingsStore, path: str) -> int:
    x = 0
    with open(path, "w") as f:
        for n in _nonempty_users(store):
            items = store.items_of_user(int(n))
            x += 1
            parts = [f"{items.size} "]
            parts += [f" {int(m)}:{store.r(int(n), int(m))}" for m in items]
            f.write("".join(parts) + "\n")
    return x


def write_vwlda_training_matrix(store: RatingsStore, path: str) -> int:
    x = 0
    with open(path, "w") as f:
        for n in _nonempty_users(store):
            items = store.items_of_user(int(n))
            x += 1
            parts = ["|"]
            parts += [f" {int(m)}:{store.r(int(n), int(m))}" for m in items]
            f.write("".join(parts) + "\n")
    return x


def write_nmf_training_matrix(store: RatingsStore, path: str) -> int:
    users = _nonempty_users(store)
    dense = np.zeros((store.n, store.m), np.int64)
    dense[store.coo_u, store.coo_i] = store.coo_y
    with open(path, "w") as f:
        f.write(f"{users.size}\n{store.m}\n")
        for n in users:
            f.write("\t".join(str(v) for v in dense[n]) + "\t\n")
    return users.size


def write_chi_training_matrix(store: RatingsStore, validation: CountMap,
                              outdir: str, *, wals: bool = False,
                              wals_c: float = 10.0):
    """MatrixMarket coordinate exports (hgaprec.cc:313-416).

    Returns (minval, maxval): the raw rating range observed while
    writing (training + validation, hgaprec.cc:368-400 incl. the
    minval==maxval -> maxval+1 quirk) — run_chi_nmf passes these to
    graphchi (hgaprec.cc:632-635); the other tools hard-code theirs."""
    header = "%%MatrixMarket matrix coordinate real general\n"
    minval, maxval = 65536, 0   # reference init (hgaprec.cc:32)
    users_t = set()
    items_t = set()
    lines_t = []
    for n in _nonempty_users(store):
        users_t.add(int(n))
        for m in store.items_of_user(int(n)):
            y = store.r(int(n), int(m))
            items_t.add(int(m))
            if wals:
                lines_t.append(f"{n + 1} {m + 1} {int(1 + y * wals_c)} "
                               f"{1 if y > 0 else 0}\n")
            else:
                lines_t.append(f"{n + 1} {m + 1} {y}\n")
            minval, maxval = min(minval, y), max(maxval, y)
    users_v = set()
    items_v = set()
    lines_v = []
    for (n, m), y in sorted(validation.items()):
        users_v.add(n)
        items_v.add(m)
        if wals:
            lines_v.append(f"{n + 1} {m + 1} {int(1 + y * wals_c)} "
                           f"{1 if y > 0 else 0}\n")
        else:
            lines_v.append(f"{n + 1} {m + 1} {y}\n")
        minval, maxval = min(minval, y), max(maxval, y)
    if minval == maxval:
        maxval += 1
    with open(os.path.join(outdir, "chifull.tsv"), "w") as f:
        f.write(header)
        f.write(f"{len(users_t | users_v)}\t{len(items_t | items_v)}\t"
                f"{len(lines_t) + len(lines_v)}\n")
        f.writelines(lines_t)
        f.writelines(lines_v)
    with open(os.path.join(outdir, "chitrain.tsv"), "w") as f:
        f.write(header)
        f.write(f"{len(users_t)}\t{len(items_t)}\t{len(lines_t)}\n")
        f.writelines(lines_t)
    with open(os.path.join(outdir, "chivalidation.tsv"), "w") as f:
        f.write(header)
        f.write(f"{len(users_v)}\t{len(items_v)}\t{len(lines_v)}\n")
        f.writelines(lines_v)
    return minval, maxval


def mm_load_rowmajor(path: str, rows: int, cols: int) -> np.ndarray:
    """matrix.hh:1268-1310: skip 3 header lines, then values row-major."""
    vals = []
    with open(path) as f:
        for li, line in enumerate(f):
            if li < 3:
                continue
            vals.extend(float(v) for v in line.split())
    out = np.zeros(rows * cols)
    take = min(len(vals), rows * cols)
    out[:take] = vals[:take]
    return out.reshape(rows, cols)


def load_dense_table(path: str, rows: int, cols: int, *, skipcols: int = 0,
                     skiprows: int = 0, transpose: bool = False
                     ) -> np.ndarray:
    """matrix.hh D2Array::load semantics: line-per-row numeric table with
    optional leading id columns, header rows, and transposed fill."""
    out = np.zeros((rows, cols))
    with open(path) as f:
        m = 0
        for li, line in enumerate(f):
            if li < skiprows:
                continue
            nums = []
            for tok in line.split():
                try:
                    nums.append(float(tok))
                except ValueError:
                    break
            nums = nums[skipcols:]
            if not nums:
                continue
            if transpose:
                take = min(len(nums), rows)
                out[:take, m] = nums[:take]
                if m >= cols - 1:
                    break
            else:
                take = min(len(nums), cols)
                out[m, :take] = nums[:take]
                if m >= rows - 1:
                    break
            m += 1
    return out


def load_lda_factors(n: int, m: int, k: int, gamma_path: str = "gamma.tsv",
                     beta_path: str = "beta.tsv"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """lda-c output: gamma [n,k] row-normalized; beta [k,m] log-probs
    exponentiated (hgaprec.cc:763-774). Returns (theta [n,k], beta_mt
    [m,k]) ready for the Scorer (prediction_score_lda uses
    theta[n]·beta[:,m], hgaprec.cc:1957-1966)."""
    gamma = load_dense_table(gamma_path, n, k)
    beta = load_dense_table(beta_path, k, m)
    gamma = gamma / np.maximum(gamma.sum(1, keepdims=True), 1e-30)
    beta = np.exp(beta)
    return gamma, beta.T.copy()


def load_vwlda_factors(n: int, m: int, k: int, gamma_path: str,
                       beta_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """vw --lda output (hgaprec.cc:798-815): beta from the readable model
    (11 header rows, 1 id column, transposed fill), both row-normalized."""
    gamma = load_dense_table(gamma_path, n, k)
    beta = load_dense_table(beta_path, k, m, skipcols=1, skiprows=11,
                            transpose=True)
    gamma = gamma / np.maximum(gamma.sum(1, keepdims=True), 1e-30)
    beta = beta / np.maximum(beta.sum(1, keepdims=True), 1e-30)
    return gamma, beta.T.copy()


def load_ctr_factors(n: int, m: int, k: int, directory: str = "."
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[int, int],
                                Dict[int, int]]:
    """CTR output (hgaprec.cc:418-445): final-U.dat/final-V.dat + id maps
    user_map.dat/item_map.dat with 'ext,idx' rows."""
    theta = load_dense_table(os.path.join(directory, "final-U.dat"), n, k)
    beta = load_dense_table(os.path.join(directory, "final-V.dat"), m, k)

    def read_map(path):
        out: Dict[int, int] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    a, b = line.split(",")
                    out[int(a)] = int(b)
        return out

    return (theta, beta,
            read_map(os.path.join(directory, "user_map.dat")),
            read_map(os.path.join(directory, "item_map.dat")))


def nmf_load_factors(n: int, m: int, k: int, theta_path: str = "theta.tsv",
                     beta_path: str = "beta.tsv"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """libNMF output importer (-nmfload; hgaprec.cc:833-862).

    nmf_load semantics (matrix.hh:1370-1423): two header lines skipped,
    then whitespace-separated doubles. theta.tsv fills [n, k] row-major;
    beta.tsv is read 'transposed'. NB: the reference's transpose branch
    indexes md[token][line] against a [m, k] matrix with a tokens==k
    assert — contradictory bounds that only work by accident of heap
    layout; we implement the evident intent, auto-detecting whether the
    beta file is [m, k] or [k, m] and returning [m, k]."""
    theta = load_dense_table(theta_path, n, k, skiprows=2)
    rows = []
    with open(beta_path) as f:
        for li, line in enumerate(f):
            if li < 2:
                continue
            nums = [float(t) for t in line.split()]
            if nums:
                rows.append(nums)
    beta = np.zeros((m, k))
    if rows:
        width = max(len(r) for r in rows)
        arr = np.zeros((len(rows), width))
        for i, r in enumerate(rows):
            arr[i, :len(r)] = r
        if arr.shape[0] == k and width != k:
            arr = arr.T           # [k, m] layout -> [m, k]
        beta[:min(m, arr.shape[0]), :min(k, arr.shape[1])] = \
            arr[:m, :k]
    return theta, beta


def apply_ctr_maps(theta: np.ndarray, beta: np.ndarray,
                   umap: Dict[int, int], imap: Dict[int, int],
                   seq2user: Dict[int, int], seq2movie: Dict[int, int],
                   n: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reorder CTR factor rows into internal seq order.

    The reference scores seq id n through CTR's own row index:
    ctr_theta[user_map[seq2user[n]]] (prediction_score_ctr,
    hgaprec.cc:1893-1926; maps loaded at 418-445). Rows for ids missing
    from the maps score zero (the reference asserts; here a zero row —
    'asking score for nonexistent user' also returns 0 there)."""
    k = theta.shape[1]
    t = np.zeros((n, k))
    b = np.zeros((m, k))
    for seq in range(n):
        idx = umap.get(seq2user.get(seq))
        if idx is not None and 0 <= idx < theta.shape[0]:
            t[seq] = theta[idx]
    for seq in range(m):
        idx = imap.get(seq2movie.get(seq))
        if idx is not None and 0 <= idx < beta.shape[0]:
            b[seq] = beta[idx]
    return t, b


def write_ctr_map_csvs(outdir: str, umap: Dict[int, int],
                       imap: Dict[int, int], seq2user: Dict[int, int],
                       seq2movie: Dict[int, int], n: int, m: int) -> None:
    """user-map.csv / item-map.csv: 'ext,ctr_idx' per seq row
    (hgaprec.cc:456-470)."""
    with open(os.path.join(outdir, "user-map.csv"), "w") as f:
        for seq in range(n):
            ext = seq2user[seq]
            f.write(f"{ext},{umap.get(ext, 0)}\n")
    with open(os.path.join(outdir, "item-map.csv"), "w") as f:
        for seq in range(m):
            ext = seq2movie[seq]
            f.write(f"{ext},{imap.get(ext, 0)}\n")


# external tool command lines (reference shells out via system();
# run_chi_* hgaprec.cc:533-643, run_vwlda 646-669). Roots configurable;
# per-tool arguments reproduce the reference's hard-coded invocations
# (als 533-549, wals 551-568, climf 570-587, biassgd 589-605,
# pmf 607-624, nmf 626-643). biassgd/pmf are defined in the reference
# but unreachable from main.cc — exposed here via -chisgd / -chipmf.
CHI_TOOL_ARGS = {
    "als": "--lambda=0.01 --minval=1 --maxval=5 --max_iter=100",
    "wals": ("--lambda=0.01 --implicitratingtype=1 "
             "--implicitratingweight=1 --implicitratingpercentage=1 "
             "--minval=0 --maxval=1 --max_iter=100"),
    "climf": ("--binary_relevance_thresh=4 --sgd_gamma=1e-6 "
              "--max_iter=500 --sgd_step_dec=0.9999 --sgd_lambda=1e-6"),
    "biassgd": ("--biassgd_lambda=1e-3 --biassgd_gamma=1e-3 "
                "--minval=1 --maxval=5 --max_iter=100"),
    "pmf": ("--minval=1 --maxval=5 --max_iter=100 --pmf_burn_in=5 "
            "--allow_zeros=1 --matrixmarket=true "
            "--pmf_additional_output=1"),
    # nmf's minval/maxval are dataset-dependent in the reference
    # (hgaprec.cc:632-635) — filled in by chi_command
    "nmf": "--minval={minval} --maxval={maxval} --max_iter=500",
}

# tools trained on the full matrix, without a --validation file
CHI_NO_VALIDATION = {"nmf", "pmf"}


def chi_command(tool: str, outdir: str, k: int, *, graphchi_root: str,
                extra: str = "", minval: int = 1, maxval: int = 5) -> str:
    """minval/maxval: the observed rating range from
    write_chi_training_matrix — only the nmf tool uses them
    (hgaprec.cc:632-635); the rest hard-code their bounds."""
    base = "chifull.tsv" if tool == "nmf" else "chitrain.tsv"
    train = os.path.join(outdir, base)
    valid = os.path.join(outdir, "chivalidation.tsv")
    varg = "" if tool in CHI_NO_VALIDATION else f"--validation={valid} "
    targ = CHI_TOOL_ARGS.get(tool, "--max_iter=100")
    if tool == "nmf":
        targ = targ.format(minval=minval, maxval=maxval)
    return (f"cd {outdir}; GRAPHCHI_ROOT={graphchi_root} "
            f"{graphchi_root}/toolkits/collaborative_filtering/{tool} "
            f"--training={train} {varg}"
            f"{targ} --quiet=1 --D={k} {extra}").rstrip()


def vwlda_command(outdir: str, k: int, n: int, m: int, *,
                  vw_binary: str) -> str:
    import math
    b = int(math.log2(max(m, 2)) + 1)
    return (f"{vw_binary} --lda {k} --lda_alpha {1.0 / k} "
            f"--lda_rho {1.0 / k} --lda_D {n} --minibatch 256 "
            f"--power_t 0.5 --initial_t 1 "
            f"{os.path.join(outdir, 'ldatrain.tsv')} -b {b} "
            f"-p {os.path.join(outdir, 'gamma.tsv')} "
            f"--readable_model {os.path.join(outdir, 'beta.tsv')}")
