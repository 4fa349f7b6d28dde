"""Power-law (user, item) draws at a source's published counts, made on
the device.

Users n U^(1 / user_power) (numpy's `power` law), items Zipf(item_zipf)
minus one, clipped at the last item: the EchoNest-shaped laws of
scripts/bigsparse_scale_check.py:46-64 and chip_smoke.py::power_law_coo,
drawn with a `torch.Generator` instead of numpy. So that the draw holds
the source's users, items and nonzeros exactly:

  1. cover: every user gets one item drawn from the item law, and every
     item one user drawn from the user law;
  2. then pairs are drawn from both laws, in chunks of min(2^24, nnz),
     and each pair not yet held is kept, in the order drawn, until the
     distinct keys number `nnz`.

Counts are uniform in [counts[0], counts[1]].
"""

from __future__ import annotations

import torch

CHUNK = 1 << 24


def zipf_cdf(a: float, m: int, device) -> torch.Tensor:
    """float64 [m - 1]: P(Zipf(a) <= j) for j = 1 .. m - 1."""
    j = torch.arange(1, m, dtype=torch.float64, device=device)
    zeta = torch.special.zeta(torch.tensor(a, dtype=torch.float64),
                              torch.tensor(1.0, dtype=torch.float64))
    return torch.cumsum(j.pow(-a), 0) / zeta.to(device)


def _new_in_draw_order(key: torch.Tensor, have: torch.Tensor) -> torch.Tensor:
    """The keys of `key` that `have` (sorted) does not hold, each once, in
    the order of their first draw."""
    at = torch.searchsorted(have, key).clamp_max(have.numel() - 1)
    key = key[have[at] != key]
    uniq, inv = torch.unique(key, return_inverse=True)
    first = torch.full_like(uniq, key.numel()).scatter_reduce_(
        0, inv, torch.arange(key.numel(), device=key.device), "amin")
    return uniq[first.argsort()]


def draw(cfg: dict, gen: torch.Generator, device):
    """(key, y): `nnz` distinct keys u * items + i, ascending (int64), over
    every user and every item, and their counts (float32)."""
    n, m, nnz = cfg["users"], cfg["items"], cfg["nnz"]
    if not n + m <= nnz <= n * m:
        raise ValueError(f"{nnz} nonzeros cannot cover {n} x {m}")
    cdf = zipf_cdf(cfg["item_zipf"], m, device)

    def users(d):
        u = torch.rand(d, generator=gen, device=device, dtype=torch.float64)
        return (n * u.pow(1.0 / cfg["user_power"])).long().clamp_max(n - 1)

    def items(d):
        q = torch.rand(d, generator=gen, device=device, dtype=torch.float64)
        return torch.searchsorted(cdf, q, right=True)      # in [0, m - 1]

    ar_n = torch.arange(n, device=device)
    ar_m = torch.arange(m, device=device)
    have = torch.unique(torch.cat([ar_n * m + items(n), users(m) * m + ar_m]))
    d = min(CHUNK, nnz)
    while have.numel() < nnz:
        new = _new_in_draw_order(users(d) * m + items(d), have)
        have = torch.cat([have, new[:nnz - have.numel()]]).sort().values
    lo, hi = cfg["counts"]
    y = torch.randint(lo, hi + 1, have.shape, generator=gen, device=device)
    return have, y.to(torch.float32)
