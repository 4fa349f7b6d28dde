"""The generator on the CPU at a small size: the same seed gives the same
draw, another seed another; the COO is user-sorted, distinct and holds
the configuration's users, items and nonzeros exactly; its items follow
the law that numpy's sequential draw of the same procedure gives."""

import numpy as np
import pytest
import torch

from hpfbench import data, manifest

SMALL = {"generator": "power_law", "users": 5000, "items": 3000,
         "nnz": 50000, "user_power": 3.0, "item_zipf": 1.2,
         "counts": [1, 4]}


def _coo(cfg, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return data.make_coo(cfg, gen, "cpu")


def test_same_seed_same_draw():
    a, b = _coo(SMALL, 2**31 + 5), _coo(SMALL, 2**31 + 5)
    c = _coo(SMALL, 2**31 + 6)
    for x, y in ((a.u, b.u), (a.i, b.i), (a.y, b.y)):
        assert torch.equal(x, y)
    assert (a.n, a.m) == (b.n, b.m)
    assert not torch.equal(a.i, c.i)


@pytest.mark.parametrize("seed", [0, 12345, 2**33 + 7])
def test_coo_holds_the_source_counts(seed):
    coo = _coo(SMALL, seed)
    assert (coo.n, coo.m, coo.nnz) == (SMALL["users"], SMALL["items"],
                                       SMALL["nnz"])
    key = coo.u.long() * coo.m + coo.i.long()
    assert bool((key[1:] > key[:-1]).all())
    assert torch.equal(torch.unique(coo.u), torch.arange(coo.n))
    assert torch.equal(torch.unique(coo.i), torch.arange(coo.m))
    lo, hi = SMALL["counts"]
    assert float(coo.y.min()) >= lo and float(coo.y.max()) <= hi
    assert coo.u.dtype == coo.i.dtype == torch.int32
    assert coo.y.dtype == torch.float32


def test_too_few_nonzeros_to_cover_is_refused():
    with pytest.raises(ValueError):
        _coo({**SMALL, "nnz": SMALL["users"] + SMALL["items"] - 1}, 0)


def test_new_keys_keep_their_draw_order():
    gen = manifest.module("gen", "power_law")
    have = torch.tensor([2, 5, 9])
    key = torch.tensor([7, 5, 1, 7, 9, 3, 1])
    assert gen._new_in_draw_order(key, have).tolist() == [7, 1, 3]


def _numpy_draw(cfg, seed):
    """The same procedure with numpy's laws and a Python set."""
    n, m, nnz = cfg["users"], cfg["items"], cfg["nnz"]
    rng = np.random.default_rng(seed)

    def users(d):
        return np.minimum((n * rng.power(cfg["user_power"], d)).astype(
            np.int64), n - 1)

    def items(d):
        return np.minimum(rng.zipf(cfg["item_zipf"], d) - 1, m - 1)

    have = set((np.arange(n) * m + items(n)).tolist())
    have |= set((users(m) * m + np.arange(m)).tolist())
    while len(have) < nnz:
        for k in (users(4096) * m + items(4096)).tolist():
            have.add(k)
            if len(have) == nnz:
                break
    return np.array(sorted(have)) % m


def test_item_law_matches_numpy():
    """The share of the nonzeros in the 30 items of highest degree, which
    decides the hybrid head's share, as numpy's draw gives it."""
    def head_share(items):
        deg = np.sort(np.bincount(items, minlength=SMALL["items"]))[::-1]
        return deg[:30].sum() / deg.sum()
    got = np.mean([head_share(_coo(SMALL, s).i.numpy()) for s in (1, 2)])
    want = np.mean([head_share(_numpy_draw(SMALL, s)) for s in (1, 2)])
    assert got == pytest.approx(want, rel=0.03)
