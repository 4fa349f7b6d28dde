"""The cell's training COO, made on the device from the seed.

The configuration's generator (gen/<name>.py) draws distinct (user, item)
keys over the configuration's users and items, every one of which holds
a nonzero. The result is user-sorted (user, item) with no duplicates.
"""

from __future__ import annotations

import dataclasses

import torch

from hpfbench import manifest


@dataclasses.dataclass
class Coo:
    u: torch.Tensor      # int32 [nnz], ascending
    i: torch.Tensor      # int32 [nnz], ascending within a user
    y: torch.Tensor      # float32 [nnz]
    n: int               # users present
    m: int               # items present

    @property
    def nnz(self) -> int:
        return int(self.u.shape[0])

    def to(self, device) -> "Coo":
        return Coo(self.u.to(device), self.i.to(device), self.y.to(device),
                   self.n, self.m)


def make_coo(cfg: dict, gen: torch.Generator, device) -> Coo:
    key, y = manifest.module("gen", cfg["generator"]).draw(cfg, gen, device)
    m = cfg["items"]
    return Coo((key // m).to(torch.int32), (key % m).to(torch.int32), y,
               cfg["users"], m)
