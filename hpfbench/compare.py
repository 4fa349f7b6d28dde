"""The comparison that decides `correct`.

After each of the first iterations the program's state is held to the
plain reference's, leaf by leaf and element by element:

  * shape, rate and E (positive by construction): the relative gap
    |program - reference| / |reference|;
  * Elog: the absolute gap, which is the relative gap of exp(Elog), the
    factor that the next sweep multiplies by.

An iteration's number is its worst gap over every element of every leaf;
each has a limit of its own (limits/<cell>.json). The reference runs in
float64, so a number is the program's whole distance from exact.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

FLOOR = 1e-30


def leaf_gap(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst gap of one leaf (`want` in float64)."""
    # to the device first, widened there: the host would widen it alone
    got = got.to(want.device).to(torch.float64)
    diff = (got - want).abs()
    if not name.endswith("elog"):
        diff = diff / want.abs().clamp_min(FLOOR)
    if not bool(torch.isfinite(diff).all()):
        return sys.float_info.max      # a number the result line can carry
    return float(diff.max()) if diff.numel() else 0.0


def state_gaps(got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Leaf name -> worst gap, over the reference's leaves."""
    return {name: leaf_gap(name, got[name], w) for name, w in want.items()}


def step_name(step: int) -> str:
    return f"step{step}_gap"


# the planted fault "altered": the share by which one element of the new
# theta shape is altered where it is produced, by the precision a cell
# states; each reads at least ten times the program's sound readings at
# that precision (PERF.md, 2.1)
ALTERED = {"highest": 0.01, "default": 0.25}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, failed names): every number at or under its limit."""
    failed = [k for k, v in numbers.items() if not v <= limits[k]]
    return not failed, failed
