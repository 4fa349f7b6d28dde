"""The port's own span record, as the benchmark's readers take it: the
per-name totals and the notes of `hgaprec_tpu_torch.trace.snapshot()`,
which the run's set-up (the layout build, the multi-step's warm-up and
capture) and its window have filled by the time the metrics are read.

A program without the recorder (the module is absent) reads as no span
at all, so each reader returns None there and its metric is left out.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

RECORDER = "hgaprec_tpu_torch.trace"


def _snapshot() -> dict:
    try:
        mod = importlib.import_module(RECORDER)
    except ModuleNotFoundError as exc:
        if exc.name != RECORDER:
            raise
        return {}
    return mod.snapshot()


def totals() -> Dict[str, dict]:
    """{span name: {"calls", "seconds", "self_seconds"}}; empty for a
    program that records no spans."""
    return _snapshot().get("totals", {})


def notes() -> Dict[str, float]:
    """{note name: value}, the last value noted under each name (the
    layout's `layout.head_items` and `layout.head_share`); empty for a
    program that notes nothing."""
    return _snapshot().get("notes", {})


def seconds(*names: str) -> Optional[float]:
    """The seconds of every span of these names, summed; None where none
    of them was recorded."""
    got = totals()
    found = [got[n]["seconds"] for n in names if n in got]
    return sum(found) if found else None
