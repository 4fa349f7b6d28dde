"""Find what `BENCHMARK.json` names: the cell, its configuration, its
traffic mix, its limits, its metrics, and the plug-in modules (generators,
references, metric readers), each a file of its own under this directory.

  configs/<config>.json    the configuration as run (BENCHMARK.json's `file`)
  traffic/<traffic>.json   the run's flags: sweep, precision, report cadence
  limits/<cell>.json       the limits of the cell's compared numbers
  gen/<generator>.py       draw(cfg, gen, device) -> (keys, counts)
  refs/<reference>.py      the plain reference of one iteration
  metrics/<metric>.py      read(ctx) -> value or None, one per metric

The data files (BENCHMARK.json, configurations, traffic mixes, limits)
are read under a checkout's root, by default this one's; the plug-in
modules are this directory's own.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DIR = os.path.basename(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, _named(manifest["configs"], name,
                                           "config")["file"]))


def traffic(name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, DIR, "traffic", f"{name}.json"))


def limits(cell: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, DIR, "limits", f"{cell}.json"))


def metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those with no `workloads` key and those that list it."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [e for e in group if cell in e.get("workloads", [cell])]


def module(kind: str, name: str):
    """The plug-in `<kind>/<name>.py`, loaded by its path."""
    key = f"hpfbench.{kind}.{name}".replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(HERE, kind, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]
