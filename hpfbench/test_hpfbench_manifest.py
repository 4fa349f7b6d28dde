"""Everything BENCHMARK.json names is found by name, and the manifest
keeps the benchmark contract's shape."""

import json
import os
import re

import pytest

from hpfbench import manifest, run

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "hpfbench/run.py"]
    assert BENCH["paths"] == ["hpfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    names = [e["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for e in BENCH[group]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hpfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for group in ("end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert set(e2e) == {"iter_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert 0.01 <= e2e["iter_ms"]["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert e["moves"] in e2e
        assert set(e["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    wl = manifest.workload(BENCH, cell)
    cfg = manifest.config(BENCH, wl["config"])
    entry = [c for c in BENCH["configs"] if c["name"] == wl["config"]][0]
    assert cfg["name"] == wl["config"]
    assert cfg["reduced"] == entry["reduced"]
    assert callable(manifest.module("gen", cfg["generator"]).draw)
    assert callable(manifest.module("refs", cfg["reference"]).hpf_step)
    traffic = manifest.traffic(wl["traffic"])
    assert traffic["rfreq"] == 10
    limits = manifest.limits(cell)
    assert set(limits) == {f"step{s}_gap"
                           for s in range(1, run.CHECKED_STEPS + 1)}
    for trace in (False, True):
        for e in manifest.metrics(BENCH, cell, trace):
            if trace:
                assert callable(manifest.module("metrics", e["name"]).read)
    assert {e["name"] for e in manifest.metrics(BENCH, cell, False)} == \
        {"iter_ms", "setup_s"}
    assert manifest.metrics(BENCH, cell, True)


def test_every_config_is_used_and_stands_alone():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        with open(os.path.join(manifest.ROOT, f)) as fh:
            assert json.load(fh)["reduced"] == []
