"""What the wide-K configuration brings to the benchmark, on the CPU:

  * `pair_gb`, the item pass's pair-buffer traffic, read from the port's
    `slabs.pair_bytes` note: None without the note or without the
    recorder, 2 x the note's bytes / 1e9 with it, and the same on the
    slab stream the port builds;
  * the manifest gives `echonest-hpf-k300.segment` its configuration,
    its metrics and its own limits file;
  * `calibrate_lockstep.py` prints calibrate.py's numbers on the small
    copy of the configuration."""

import json
import sys
import types

import pytest
import torch

from hpfbench import calibrate, calibrate_lockstep, manifest, spans
from hpfbench.test_hpfbench_checks import small_root  # noqa: F401

CELL = "echonest-hpf-k300.segment"


def _read():
    return manifest.module("metrics", "pair_gb").read({})


def _fake(monkeypatch, notes):
    mod = types.SimpleNamespace(snapshot=lambda: {"totals": {},
                                                  "records": [],
                                                  "dropped": 0,
                                                  "notes": notes})
    monkeypatch.setitem(sys.modules, spans.RECORDER, mod)


def test_pair_gb_reads_none_without_the_note(monkeypatch):
    # the bf16 tail, or a program whose slab stream notes nothing
    _fake(monkeypatch, {"layout.head_items": 512})
    assert _read() is None
    monkeypatch.setitem(sys.modules, spans.RECORDER, None)
    assert _read() is None


def test_pair_gb_reads_the_buffer_written_and_read(monkeypatch):
    _fake(monkeypatch, {"slabs.count": 54, "slabs.pair_rows": 4_208_483,
                        "slabs.pair_bytes": 4_208_483 * 304 * 4})
    assert _read() == pytest.approx(2 * 4_208_483 * 304 * 4 / 1e9)


def test_pair_gb_reads_the_ports_slab_stream():
    from hgaprec_tpu_torch import trace
    from hgaprec_tpu_torch.ops import segment_fused as sf
    gen = torch.Generator().manual_seed(26)
    n, m, nnz, kq = 50, 30, 400, 304
    key = torch.randperm(n * m, generator=gen)[:nnz].sort().values
    u, i = (key // m).int(), (key % m).int()
    by_item = torch.argsort(i * n + u)
    trace.reset()
    got = sf.slab_stream(u, by_item.int(), i[by_item], u[by_item], {}, n,
                         m, kq, slab_bytes=4 * kq * 10)
    assert got.slabs > 1
    assert _read() == pytest.approx(2 * got.pairs * kq * 4 / 1e9)
    trace.reset()


def test_the_manifest_gives_the_cell_its_files_and_metrics():
    bench = manifest.load()
    wl = manifest.workload(bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        ("echonest-hpf-k300", "segment", 1)
    cfg = manifest.config(bench, wl["config"])
    base = manifest.config(bench, "echonest-hpf-k100")
    assert cfg["k"] == 300 and cfg["reduced"] == []
    same = ("dataset", "model", "reference", "priors", "users", "items",
            "generator", "nnz", "user_power", "item_zipf", "counts",
            "layout")
    assert {key: cfg[key] for key in same} == \
        {key: base[key] for key in same}
    # a deployment of its own: the source names the setting that makes it
    # one (hgaprec's echonest preset run with -k 300), the data set's stays
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    assert entry["source"] == cfg["source"] != base["source"]
    assert cfg["dataset_source"] == base["source"]
    names = {e["name"] for e in manifest.metrics(bench, CELL, True)}
    assert names == {"sparse_roofline", "glue_ms", "step_mfu", "idle_share",
                     "layout_s", "layout_sort_s", "layout_copy_s",
                     "warmup_s", "pair_gb"}
    pair = [e for e in bench["per_layer"] if e["name"] == "pair_gb"][0]
    assert (pair["unit"], pair["better"], pair["layer"], pair["moves"]) == \
        ("GB", "lower", "Sparse kernels", "iter_ms")
    assert "echonest-hpf-k100.hybrid-bf16" not in pair["workloads"]
    with open(f"{manifest.HERE}/limits/{CELL}.json") as f:
        assert manifest.limits(CELL) == json.load(f)


def test_lockstep_prints_calibrates_numbers(small_root, capsys):  # noqa: F811
    argv = ["--config", "echonest-hpf-k300", "--traffic", "segment",
            "--seeds", "5", "--control-seeds", "5", "--device", "cpu",
            "--root", small_root]

    def lines(main):
        capsys.readouterr()
        assert main(argv) == 0
        out = [json.loads(line) for line in capsys.readouterr().out.split("\n")
               if line.startswith("{")]
        return {line["kind"] + line.get("precision", ""): line["numbers"]
                for line in out}

    want = lines(calibrate.main)
    assert len(want) == 5
    assert lines(calibrate_lockstep.main) == want
