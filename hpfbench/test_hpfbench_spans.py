"""The benchmark's reading of the port's span record (`spans.py`) and the
three readers on it, on the CPU: with fake snapshots, with a program that
has no recorder (the module absent), and through a whole traced run at a
small size."""

import sys
import time
import types

import pytest

from hpfbench import manifest, run, spans
from hpfbench.test_hpfbench_checks import small_root  # noqa: F401

READERS = ("layout_sort_s", "layout_copy_s", "warmup_s")


def _total(seconds, calls=1):
    return {"calls": calls, "seconds": seconds, "self_seconds": seconds}


def _fake(monkeypatch, totals):
    mod = types.SimpleNamespace(snapshot=lambda: {"totals": totals,
                                                  "records": [],
                                                  "dropped": 0})
    monkeypatch.setitem(sys.modules, spans.RECORDER, mod)


def _read(name):
    return manifest.module("metrics", name).read({})


def test_readers_sum_their_spans(monkeypatch):
    _fake(monkeypatch, {"layout": _total(12.0),
                        "layout.sort": _total(7.5, calls=3),
                        "layout.copy": _total(0.75, calls=17),
                        "multistep.warmup": _total(1.25),
                        "multistep.capture": _total(0.5),
                        "multistep.key": _total(0.001, calls=40)})
    assert spans.totals()["layout.sort"]["calls"] == 3
    assert [_read(n) for n in READERS] == pytest.approx([7.5, 0.75, 1.75])
    assert spans.seconds("layout.sort", "layout.copy") == pytest.approx(8.25)


def test_warmup_reads_either_span(monkeypatch):
    _fake(monkeypatch, {"multistep.capture": _total(0.5)})
    assert _read("warmup_s") == pytest.approx(0.5)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_where_the_span_is_absent(monkeypatch, name):
    # the CPU loop records no warm-up; a layout with no spans, no sorts
    _fake(monkeypatch, {"multistep.key": _total(0.001)})
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    # an entry of None in sys.modules makes the import fail as the
    # module's absence does
    monkeypatch.setitem(sys.modules, spans.RECORDER, None)
    with pytest.raises(ModuleNotFoundError):
        __import__(spans.RECORDER)
    assert spans.totals() == {}
    assert _read(name) is None


def test_the_manifest_reads_the_readers_in_both_cells():
    bench = manifest.load()
    for cell in (w["name"] for w in bench["workloads"]):
        names = {e["name"] for e in manifest.metrics(bench, cell, True)}
        assert set(READERS) <= names
    for e in bench["per_layer"]:
        if e["name"] in READERS:
            assert (e["moves"], e["source"], e["better"]) == \
                ("setup_s", "host_clock", "lower")


@pytest.mark.parametrize("cell", ["echonest-hpf-k100.default"])
def test_traced_run_reads_the_layout_spans(small_root, cell):  # noqa: F811
    """A whole traced run on the CPU at the small size: the layout's
    sorts and copies are read, within `layout_s`; the loop makes no
    warm-up, so `warmup_s` is left out. The record is the process's,
    so it is emptied first, as a run's own process starts empty."""
    from hgaprec_tpu_torch import trace
    trace.reset()
    result = run.execute(cell, 2**31 + 7, 0.05, True, "cpu",
                         root=small_root, t_start=time.perf_counter())
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["layout_sort_s"] > 0 and got["layout_copy_s"] > 0
    assert got["layout_sort_s"] + got["layout_copy_s"] <= got["layout_s"]
    assert "warmup_s" not in got
    assert result["correct"]
