"""The port's span recorder (`hgaprec_tpu_torch/trace.py`) and the spans
it opens at the layer boundaries, on the CPU:

  * the recorder: nesting and parents, self time, the record cap and the
    count past it, notes, `reset()`;
  * the profiler: no `record_function` opens while no profiler runs;
    under a CPU `torch.profiler` the spans are host events under their
    own names;
  * the layout build's sorts and copies, the multi-step's warm-up,
    capture and key walk (with the tests' fake graph), the slab streams'
    builds, and the report's phases and the layout's notes in a
    `-trace` profile.
"""

import glob
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from conftest import make_synthetic
from hgaprec_tpu_torch import trace
from hgaprec_tpu_torch.config import ModelConfig as TCfg
from hgaprec_tpu_torch.config import RunConfig as TRun
from hgaprec_tpu_torch.data.device import build_device_data
from hgaprec_tpu_torch.models.engine import LAYOUT_KEY, Trainer
from hgaprec_tpu_torch.models.step import make_multi_step
from hgaprec_tpu_torch.ops import segment_fused as sf
from hgaprec_tpu_torch.ops import tail_fused as tf
from test_torch_multistep import LAYOUTS, _case, _replaying, _state
from test_torch_step import port_store


@pytest.fixture
def spans():
    """The process's recorder, emptied before and after the test."""
    trace.reset()
    yield trace.RECORDER
    trace.reset()


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(it))


def _calls(snap, name):
    return snap["totals"].get(name, {}).get("calls", 0)


def test_nesting_parents_and_self_time(monkeypatch):
    rec = trace.Recorder()
    # outer opens at 10, inner 20-50, a second inner 60-70, outer ends 100
    _fake_clock(monkeypatch, [10, 20, 50, 60, 70, 100])
    with rec.span("outer"):
        with rec.span("inner"):
            pass
        with rec.span("inner"):
            pass
    snap = rec.snapshot()
    assert snap["records"] == [("inner", "outer", 20, 50),
                               ("inner", "outer", 60, 70),
                               ("outer", None, 10, 100)]
    assert snap["records"][0].parent == "outer"
    tot = snap["totals"]
    assert tot["outer"]["calls"] == 1 and tot["inner"]["calls"] == 2
    assert tot["outer"]["seconds"] == pytest.approx(90e-9)
    assert tot["outer"]["self_seconds"] == pytest.approx(50e-9)
    assert tot["inner"]["seconds"] == pytest.approx(40e-9)
    assert tot["inner"]["self_seconds"] == pytest.approx(40e-9)
    assert snap["dropped"] == 0


def test_a_span_records_on_an_exception():
    rec = trace.Recorder()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("inner"):
                raise ValueError
    assert [r.name for r in rec.snapshot()["records"]] == ["inner", "outer"]
    with rec.span("after"):
        pass
    assert rec.snapshot()["records"][-1].parent is None


@pytest.mark.parametrize("cap", [0, 3])
def test_record_cap_counts_the_overflow(cap):
    rec = trace.Recorder(cap=cap)
    for _ in range(5):
        with rec.span("a"):
            pass
    snap = rec.snapshot()
    assert len(snap["records"]) == cap and snap["dropped"] == 5 - cap
    # the totals count every span, past the cap too
    assert snap["totals"]["a"]["calls"] == 5


def test_reset_clears_totals_records_and_overflow():
    rec = trace.Recorder(cap=1)
    for name in ("a", "b"):
        with rec.span(name):
            pass
    rec.note("n", 1)
    rec.reset()
    assert rec.snapshot() == {"totals": {}, "records": [], "dropped": 0,
                              "notes": {}}
    # a span open across the reset still records when it closes
    with rec.span("open"):
        rec.reset()
    assert list(rec.snapshot()["totals"]) == ["open"]


def test_note_keeps_the_last_value_beside_the_spans():
    rec = trace.Recorder()
    rec.note("layout.head_items", 4096)
    with rec.span("layout"):
        rec.note("layout.head_items", 128)
    rec.note("layout.head_share", 0.5)
    snap = rec.snapshot()
    assert snap["notes"] == {"layout.head_items": 128,
                             "layout.head_share": 0.5}
    assert snap["totals"]["layout"]["calls"] == 1
    snap["notes"]["x"] = 1              # a copy: the recorder keeps its own
    assert "x" not in rec.snapshot()["notes"]
    assert trace.note == trace.RECORDER.note


def test_spans_of_two_threads_keep_their_own_parents():
    rec = trace.Recorder()
    inside = threading.Event()
    done = threading.Event()

    def other():
        with rec.span("other"):
            inside.set()
            done.wait(5)

    th = threading.Thread(target=other)
    with rec.span("main"):
        th.start()
        assert inside.wait(5)
        with rec.span("child"):
            pass
        done.set()
        th.join(5)
    assert not th.is_alive()
    parents = {r.name: r.parent for r in rec.snapshot()["records"]}
    assert parents == {"child": "main", "other": None, "main": None}


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    real = trace.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(trace, "record_function", counting)
    rec = trace.Recorder()
    with rec.span("quiet"):
        pass
    assert opened == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("loud"):
            with rec.span("loud.inner"):
                torch.ones(4).sum()
    assert opened == ["loud", "loud.inner"]
    names = {ev.name for ev in prof.events()}
    assert {"loud", "loud.inner"} <= names
    assert rec.snapshot()["totals"]["loud"]["calls"] == 1


def _coo(rng, n=60, m=40, nnz=500):
    flat = np.unique(rng.choice(n * m, nnz, replace=False))
    u, i = (flat // m).astype(np.int32), (flat % m).astype(np.int32)
    y = rng.integers(1, 5, u.size).astype(np.float32)
    return types.SimpleNamespace(n=n, m=m, coo_u=u, coo_i=i, coo_y=y)


@pytest.mark.parametrize("layout,sorts,heads,tails", [
    ("hybrid", ["layout.select", "layout.tail", "layout.coo"], 1, 1),
    ("coo", ["layout.coo"], 0, 0),
    ("dense", ["layout.coo"], 1, 0)])
def test_layout_spans_its_sorts_and_copies(rng, spans, layout, sorts, heads,
                                           tails):
    kw = {"hybrid": dict(hybrid_head_items=8, dense_limit_bytes=64),
          "coo": dict(dense_limit_bytes=64), "dense": {}}[layout]
    data = build_device_data(_coo(rng), "cpu", pad_multiple=64, **kw)
    assert (data.head_dense_y is not None) == (layout == "hybrid")
    assert (data.dense_y is not None) == (layout == "dense")
    snap = spans.snapshot()
    parent = {r.name: r.parent for r in snap["records"]
              if not r.name.startswith("layout.sort")
              and r.name != "layout.copy"}
    assert parent["layout"] is None
    assert parent["layout.select"] == parent["layout.coo"] == "layout"
    assert [r.parent for r in snap["records"]
            if r.name == "layout.sort"] == sorts
    assert _calls(snap, "layout.head") == heads
    assert _calls(snap, "layout.tail") == tails
    # the COO's six fields; a head's three scatter inputs and its items;
    # a dense Y's three; the tail's seven
    copies = 6 + 4 * (layout == "hybrid") + 3 * (layout == "dense") + \
        7 * tails
    assert _calls(snap, "layout.copy") == copies
    assert {r.parent for r in snap["records"] if r.name == "layout.copy"} \
        <= {"layout.head", "layout.tail", "layout.coo"}
    tot = snap["totals"]
    assert tot["layout"]["calls"] == 1
    assert tot["layout"]["seconds"] >= tot["layout.sort"]["seconds"] + \
        tot["layout.copy"]["seconds"]


def test_multistep_spans_warmup_capture_and_key(rng, spans):
    _, cfg, data, _, _ = _case(rng, "segment-chunked", "hpf")
    runner = _replaying(cfg)
    state = runner(_state(cfg), data, 3)
    runner(state, data, 2)
    runner(state, data, 0)            # no step: no walk of the key
    snap = spans.snapshot()
    assert [_calls(snap, f"multistep.{p}")
            for p in ("warmup", "capture", "key")] == [1, 1, 2]
    assert {r.parent for r in snap["records"]
            if r.name.startswith("multistep.")} == {None}


def test_the_loop_records_no_multistep_span(rng, spans):
    _, cfg, data, _, _ = _case(rng, "dense", "hpf")
    make_multi_step(cfg)(_state(cfg), data, 2)
    assert not [n for n in spans.snapshot()["totals"]
                if n.startswith("multistep.")]


def test_slab_stream_spans_a_miss_and_not_a_hit(rng, spans):
    _, cfg, data, _, _ = _case(rng, "hybrid", "hpf")
    n, m = cfg.n, cfg.m
    first = sf.data_slabs(data, n, m, 8, 150)
    assert _calls(spans.snapshot(), "slabs.build") == 1
    assert sf.data_slabs(data, n, m, 8, 150) is first
    assert _calls(spans.snapshot(), "slabs.build") == 1
    tf.tail_slabs(data.tail, n, m, 8, 150, 0)
    assert _calls(spans.snapshot(), "slabs.build") == 2


@pytest.mark.parametrize("fill", [0, 4])
def test_slab_stream_notes_its_pair_buffer(rng, spans, fill):
    """A build notes its slabs and the item pass's pair buffer (a row of
    kq f32 a pair); a cache hit notes nothing."""
    _, cfg, data, _, _ = _case(rng, "segment-chunked", "hpf")
    n, m, kq, cache = cfg.n, cfg.m, 12, {}
    args = (data.u_ids, data.item_order, data.i_ids_sorted,
            data.u_ids_by_item, cache, n, m, kq, 150, fill)
    spans.reset()                       # the layout's own notes
    got = sf.slab_stream(*args)
    # fill 4: every item here is too sparse for its pair rows, no slab
    assert got.pairs > 0 and (got.slabs > 1) == (fill == 0)
    assert spans.snapshot()["notes"] == {
        "slabs.count": got.slabs,
        "slabs.pair_rows": got.pair_item.shape[0],
        "slabs.pair_bytes": got.pair_item.shape[0] * kq * 4}
    spans.reset()
    assert sf.slab_stream(*args) is got
    assert spans.snapshot()["notes"] == {}


def test_report_phases_in_the_trace(tmp_path, spans):
    """A Trainer run under `-trace DIR` (the fake graph standing in for
    the card's): the report's phases and the multi-step's spans are host
    events of the profile, under their own names, and in the record."""
    js, val, test = make_synthetic(np.random.default_rng(5), n=40, m=30,
                                   density=0.3)
    tr = Trainer(port_store(js), val, test,
                 TCfg(n=js.n, m=js.m, k=3, variant="hpf",
                      **LAYOUTS["hybrid"]),
                 TRun(datdir=str(tmp_path), outdir=str(tmp_path / "o"),
                      rfreq=3, max_iterations=6, seed=1, logl=True,
                      enforce_max_iterations=True,
                      trace_dir=str(tmp_path / "trace")), device="cpu")
    tr.multi_step = _replaying(tr.mcfg)
    tr.run()
    tr.close()
    reports = 3                       # at iterations 0, 3 and 6
    snap = spans.snapshot()
    assert [_calls(snap, f"report.{p}") for p in
            ("loglik", "save", "precision", "itemrank", "elbo")] == \
        [2 * reports, reports, reports, reports, reports]
    assert [_calls(snap, f"multistep.{p}") for p in
            ("warmup", "capture")] == [1, 1]
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"report.loglik", "report.save", "report.precision",
            "report.itemrank", "report.elbo", "multistep.warmup",
            "multistep.capture", "multistep.key"} <= names


def test_trace_profile_holds_the_layout_notes(tmp_path, spans):
    """The `-trace` profile's metadata carries the Trainer's own layout
    figures, the head's width and its share of the nonzeros, even where
    the process built another layout after it."""
    js, val, test = make_synthetic(np.random.default_rng(5), n=40, m=30,
                                   density=0.3)
    ts = port_store(js)
    tr = Trainer(ts, val, test,
                 TCfg(n=js.n, m=js.m, k=3, variant="hpf",
                      **LAYOUTS["hybrid"]),
                 TRun(datdir=str(tmp_path), outdir=str(tmp_path / "o"),
                      rfreq=3, max_iterations=3, seed=1,
                      enforce_max_iterations=True,
                      trace_dir=str(tmp_path / "trace")), device="cpu")
    t = tr.data.head_items.numel()
    share = 1 - tr.data.tail.nnz / ts.coo_u.size
    build_device_data(ts, "cpu", dense_limit_bytes=64)   # no head
    assert spans.snapshot()["notes"]["layout.head_items"] == 0
    tr.run()
    tr.close()
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(files[0]) as f:
        notes = json.load(f)[LAYOUT_KEY]
    assert t > 0 and notes["layout.head_items"] == t
    assert notes["layout.head_share"] == pytest.approx(share)
