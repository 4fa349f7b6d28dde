"""The port's spans: named stretches of host time at its layer boundaries.

    from hgaprec_tpu_torch.trace import span
    with span("layout.sort"):
        order = np.lexsort((u, i))

Each span records its name, its parent (the span open around it on the
same thread) and its start and end on `time.perf_counter_ns`. The
recorder keeps per-name totals (calls, seconds, self seconds: the
duration less what child spans cover) and the individual records up to
`RECORD_CAP`, counting those past it as dropped, so a long run stays
bounded. `note(name, value)` keeps a number the code chose or counted
(the last value under each name). `snapshot()` returns all three;
`reset()` clears them.

While a `torch.profiler` runs, a span also opens
`torch.profiler.record_function(name)`, so it sits on the profiler's
clock, the clock of the device trace, and an idle stretch of the device
can be labelled by the port span the host was in. With no profiler a
span costs two clock reads and an update of the totals.

The rule: a span that may open while a profiled window is timed encloses
no kernel launch. The profiler mirrors a `record_function` that encloses
launches as an annotation on the device's timeline, which a reader of
the device trace would count as device time. Spans that enclose launches
(`layout.*`, `multistep.warmup`, `multistep.capture`, `slabs.build`,
`report.*`) belong to set-up and reports; on the replay path only
`multistep.key` opens, and it launches nothing. Each replay's
`cudaGraphLaunch` is on the profiler's record already.

Names are dotted, the layer first:

  layout            build_device_data, whole (data/device.py)
  layout.select     degrees and the head's top-degree items
  layout.head       the head block or the dense Y scattered on the device
  layout.tail       the tail stream (ops/tail.py::build_tail_stream)
  layout.coo        the dual-sorted COO (data/device.py::sorted_coo)
  layout.sort       each host sort of the layout
  layout.copy       each host-to-device copy of the layout
  multistep.warmup  GraphMultiStep's eager step before a capture
  multistep.capture GraphMultiStep's capture (it begins by synchronizing)
  multistep.key     GraphMultiStep's walk of the storage key, every call
  slabs.build       a slab stream built on a cache miss
                    (ops/segment_fused.py::slab_stream)
  report.loglik     Trainer.report's validation or test likelihood
  report.save       its model save
  report.precision  its precision report
  report.itemrank   its itemrank report
  report.elbo       its training ELBO (-logl)

Notes, under names of the same form, of the last layout built in the
process (a Trainer's `-trace` profile holds its own layout's):

  layout.head_items  the hybrid head's width T (0: no head)
  layout.head_share  the head's share of the nonzeros (0.0 without one)

and of the last slab stream built (ops/segment_fused.py::slab_stream):

  slabs.count       its user slabs
  slabs.pair_rows   the rows of the item pass's pair buffer
  slabs.pair_bytes  the pair buffer's bytes (rows x kq f32)
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

RECORD_CAP = 100_000


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int


class _Stack(threading.local):
    def __init__(self):
        self.open: List["_Span"] = []


class _Span:
    """One opening of a span: what `with recorder.span(name)` enters."""
    __slots__ = ("recorder", "name", "start", "child_ns", "rf")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder = recorder
        self.name = name

    def __enter__(self) -> "_Span":
        self.rf = None
        if _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.child_ns = 0
        self.recorder._stack.open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        rec = self.recorder
        stack = rec._stack.open
        stack.pop()
        dur = end - self.start
        parent = None
        if stack:
            up = stack[-1]
            up.child_ns += dur
            parent = up.name
        rec._lock.acquire()
        try:
            tot = rec._totals.get(self.name)
            if tot is None:
                tot = rec._totals[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child_ns
            if len(rec._records) < rec.cap:
                rec._records.append((self.name, parent, self.start, end))
            else:
                rec._dropped += 1
        finally:
            rec._lock.release()
        if self.rf is not None:
            self.rf.__exit__(*exc)


class Recorder:
    """Spans' per-name totals and their first `cap` records."""

    def __init__(self, cap: int = RECORD_CAP):
        self.cap = cap
        self._stack = _Stack()
        self._lock = threading.Lock()
        self.reset()

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def note(self, name: str, value: float) -> None:
        """Keep `value` under `name`, replacing an earlier one."""
        with self._lock:
            self._notes[name] = value

    def reset(self) -> None:
        """Forget every finished span (open ones still record on exit)
        and every note."""
        with self._lock:
            self._totals: Dict[str, List[int]] = {}
            self._records: List[tuple] = []
            self._dropped = 0
            self._notes: Dict[str, float] = {}

    def snapshot(self) -> dict:
        """{"totals": {name: {"calls", "seconds", "self_seconds"}},
        "records": [Record, ...] in the order the spans ended,
        "dropped": records past the cap, "notes": {name: value}}."""
        with self._lock:
            return {"totals": {name: {"calls": c, "seconds": ns * 1e-9,
                                      "self_seconds": own * 1e-9}
                               for name, (c, ns, own) in
                               self._totals.items()},
                    "records": [Record(*r) for r in self._records],
                    "dropped": self._dropped,
                    "notes": dict(self._notes)}


# the process's recorder, which every span of the port records into
RECORDER = Recorder()
span = RECORDER.span
note = RECORDER.note
snapshot = RECORDER.snapshot
reset = RECORDER.reset
