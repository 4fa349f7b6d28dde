"""What a traced window held: the device's operations and the host's.

`Trace.from_profiler` reads a `torch.profiler` run (CPU and CUDA
activities) over the window, which the harness marks with a
`record_function` span of its own (`WINDOW`). Device operations are
clipped to that span. The readers of metrics/ take from here:

  * device seconds by operation name (the device's mirrors of the
    harness's own labels left out), and the names of the kernels that
    the program's CUDA sources define (`defined_kernels`), which tell
    its hand-written kernels from the rest;
  * busy time: the union of the device's operations over the window;
  * idle gaps: the stretches with no device operation, each labelled by
    the innermost host span open at its middle.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, Iterable, List, Set, Tuple

WINDOW = "hpfbench.window"
CHUNK = "hpfbench.replay_chunk"
SYNC = "hpfbench.synchronize"
# the profiler mirrors each labelled host span on the device's timeline
# (a user annotation, no operation): such names are never device work
LABELS = (WINDOW, CHUNK, SYNC)
# every CUDA source of the program, as globs in its source directory
PROGRAM_SOURCES = ("*.cu", "*.cuh")

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\((?:[^()]|\([^()]*\))*\)\s*)?(?:void\s+)?(\w+)\s*\(")

Span = Tuple[str, float, float]          # name, start us, end us


def defined_kernels(paths: Iterable[str]) -> Set[str]:
    """The names of the `__global__` functions defined in these sources."""
    names: Set[str] = set()
    for path in paths:
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


def sources(csrc_dir: str, patterns: Iterable[str]) -> List[str]:
    return sorted({p for pat in patterns
                   for p in glob.glob(os.path.join(csrc_dir, pat))})


def kernel_name(name: str):
    """The function's name in a profiler name (`void (anonymous
    namespace)::f<3, 2>(...)` -> `f`), or None."""
    base = re.match(r"(?:void\s+)?(?:\(anonymous namespace\)::|\w+::)*(\w+)",
                    name)
    return base.group(1) if base else None


def kernel_of(name: str, kernels: Set[str]) -> bool:
    """Whether a profiler name is a launch of one of `kernels`."""
    return kernel_name(name) in kernels


@dataclasses.dataclass
class Trace:
    device: List[Span]           # device operations, clipped to the window
    host: List[Span]             # host spans (ops, runtime calls, labels)
    start: float                 # the window, us
    end: float

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        device, host = [], []
        for ev in prof.events():
            span = (ev.name, float(ev.time_range.start),
                    float(ev.time_range.end))
            if ev.device_type == DeviceType.CUDA:
                if ev.name not in LABELS:
                    device.append(span)
            elif ev.device_type == DeviceType.CPU:
                host.append(span)
        windows = [s for s in host if s[0] == WINDOW]
        if not windows:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        _, start, end = windows[0]
        clipped = [(n, max(s, start), min(e, end)) for n, s, e in device
                   if e > start and s < end]
        return cls(clipped, [h for h in host if h[0] != WINDOW], start, end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.device:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def seconds_of(self, kernels: Set[str], inside: bool = True) -> float:
        """Device seconds of the operations that are (or, inside=False,
        are not) launches of `kernels`."""
        return sum(sec for name, sec in self.seconds_by_name().items()
                   if kernel_of(name, kernels) == inside)

    def launched(self, kernels: Set[str]) -> Set[str]:
        """The names of `kernels` that the window launched."""
        out: Set[str] = set()
        for name in self.seconds_by_name():
            base = kernel_name(name)
            if base in kernels:
                out.add(base)
        return out

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self, top: int) -> List[Tuple[str, float]]:
        """(label, seconds) of the `top` longest stretches of the window
        in which the device ran nothing, longest first."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals() + [(self.end, self.end)]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return [(self._host_at((s + e) / 2), (e - s) / 1e6) for s, e in gaps]

    def _host_at(self, t: float) -> str:
        open_ = [h for h in self.host if h[1] <= t <= h[2]]
        if not open_:
            return "host: no span open"
        return "host: " + min(open_, key=lambda h: h[2] - h[1])[0]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda x: -x[1])
        return {"device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps(top)]}
