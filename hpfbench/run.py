#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print one JSON line.

    python3 hpfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run, on an NVIDIA GPU (it refuses to run without as many cards as the
cell asks for):

  1. set-up: loads the kernel library (built at the first run in a
     checkout, under `.kernel_build/`), draws the cell's COO and the
     initial HPF state on the card from the seed, builds the port's layout
     (`build_device_data`, timed as `layout_s`), makes the fused multi-step
     (`make_multi_step`) and drives it through the checked iterations,
     one call each (one eager step and its capture, then replays), then
     warm chunks of `rfreq` replayed iterations;
  2. window: chunks of `rfreq` iterations through the same multi-step
     object on the same state, each ended by a synchronize, as the
     Trainer's loop meets a report boundary, until `--seconds` have
     passed; with `--trace 1` under torch.profiler;
  3. checks: one eager step and one capture in all, every other
     iteration a replay; no JAX and no JAX package in `sys.modules`; the
     state after each checked iteration against the plain reference
     (refs/), run once the window has closed and the program's state is
     freed (compare.py, limits/<cell>.json).

`iter_ms` is the window's wall time over every iteration it completed;
`setup_s` runs from process start to the window, less the copies that
the checks take of the state. The numbers compared are printed beside
their limits as the last lines of standard error and under `checks`, the
last key of the result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CACHE = os.path.join(ROOT, ".hpfbench_cache")
# iterations held to the reference (one call each: the eager step and its
# capture, then replays), and chunks of rfreq replays warmed before the
# window
CHECKED_STEPS = 3
WARM_CHUNKS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "hgaprec_tpu")


class Failed(Exception):
    """A run that may print no result."""


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of `sys.modules` that are JAX or the JAX package,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def guard(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise Failed(f"{where}: sys.modules holds {found}")


def seed_bits(seed: int) -> int:
    return seed % (1 << 64)


def host_copy(leaves):
    return {k: v.detach().to("cpu", copy=True) for k, v in leaves.items()}


def check_counts(got: dict, total: int, replayed: bool, cuda: bool) -> None:
    """Raise Failed unless the multi-step made one eager step, one capture
    and replays for every other of `total` iterations. On the card the
    steps have to be replayed; off it (the CPU tests) they run in a loop,
    which counts none of the three."""
    if cuda and not replayed:
        raise Failed("on the card the multi-step runs its steps in a loop; "
                     "a run replays one capture")
    want = ({"eager_steps": 1, "captures": 1, "replays": total - 1}
            if replayed else {"eager_steps": 0, "captures": 0, "replays": 0})
    if got != want:
        raise Failed(f"the multi-step counted {got} over {total} "
                     f"iterations; a run replays one capture: {want}")


def unclaimed_kernels(tr, csrc_dir: str, bench: dict):
    """The launched kernels that the program's CUDA sources define and
    that no per-layer metric of BENCHMARK.json claims: each kernel
    layer's reader names its sources in `KERNEL_SOURCES`, so a kernel in a
    source that none names would drop out of every roofline unseen."""
    from hpfbench import manifest, trace
    claimed = set()
    for e in bench["per_layer"]:
        pats = getattr(manifest.module("metrics", e["name"]),
                       "KERNEL_SOURCES", ())
        claimed |= trace.defined_kernels(trace.sources(csrc_dir, pats))
    defined = trace.defined_kernels(
        trace.sources(csrc_dir, trace.PROGRAM_SOURCES))
    return sorted(tr.launched(defined - claimed))


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            root: str = ROOT, t_start: float = T_START) -> dict:
    """One run of `cell` on `device`; returns the result line's object.
    Raises Failed where a run may print no result."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hpfbench import compare, data, manifest, program, spans
    from hpfbench.state_init import hpf_initial_state
    from hpfbench.trace import CHUNK, SYNC, WINDOW, Trace

    bench = manifest.load(root)
    wl = manifest.workload(bench, cell)
    cfg = manifest.config(bench, wl["config"], root)
    traffic = manifest.traffic(wl["traffic"], root)
    limits = manifest.limits(cell, root)
    ref = manifest.module("refs", cfg["reference"])
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    marks = [("start", t_start), ("imports", time.perf_counter())]
    if cuda:
        program.load_kernels()
    marks.append(("kernels", time.perf_counter()))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed))
    coo = data.make_coo(cfg, gen, device)
    coo_host = coo.to("cpu")
    del coo
    marks.append(("data", time.perf_counter()))
    mcfg = program.model_config(cfg, traffic, coo_host.n, coo_host.m)
    dd, info, layout_s = program.layout(
        mcfg, coo_host.u.numpy(), coo_host.i.numpy(), coo_host.y.numpy(),
        device)
    marks.append(("layout", time.perf_counter()))
    say(f"layout: {info}; notes {spans.notes()}")
    leaves0 = hpf_initial_state(coo_host.n, coo_host.m, cfg["k"],
                                cfg["priors"], gen, device)
    check_s = 0.0
    t0 = time.perf_counter()
    snaps = [host_copy(leaves0)]
    check_s += time.perf_counter() - t0
    state = program.model_state(leaves0)
    del leaves0
    multi = program.make_multi_step(mcfg)
    steps, rfreq = CHECKED_STEPS, traffic["rfreq"]
    sync()
    marks.append(("state", time.perf_counter()))
    for _ in range(steps):
        multi(state, dd, 1)
        t0 = time.perf_counter()
        snaps.append(host_copy(program.leaves(state)))
        check_s += time.perf_counter() - t0
    sync()
    marks.append(("checked_steps", time.perf_counter()))
    for _ in range(WARM_CHUNKS):
        multi(state, dd, rfreq)
    sync()
    marks.append(("warm_chunks", time.perf_counter()))
    guard("end of set-up")
    setup_s = time.perf_counter() - t_start - check_s
    say("set-up s: " + ", ".join(
        f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1)
        in zip(marks, marks[1:])) + f"; the check's state copies "
        f"{check_s:.3f}, not counted")

    def span(name):
        return record_function(name) if trace else contextlib.nullcontext()

    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU] +
                       ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    iters = 0
    ends = [time.perf_counter()]
    with span(WINDOW):
        while True:
            with span(CHUNK):
                multi(state, dd, rfreq)
            with span(SYNC):
                sync()
            iters += rfreq
            ends.append(time.perf_counter())
            if ends[-1] - ends[0] >= seconds:
                break
    window_s = ends[-1] - ends[0]
    if prof is not None:
        prof.__exit__(None, None, None)
    chunk_ms = [1e3 * (t1 - t0) / rfreq for t0, t1 in zip(ends, ends[1:])]
    by_size = sorted(chunk_ms)
    say(f"window: {iters} iterations in {window_s:.3f} s; ms per iteration "
        f"by chunk: min {by_size[0]:.4f}, median "
        f"{by_size[len(by_size) // 2]:.4f}, max {by_size[-1]:.4f}, "
        f"first {chunk_ms[0]:.4f}, last {chunk_ms[-1]:.4f}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    check_counts(program.counts(multi), steps + WARM_CHUNKS * rfreq + iters,
                 multi.replays_on(state), cuda)

    out_metrics, dev_extra, breakdown = {}, {}, None
    if trace:
        tr = Trace.from_profiler(prof)
        stray = unclaimed_kernels(tr, program.csrc_dir(), bench)
        if stray:
            raise Failed(f"the window launched kernels of the program's "
                         f"CUDA sources that no kernel layer claims: "
                         f"{stray}")
        ctx = {"trace": tr, "iterations": iters, "k": cfg["k"],
               "precision": traffic["matmul_precision"], "nnz": coo_host.nnz,
               "n": coo_host.n, "m": coo_host.m, "info": info,
               "csrc_dir": program.csrc_dir(), "layout_s": layout_s}
        for e in manifest.metrics(bench, cell, trace=True):
            value = manifest.module("metrics", e["name"]).read(ctx)
            if value is not None:
                out_metrics[e["name"]] = {"value": value, "unit": e["unit"]}
        dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = tr.breakdown()
        del prof, tr, ctx
    else:
        e2e = {"iter_ms": 1e3 * window_s / iters, "setup_s": setup_s}
        for e in manifest.metrics(bench, cell, trace=False):
            out_metrics[e["name"]] = {"value": e2e[e["name"]],
                                      "unit": e["unit"]}

    # the reference runs once the program's state and data are freed
    multi.reset()
    del state, dd, multi
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_coo = coo_host.to(device)
    st = {k: v.to(device).to(torch.float64) for k, v in snaps[0].items()}
    numbers = {}
    for s in range(1, steps + 1):
        st = ref.hpf_step(st, ref_coo.u, ref_coo.i, ref_coo.y, cfg["k"],
                          cfg["priors"])
        gaps = compare.state_gaps(snaps[s], st)
        worst = max(gaps, key=gaps.get)
        numbers[compare.step_name(s)] = gaps[worst]
        say(f"iteration {s}: worst leaf {worst} gap {gaps[worst]!r}")
    del st, ref_coo, snaps
    say(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s")
    guard("after the window")
    correct, failed = compare.judge(numbers, limits)

    result = {"correct": correct, "attempted": steps,
              "failed": len(failed), "metrics": out_metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": wl["chips"], "memory_peak_bytes": peak,
                         **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    import torch
    try:
        from hpfbench import manifest
        chips = manifest.workload(manifest.load(), args.workload)["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise Failed(f"the cell needs {chips} CUDA device(s); "
                         f"available: {torch.cuda.is_available()}, "
                         f"count: {torch.cuda.device_count()}")
        say(f"device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}")
        result = execute(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0")
    except Failed as exc:
        say(f"hpfbench: {exc}")
        return 1
    for name, c in result["checks"].items():
        say(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
