#!/usr/bin/env python3
"""What each width of the hybrid head costs on the card, at the EchoNest
benchmark cell's draw.

    python3 scripts/head_width_costs.py [--seed N] [--widths 128,256,...]
        [--k K] [--out head_width_costs.json]

Draws the `echonest-hpf-k100` configuration's COO on the card
(hpfbench/gen/power_law.py, 1,019,318 users x 384,546 songs, 48,373,586
nonzeros), builds the COO once, then for each head width T the head
block over the top-T songs by degree and the tail stream of the rest.
At each width and in both precisions it runs the port's replayed
multi-step (`make_multi_step`, sweep "hybrid") from the same initial
state: ms per iteration over 3 chunks of 10 replays, then one traced
chunk, whose device time it splits into the dense kernels (sources
`dense_*.cu[h]`), the sparse passes (`segment_sweep.cu`, `tail_bf16.cu`,
`row_sweep.cuh`) and the rest (glue). The CSR sweep (`segment-chunked`)
on the same data is row T = 0. The per-group densities of the top songs
are printed first. `--k` sets the factor count (the configuration's 100
by default), and with it the routes of both layers: past 128 packed f32
values (256 bf16) the dense head runs the resident wide kernel, past 256
values the sparse passes run their wide lanes.

From the table: the head kernel's marginal seconds a cell (npad x T) and
the tail passes' marginal seconds a nonzero between neighbouring widths,
and the least-squares slopes over all widths, whose ratio is the
break-even density of data/device.py::BREAK_EVEN_DENSITY for kernel #1's
route at that K and precision. Needs an NVIDIA GPU; writes one JSON
object to --out and a table to standard output.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd.profiler import record_function  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

CONFIG = "echonest-hpf-k100"
CHUNK = 10
TIMED_CHUNKS = 3
GROUP = 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3200000000)
    ap.add_argument("--widths", default="128,256,384,512,640,768,896,1024,"
                                        "2048,4096")
    ap.add_argument("--k", type=int, default=0,
                    help="factors (0: the configuration's)")
    ap.add_argument("--out", default="head_width_costs.json")
    ap.add_argument("--small", action="store_true",
                    help="a dry run on the CPU at 3,000 x 2,000 with 40,000 "
                         "nonzeros (checks the script, times nothing)")
    args = ap.parse_args(argv)
    if not args.small and not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from hgaprec_tpu_torch.config import ModelConfig, set_matmul_precision
    from hgaprec_tpu_torch.data.device import build_layout, head_and_tail
    from hgaprec_tpu_torch.models.step import make_multi_step
    from hgaprec_tpu_torch.ops import build
    from hpfbench import data, manifest, program
    from hpfbench import trace as htrace
    from hpfbench.state_init import hpf_initial_state

    cfg = manifest.config(manifest.load(ROOT), CONFIG, ROOT)
    if args.small:
        dev = torch.device("cpu")
        cfg = dict(cfg, users=3000, items=2000, nnz=40000)
    else:
        dev = torch.device("cuda:0")
        build.load_library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed % (1 << 64))
    coo = data.make_coo(cfg, gen, dev).to("cpu")
    u, i, y = coo.u.numpy(), coo.i.numpy(), coo.y.numpy()
    n, m, k, nnz = coo.n, coo.m, args.k or cfg["k"], coo.nnz
    npad = -(-n // 512) * 512
    deg = np.bincount(i, minlength=m)
    order = np.argsort(-deg, kind="stable")
    groups = [int(deg[order[g:g + GROUP]].sum())
              for g in range(0, 8192, GROUP)]
    print(f"{nnz} nonzeros, {n} x {m}, npad {npad}; nonzeros and density "
          f"by group of {GROUP} songs in order of degree:")
    for j, g in enumerate(groups[:16]):
        print(f"  songs {j * GROUP + 1}-{(j + 1) * GROUP}: {g} "
              f"({100.0 * g / (npad * GROUP):.3f}%)")

    base = build_layout(u, i, y, n, m, dev)
    csrc = program.csrc_dir()
    dense_k = htrace.defined_kernels(htrace.sources(
        csrc, ("dense_*.cu", "dense_*.cuh")))
    sparse_k = htrace.defined_kernels(htrace.sources(
        csrc, ("segment_sweep.cu", "tail_bf16.cu", "row_sweep.cuh")))
    every_k = htrace.defined_kernels(htrace.sources(
        csrc, htrace.PROGRAM_SOURCES))

    def layout(t):
        if t == 0:
            return base, nnz
        ids = np.sort(order[:t]).astype(np.int32)
        items, head, tail = head_and_tail(u, i, y, m, npad, ids, dev)
        return dataclasses.replace(base, head_items=items, head_dense_y=head,
                                   tail=tail, slab_cache={}), tail.nnz

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(dd, t, precision):
        mcfg = ModelConfig(n=n, m=m, k=k, variant="hpf",
                           sweep="segment-chunked" if t == 0 else "hybrid",
                           matmul_precision=precision, **cfg["priors"])
        set_matmul_precision(precision)
        g = torch.Generator(device=dev)
        g.manual_seed(args.seed % (1 << 64) + 1)
        state = program.model_state(hpf_initial_state(
            n, m, k, cfg["priors"], g, dev))
        multi = make_multi_step(mcfg)
        multi(state, dd, 1)
        multi(state, dd, CHUNK)
        sync()
        ms = []
        for _ in range(TIMED_CHUNKS):
            t0 = time.perf_counter()
            multi(state, dd, CHUNK)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0) / CHUNK)
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])) \
                as prof:
            with record_function(htrace.WINDOW):
                multi(state, dd, CHUNK)
                sync()
        tr = htrace.Trace.from_profiler(prof)
        out = {"ms_per_iter": ms,
               "dense_ms": 1e3 * tr.seconds_of(dense_k) / CHUNK,
               "sparse_ms": 1e3 * tr.seconds_of(sparse_k) / CHUNK,
               "glue_ms": 1e3 * tr.seconds_of(every_k, inside=False) / CHUNK,
               "busy_ms": 1e3 * tr.busy_s / CHUNK,
               "replays": multi.replays}
        multi.reset()
        del state, multi
        return out

    widths = [0] + [int(w) for w in args.widths.split(",")]
    rows = []
    for t in widths:
        t0 = time.perf_counter()
        dd, tail_nnz = layout(t)
        build_s = time.perf_counter() - t0
        for precision in ("highest", "default"):
            r = run(dd, t, precision)
            r.update(T=t, precision=precision, tail_nnz=tail_nnz,
                     head_nnz=nnz - tail_nnz if t else 0,
                     head_cells=npad * t, layout_build_s=build_s)
            rows.append(r)
            print(f"T {t:5d} {precision:8s} tail {tail_nnz:9d}  ms/iter "
                  f"{' '.join(f'{x:.4f}' for x in r['ms_per_iter'])}  "
                  f"dense {r['dense_ms']:.4f} sparse {r['sparse_ms']:.4f} "
                  f"glue {r['glue_ms']:.4f} busy {r['busy_ms']:.4f}",
                  flush=True)
        del dd
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    print("marginal costs between neighbouring widths (dense s a cell, "
          "sparse s a nonzero):")
    for precision in ("highest", "default"):
        hy = [r for r in rows if r["precision"] == precision and r["T"]]
        for a, b in zip(hy, hy[1:]):
            cells = b["head_cells"] - a["head_cells"]
            moved = a["tail_nnz"] - b["tail_nnz"]
            print(f"  {precision:8s} T {a['T']}->{b['T']}: dense "
                  f"{1e-3 * (b['dense_ms'] - a['dense_ms']) / cells:.4e} "
                  f"s/cell, sparse "
                  f"{1e-3 * (a['sparse_ms'] - b['sparse_ms']) / moved:.4e} "
                  f"s/nnz over {moved} nonzeros")
        if len(hy) > 1:
            dense = np.polyfit([r["head_cells"] for r in hy],
                               [1e-3 * r["dense_ms"] for r in hy], 1)[0]
            sparse = np.polyfit([r["tail_nnz"] for r in hy],
                                [1e-3 * r["sparse_ms"] for r in hy], 1)[0]
            print(f"  {precision:8s} least squares: dense {dense:.4e} "
                  f"s/cell, sparse {sparse:.4e} s/nnz, break-even "
                  f"{100 * dense / sparse:.4f}% dense")
        for r in hy:
            print(f"  {precision:8s} T {r['T']}: dense "
                  f"{1e-3 * r['dense_ms'] / r['head_cells']:.4e} s/cell, "
                  f"sparse {1e-3 * r['sparse_ms'] / r['tail_nnz']:.4e} "
                  f"s/nnz")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
                   "seed": args.seed, "k": k, "nnz": nnz, "n": n, "m": m,
                   "npad": npad, "group_nnz": groups, "rows": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
