#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `hgaprec_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, sweeps once at Netflix
shape, trains HPF K=100 on MovieLens-1M-shaped synthetic data through the
Trainer (the port's main entry point) and checks the card's run against
the port's own CPU run. Prints one line per phase, a JSON line with each
kernel's launches, error and times, the card's name and power limit, and
last `{"ok": true, "device": {...}}`. Exits non-zero, with no result line,
when there is no GPU or any phase fails.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20260817
N_ML, M_ML, K = 6040, 3681, 100        # MovieLens-1M preset (bench.py:27)
N_NF, M_NF = 480189, 17770             # Netflix preset
F32_TOL = dict(rtol=2e-4, atol=1e-5)   # tests/test_dense_pallas.py:28-31
BF16_REL = 2e-2                        # tests/test_dense_pallas.py:107-110
CPU_REL = 1e-4


def say(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps):
    """Median over `reps` launches, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def random_inputs(gen, n, m, k, rows, bias, density, aligned=True):
    """Factors and a random u8 Y. aligned: Y in the Trainer's layout (row
    stride a multiple of 16 bytes); else contiguous rows of m bytes, which
    takes the kernel's byte-load path."""
    from hgaprec_tpu_torch.data.device import dense_count_matrix
    dev = "cuda"
    shapes = [(n, k), (m, k)] + ([(n,), (m,)] if bias else [])
    lin = [torch.exp(0.3 * torch.randn(s, device=dev, generator=gen))
           for s in shapes]
    y = (dense_count_matrix(rows, m, dev) if aligned else
         torch.zeros((rows, m), dtype=torch.uint8, device=dev))
    nnz = 0
    for r0 in range(0, n, 32768):       # chunks keep the f32 draws small
        r1 = min(r0 + 32768, n)
        hit = torch.rand((r1 - r0, m), device=dev, generator=gen) < density
        cnt = torch.randint(1, 6, (r1 - r0, m), device=dev, generator=gen,
                            dtype=torch.uint8)
        y[r0:r1] = hit * cnt
        nnz += int(hit.sum())
    return lin, y, nnz


def compare(got, ref, bf16):
    """(max abs error, passes): f32 at F32_TOL, bf16 at BF16_REL."""
    err, ok = 0.0, True
    for g, r in zip(got, ref):
        err = max(err, (g - r).abs().max().item())
        if bf16:
            ok &= ((g - r).abs() / r.abs().clamp_min(1e-3)).max().item() \
                < BF16_REL
        else:
            ok &= torch.allclose(g, r, **F32_TOL)
    return err, bool(ok)


def phase_kernel(df, gen):
    """Kernel against its plain version at a ragged and the ML-1M shape."""
    main = None
    for n, m, k, rows in ((1000, 777, 13, 1000), (N_ML, M_ML, K, 6144)):
        for bias in (False, True):
            lin, y, _ = random_inputs(gen, n, m, k, rows, bias, 0.045,
                                      aligned=(n == N_ML))
            ref32 = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:])
            for bf16 in (False, True):
                got = df.fused_dense_sweep(*lin[:2], y, *lin[2:], bf16=bf16)
                torch.cuda.synchronize()
                err, ok = compare(got, ref32, bf16)
                like = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:],
                                                      bf16=bf16)
                err_like = compare(got, like, bf16)[0]
                ms = median_ms(lambda: df.fused_dense_sweep(
                    *lin[:2], y, *lin[2:], bf16=bf16), 20)
                plain_ms = median_ms(lambda: df.fused_dense_sweep_reference(
                    *lin[:2], y, *lin[2:], bf16=bf16), 20)
                say(f"kernel {n}x{m}x{k} rows={rows} ldy={y.stride(0)} "
                    f"bias={bias} bf16={bf16}: max_abs_err vs f32 plain {err:.3e} "
                    f"(vs plain in the same mode {err_like:.3e}) "
                    f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms (median of 20)")
                if not ok:
                    raise SystemExit(f"kernel disagrees with its plain "
                                     f"version at {n}x{m}x{k}")
                if (n, bias, bf16) == (N_ML, False, True):
                    # the main path's configuration: HPF, no bias, bf16
                    main = dict(max_abs_err=err_like, ms=ms,
                                plain_ms=plain_ms)
            del lin, y, ref32
    return main


def phase_netflix(df, gen):
    rows = -(-N_NF // 512) * 512
    t0 = time.perf_counter()
    lin, y, nnz = random_inputs(gen, N_NF, M_NF, K, rows, False, 0.01)
    torch.cuda.synchronize()
    say(f"netflix: Y u8 {rows}x{M_NF} ({y.numel() / 1e9:.2f} GB, "
        f"{nnz:,} nonzeros) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    for bf16 in (False, True):
        got = df.fused_dense_sweep(*lin, y, bf16=bf16)
        ref = df.fused_dense_sweep_reference(*lin, y)
        torch.cuda.synchronize()
        err, ok = compare(got, ref, bf16)
        ms = median_ms(lambda: df.fused_dense_sweep(*lin, y, bf16=bf16), 3)
        plain_ms = median_ms(
            lambda: df.fused_dense_sweep_reference(*lin, y, bf16=bf16), 3)
        say(f"netflix {N_NF}x{M_NF}x{K} bf16={bf16}: all rows of acc_a and "
            f"acc_b vs f32 plain max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.2f} ms, plain "
            f"{plain_ms:.2f} ms (median of 3)")
        if not ok:
            raise SystemExit("netflix-shape sweep disagrees with plain")
        del got, ref
    del lin, y
    torch.cuda.empty_cache()


def train(datdir, outdir, precision, max_iterations, rfreq, device):
    from hgaprec_tpu_torch.config import ModelConfig, RunConfig
    from hgaprec_tpu_torch.data.ratings import load_dataset
    from hgaprec_tpu_torch.models.engine import Trainer
    store, validation, test = load_dataset(datdir, N_ML, M_ML, False, 1)
    tr = Trainer(store, validation, test,
                 ModelConfig(n=store.n, m=store.m, k=K, variant="hpf",
                             matmul_precision=precision),
                 RunConfig(datdir=datdir, outdir=outdir, rfreq=rfreq,
                           max_iterations=max_iterations), device=device)
    return tr


def validation_ll(outdir):
    with open(os.path.join(outdir, "validation.txt")) as f:
        return [(int(r.split("\t")[0]), float(r.split("\t")[2]))
                for r in f if r.strip()]


def steady_ms_per_iter(mcfg, state, data, windows=5, steps=100):
    """(median, min, max) ms per CAVI step over `windows` runs of `steps`
    back-to-back steps, each ended by a synchronize."""
    from hgaprec_tpu_torch.models.step import make_multi_step
    multi = make_multi_step(mcfg)
    multi(state, data, 3)
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        multi(state, data, steps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps * 1e3)
    return statistics.median(times), min(times), max(times)


def phase_main(df, datdir, root):
    outdir = os.path.join(root, "gpu_default")
    tr = train(datdir, outdir, "default", 30, 10, "cuda")
    df.fused_dense_sweep.launches = 0
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = df.fused_dense_sweep.launches
    tr.close()
    if launches == 0:
        raise SystemExit("the main path never launched the CUDA kernel")
    # At K=100 this data overfits after ~20 iterations: the JAX package's
    # own trajectory on it is -2.9075 (iter 0), -2.9810, -2.8584 (iter 20),
    # -3.1282 (iter 30). Learning shows as a later report above iter 0.
    ll = validation_ll(outdir)
    if not all(np.isfinite(v) for _, v in ll) or \
            not max(v for _, v in ll[1:]) > ll[0][1]:
        raise SystemExit(f"validation log-likelihood not rising: {ll}")
    contract = ("param.txt", "validation.txt", "test.txt", "precision.txt",
                "max.txt", "htheta.tsv", "hbeta.tsv", "model.npz",
                "ranking.tsv", "itemrank.tsv")
    missing = [f for f in contract if not os.path.exists(
        os.path.join(outdir, f))]
    if missing:
        raise SystemExit(f"output-file contract incomplete: {missing}")
    with open(os.path.join(outdir, "precision.txt")) as f:
        p10 = float(f.read().split("\n")[-2].split("\t")[1])
    # steady-state step time on the trained state, outside the reports:
    # host clock around 100 steps ending in synchronize, five windows
    ms_iter, ms_lo, ms_hi = steady_ms_per_iter(tr.mcfg, tr.state, tr.data)
    say(f"main path: Trainer HPF K={K} {tr.store.n}x{tr.store.m} "
        f"nnz={tr.store.nratings:,} precision=default, 31 iterations in "
        f"{wall:.2f} s wall (reports included); kernel launches {launches}; "
        f"validation ll by report {[(i, round(v, 6)) for i, v in ll]}; "
        f"final precision@10 {p10:.5f}; contract files "
        f"present; steady state {ms_iter:.3f} ms/iter = "
        f"{1e3 / ms_iter:.1f} iters/s (median of 5 windows of 100; range "
        f"{ms_lo:.3f}-{ms_hi:.3f})")
    return launches


def phase_cpu_reference(datdir, root):
    """Same config at "highest" on the card and on the CPU (the CPU run is
    the reference here, not a fallback)."""
    lls = {}
    for device in ("cuda", "cpu"):
        outdir = os.path.join(root, f"{device}_highest")
        tr = train(datdir, outdir, "highest", 10, 5, device)
        t0 = time.perf_counter()
        tr.run()
        tr.close()
        lls[device] = validation_ll(outdir)
        say(f"{device} run at highest, 11 iterations: "
            f"{time.perf_counter() - t0:.1f} s, validation ll "
            f"{[round(v, 6) for _, v in lls[device]]}")
    g, c = lls["cuda"], lls["cpu"]
    worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(g, c))
    ok = [a[0] for a in g] == [b[0] for b in c] and worst < CPU_REL
    say(f"card vs CPU reference: worst relative gap {worst:.3e} over "
        f"{len(g)} reports (bound {CPU_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("card and CPU runs disagree")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hgaprec_tpu_torch.config import set_matmul_precision
    from hgaprec_tpu_torch.data.synthetic import write_pf_dataset
    from hgaprec_tpu_torch.ops import build
    from hgaprec_tpu_torch.ops import dense_fused as df

    set_matmul_precision("highest")     # plain f32 references: no TF32
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(f"device: {name} ({torch.cuda.device_count()} visible); nvidia-smi: "
        f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {nvcc.splitlines()[-1]}")

    t0 = time.perf_counter()
    build.load_library()
    say(f"build: {os.path.relpath(build.library_path())} from "
        f"{[os.path.relpath(s) for s in build.sources()]} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    if os.path.exists(build.build_log_path()):
        with open(build.build_log_path()) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say(f"  {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_kernel = phase_kernel(df, gen)
    phase_netflix(df, gen)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        datdir = os.path.join(root, "data")
        t0 = time.perf_counter()
        nnz = write_pf_dataset(datdir, np.random.default_rng(SEED), N_ML,
                               M_ML, k=8, a=0.3, ap=1.8, b=0.3, scale=0.7)
        say(f"dataset: {N_ML}x{M_ML}, {nnz:,} nonzeros written in "
            f"{time.perf_counter() - t0:.1f} s")
        launches = phase_main(df, datdir, root)
        phase_cpu_reference(datdir, root)

    say(json.dumps({"kernels": [{
        "name": "fused_dense_sweep", "route": "cuda",
        "source": "hgaprec_tpu_torch/csrc/dense_fused.cu",
        "replaces": "hgaprec_tpu/ops/dense_pallas.py:50",
        "launches": launches, **main_kernel}]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
