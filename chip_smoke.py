#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--segment | --tail | --cli | --sharded]

With `--segment` it runs only the build and the segment path's kernel
phases (the CSR sweep on every layout and at EchoNest shape), with
`--tail` only the build and the tail kernel's phases (every layout and the
EchoNest tail), with `--cli` only the build, the ML-1M runs at "highest"
on the card and the CPU, and the command line's phase, with `--sharded`
only the build, those ML-1M runs and the sharded phases below, and
prints no result line. Without arguments it builds the port's CUDA kernels from
`hgaprec_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, sweeps once at Netflix
shape, trains HPF K=100 on MovieLens-1M-shaped synthetic data through the
Trainer (the port's main entry point) and checks the card's run at
"highest" (the default precision, the f32 dense kernel) against the
port's own CPU run. The command line (`python -m hgaprec_tpu_torch.cli`)
then trains the same configuration as a user types it, against that CPU
run, again in-process under `-trace` (kernel #1's f32 launches counted,
the device's busy share and longest kernels read from the trace), with
`-sweep segment-chunked -logl` (kernel #4 counted), and runs each mode on
the trained model (-rmse, -gen-ranking, -msr, -resume, the model read
back from its TSVs, -test, -nmf). The sharded run (parallel/) follows:
A, the command line's `-devices 2`, clamped to this card's world of one
(NCCL, in-process) and held to the single-device CLI run; B, the same
data through `build_sharded_run` over a world of one in both precisions,
held to the single-device Trainer, with its step time, the all-reduce's
device time per step and a report's gathers; C, two ranks sharing the
card over gloo (NCCL refuses two ranks on one device; a test harness,
not a product path) on a small hybrid store at "highest" and in bf16 and
a segment run, each rank launching kernels #1, #2 and #4, the gathered
state held to the single-device Trainer. The f32 kernel must beat its plain
version at Netflix shape and on the EchoNest head, and the step at "highest" is timed at
ML-1M and EchoNest. Then the big-sparse hybrid path: the tail kernel
against its plain version on adversarial layouts and on the EchoNest
tail (where its f32 route, the CSR sweep's two passes, must take less
than 1.5x its bf16 route's time), HPF K=100 at the
EchoNest preset shape (1,019,318 x 384,546, 45M nonzeros) through the
Trainer, and a small hybrid run on the card against the CPU. Then the segment path: the CSR sweep kernel against its plain
version on adversarial layouts, HPF K=100 at the EchoNest preset shape
through the Trainer with `sweep="segment-chunked"` and the training ELBO
(every nonzero through the CSR kernel, no head block, no tail), and five
small segment runs (HPF + ELBO, BPF + bias, MLE user, MLE item, Canny) on
the card against the CPU. The dense kernels' stage probe (every stage of
the bf16 and the f32 route) is held to its plain versions at ML-1M and
Netflix shape and timed at Netflix shape beside the floor of each stage's
work, the f32 stages again on the trained EchoNest head. Prints one line
per phase, a JSON line with each kernel's
launches, error and times, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero, with no result line,
when there is no GPU or any phase fails.
"""

import dataclasses
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
# one H100 SXM (NVIDIA's data sheet, dense rates): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
TAIL_F32_TOL = dict(rtol=2e-5, atol=1e-6)   # tests/test_pallas_tail.py:62-63
SEG_TOL = dict(rtol=2e-4, atol=1e-5)        # tests/test_sweep.py:62-65
N_EN, M_EN = 1019318, 384546           # EchoNest preset (run.pl:84-87)
EN_DRAWS, EN_SEED = 85_000_000, 5      # scripts/bigsparse_scale_check.py
# what that generator gave (docs/artifacts/echonest_scale.json; data
# facts, not timings): nonzeros, head width, head coverage, tail nonzeros
EN_NNZ, EN_T, EN_COVERAGE, EN_TAIL = 45022371, 4096, 0.809, 8590878


def say(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps, batch=1):
    """ms per call: the median over `reps` windows, each timed with CUDA
    events around `batch` back-to-back calls. One call per window starts
    on an idle card, so the host's work before the first launch counts;
    a batch keeps the host ahead of the card, as a training step does."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / batch)
    return statistics.median(times)


def device_ms_by_kernel(fn, reps):
    """{kernel name: device ms per call of `fn`} from torch.profiler over
    `reps` calls after one warm-up; empty if the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / reps
    return out


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of `nbytes` over the HBM rate and `flops` over `peak`."""
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def dense_bound(n, m, kaug, peak=BF16_FLOPS):
    """The bf16 dense sweep's bound: three products of 2 N M kaug on the
    function's own width (K, plus 2 with bias; not the zero-padded kq a
    kernel steps through) against Y, the factors and the outputs each
    moved once."""
    return bound(n * m + 2 * 4 * kaug * (n + m), 6 * n * m * kaug, peak)


def dense_bound_f32(n, m, kaug):
    """The f32 dense sweep's bound: the same bytes and FLOPs at the FP32
    rate outside the tensor cores."""
    return dense_bound(n, m, kaug, F32_FLOPS)


def tflops(n, m, k, ms, kernel="wgmma"):
    """A dense route's rate on the function's three products at width K
    (K + 2 with bias), and the rate it issues: four products (both roles
    form S) at the kernel's packed width kq (zero-padded to 112 on the
    tensor cores, 100 at K = 100 in f32)."""
    from hgaprec_tpu_torch.ops.dense_fused import packed_width
    kq = packed_width(k, kernel)
    return (f"{6 * n * m * k / ms / 1e9:.1f} TFLOP/s of 6 N M K, "
            f"{8 * n * m * kq / ms / 1e9:.1f} issued as 8 N M kq at "
            f"kq = {kq}")


def random_inputs(gen, n, m, k, rows, bias, density):
    """Factors and a random u8 Y in the Trainer's layout (row stride a
    multiple of 16 bytes), zero past row n."""
    from hgaprec_tpu_torch.data.device import dense_count_matrix
    dev = "cuda"
    shapes = [(n, k), (m, k)] + ([(n,), (m,)] if bias else [])
    lin = [torch.exp(0.3 * torch.randn(s, device=dev, generator=gen))
           for s in shapes]
    y = dense_count_matrix(rows, m, dev)
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
    """Kernel against its plain version at a ragged and the ML-1M shape.
    The bf16 route (csrc/dense_wgmma.cu) reads an aligned Y with ragged N
    and M and is timed beside its bound; its two launches must be bitwise
    equal. The f32 route also reads the ragged Y unaligned (contiguous rows
    of M bytes) and is printed beside its own bound (dense_bound_f32)."""
    main = f32 = None
    for n, m, k, rows in ((1000, 777, 13, 1024), (N_ML, M_ML, K, 6144)):
        for bias in (False, True):
            lin, y, _ = random_inputs(gen, n, m, k, rows, bias, 0.045)
            ref32 = df.fused_dense_sweep_reference(*lin[:2], y, *lin[2:])
            for bf16 in (False, True):
                yy = y if bf16 or n == N_ML else y.contiguous()
                got = df.fused_dense_sweep(*lin[:2], yy, *lin[2:], bf16=bf16)
                again = df.fused_dense_sweep(*lin[:2], yy, *lin[2:],
                                             bf16=bf16)
                torch.cuda.synchronize()
                err, ok = compare(got, ref32, bf16)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                like = df.fused_dense_sweep_reference(*lin[:2], yy, *lin[2:],
                                                      bf16=bf16)
                err_like = compare(got, like, bf16)[0]
                ms = median_ms(lambda: df.fused_dense_sweep(
                    *lin[:2], yy, *lin[2:], bf16=bf16), 20)
                plain_ms = median_ms(lambda: df.fused_dense_sweep_reference(
                    *lin[:2], yy, *lin[2:], bf16=bf16), 20)
                line = (f"kernel {n}x{m}x{k} rows={rows} ldy={yy.stride(0)} "
                        f"bias={bias} bf16={bf16}: max_abs_err vs f32 plain "
                        f"{err:.3e} (vs plain in the same mode "
                        f"{err_like:.3e}), two launches bitwise "
                        f"{'equal' if same else 'DIFFERENT'} "
                        f"{'ok' if ok and same else 'FAIL'}; kernel "
                        f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
                kaug = k + 2 if bias else k
                if not bf16:
                    bound_ms, bound_by = dense_bound_f32(n, m, kaug)
                    line += (f"; {tflops(n, m, kaug, ms, 'f32')}; bound "
                             f"{bound_ms:.4f} ms ({bound_by}), kernel at "
                             f"{ms / bound_ms:.2f}x it")
                    if (n, bias) == (N_ML, False):
                        f32 = dict(ms_f32_ml1m=ms, plain_ms_f32_ml1m=plain_ms,
                                   bound_ms_f32_ml1m=bound_ms)
                else:
                    bound_ms, bound_by = dense_bound(n, m, kaug)
                    line += f"; bound {bound_ms:.4f} ms ({bound_by})"
                say(line)
                if not (ok and same):
                    raise SystemExit(f"kernel disagrees with its plain "
                                     f"version or itself at {n}x{m}x{k}")
                if (n, bias, bf16) == (N_ML, False, True):
                    # the main path's configuration: HPF, no bias, bf16
                    main = dict(max_abs_err=err_like, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
            del lin, y, ref32
    return main, f32


def phase_netflix(df, gen):
    """One sweep at Netflix shape in both modes against the plain version,
    then the stage probe of both routes on the same Y; the f32 route must be
    faster than its plain version."""
    rows = -(-N_NF // 512) * 512
    t0 = time.perf_counter()
    lin, y, nnz = random_inputs(gen, N_NF, M_NF, K, rows, False, 0.01)
    torch.cuda.synchronize()
    say(f"netflix: Y u8 {rows}x{M_NF} ({y.numel() / 1e9:.2f} GB, "
        f"{nnz:,} nonzeros) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    kernel_ms = {}
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
        kernel_ms[bf16] = ms, plain_ms
        del got, ref
    # the kq = 128 instantiation at full width: the factors zero-padded to
    # K = 128 give bitwise the same sums in the first K columns
    lin128 = [torch.nn.functional.pad(x, (0, 128 - K)) for x in lin]
    got = df.fused_dense_sweep(*lin, y, bf16=True)
    got128 = df.fused_dense_sweep(*lin128, y, bf16=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b[:, :K]) for a, b in zip(got, got128))
    say(f"netflix bf16 at kq = 128 (factors zero-padded to K = 128): first "
        f"{K} columns bitwise {'equal ok' if same else 'DIFFERENT'} to "
        f"kq = {df.packed_width(K, 'wgmma')}")
    if not same:
        raise SystemExit("the kq = 128 instantiation disagrees with the "
                         "main path's width on zero-padded factors")
    del got, got128, lin128
    # the f32 route ("highest", the default precision) against its bound
    # and the plain version it must beat
    f32_ms, f32_plain_ms = kernel_ms[False]
    f32_bound_ms, f32_bound_by = dense_bound_f32(N_NF, M_NF, K)
    faster = f32_ms < f32_plain_ms
    say(f"netflix f32: kernel {f32_ms:.2f} ms "
        f"({tflops(N_NF, M_NF, K, f32_ms, 'f32')}); plain "
        f"{f32_plain_ms:.2f} ms; bound {f32_bound_ms:.2f} ms "
        f"({f32_bound_by}), kernel at {f32_ms / f32_bound_ms:.2f}x it "
        f"{'ok' if faster else 'FAIL'}")
    if not faster:
        raise SystemExit("the f32 kernel is slower than its plain version at "
                         "Netflix shape")
    ms = kernel_ms[True][0]
    bound_ms, bound_by = dense_bound(N_NF, M_NF, K)
    say(f"netflix bf16: wgmma kernel {ms:.2f} ms "
        f"({tflops(N_NF, M_NF, K, ms)}); bound {bound_ms:.2f} ms "
        f"({bound_by}), kernel at {ms / bound_ms:.2f}x it")
    probe = phase_probe(df, gen, lin, y)
    del lin, y
    torch.cuda.empty_cache()
    return probe, dict(ms_netflix=ms, bound_ms_netflix=bound_ms,
                       ms_f32_netflix=f32_ms,
                       plain_ms_f32_netflix=f32_plain_ms,
                       bound_ms_f32_netflix=f32_bound_ms)


# the packed widths each route's probe stages run at K = 100
PROBE_KQ = {"wgmma": 112, "f32": 100}
# static instruction classes of the stages' machine code (dp.sass_counts):
# the bf16 route's S products (m64n64k16) and contraction (m64n112k16), the
# f32 route's FMAs and its contraction's Z pair loads (LDS.64, which only
# the contraction issues), Y's reads from shared memory and the copies
# into it (TMA on the bf16 route, cp.async on the f32 route)
SASS_OPS = ("HGMMA.64x64x16", "HGMMA.64x112x16", "FFMA", "LDS.64",
            "LDS.U8", "LDS.U16", "UTMALDG", "LDGSTS")


def stage_floor(n, m, stage, bf16):
    """(floor ms, bound_by) of the work one probe stage issues: its
    products as issued (8 N M kq, both roles forming S; 4 N M kq for
    mmonly, S only) at the route's peak, against the bytes it moves (Y's
    two reads where it reads Y, the factors once, the outputs once)."""
    kq = PROBE_KQ["wgmma" if bf16 else "f32"]
    flops = (4 if stage == "mmonly" else 8) * n * m * kq
    y_bytes = 2 * n * m if stage in ("prod", "bf16recip", "norecip") else 0
    nbytes = y_bytes + (n + m) * kq * ((2 if bf16 else 4) + 4)
    return bound(nbytes, flops, BF16_FLOPS if bf16 else F32_FLOPS)


def timed_once(fn):
    """(fn's result, ms of that one call by CUDA events)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def f64_stage_sums(lin, y, stage):
    """The f32 stage's function in f64 (the exact sums, to f32 eyes)."""
    a, b = (x.double() for x in lin)
    acc_a, acc_b = torch.zeros_like(a), torch.zeros_like(b)
    for u0 in range(0, a.shape[0], 32768):
        a_u = a[u0:u0 + 32768]
        w = y[u0:u0 + a_u.shape[0], :b.shape[0]].double()
        if stage == "prod":
            w = w / torch.clamp_min(a_u @ b.T, 1e-30)
        elif stage == "noyload":
            w = torch.ones_like(w)
        elif stage == "mmonly":
            w = torch.zeros_like(w)
        acc_a[u0:u0 + a_u.shape[0]] = w @ b
        acc_b += w.T @ a_u
    return acc_a, acc_b


def summation_bound(df, n, m):
    """gamma_n = n u / (1 - n u) for the longest f32 sum a kernel thread
    runs on the f32 route at [n, m] (its moving chunk of 64-row tiles,
    both roles, plus S's kq = 100 terms and the fixed-order sum of the
    split partials), u = 2^-24: with W, A and B nonnegative every such sum
    lies within gamma_n of the exact one, relative."""
    split_a, split_b = df.splits_for(
        n, m, torch.cuda.get_device_properties(0).multi_processor_count,
        "f32")
    chunk = max(-(-(-(-nz // 64)) // split) * 64
                for nz, split in ((m, split_a), (n, split_b)))
    terms = chunk + PROBE_KQ["f32"] + max(split_a, split_b)
    return terms * 2.0 ** -24 / (1 - terms * 2.0 ** -24)


def check_probe_stages(df, dp, lin, y, bf16, where, exact_bound=None):
    """Every stage of one route on these inputs against its plain version
    (bf16 relative 2e-2, clamp 1e-3; f32 rtol=2e-4, atol=1e-5), two
    launches bitwise equal, prod bitwise `fused_dense_sweep` of the route.
    With `exact_bound` (f32 only) each stage is held instead to its f64
    sums within that relative bound, and its distance to the plain version
    (cuBLAS's blocked sums) is printed beside. Returns ({stage: max abs
    error against the plain version}, {stage: plain ms, one call})."""
    route = dp.route_of(bf16)
    errs, plain = {}, {}
    for s in dp.ROUTE_STAGES[route]:
        got = dp.dense_probe(*lin, y, s, bf16=bf16)
        again = dp.dense_probe(*lin, y, s, bf16=bf16)
        ref, plain[s] = timed_once(lambda: dp.dense_probe_reference(
            *lin, y, s, bf16=bf16))
        errs[s], ok = compare(got, ref, bf16)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        line = (f"probe {where} {route} {s:9s}: max_abs_err vs plain "
                f"{errs[s]:.3e}{'' if ok else ' (beyond rtol=2e-4)'}, two "
                f"launches bitwise {'equal' if same else 'DIFFERENT'}")
        if exact_bound is not None:
            exact = f64_stage_sums(lin, y, s)
            rel = [max(((g.double() - e).abs() / e.abs().clamp_min(
                1e-300)).max().item() for g, e in zip(out, exact))
                for out in (got, ref)]
            ok = rel[0] <= exact_bound
            line += (f"; relative to the f64 sums: kernel {rel[0]:.3e} "
                     f"(bound {exact_bound:.3e}), plain {rel[1]:.3e}")
            del exact
        if s == "prod":
            prod = df.fused_dense_sweep(*lin, y, bf16=bf16)
            same &= all(torch.equal(a, b) for a, b in zip(got, prod))
            line += (f"; bitwise {'equal' if same else 'DIFFERENT'} to "
                     f"fused_dense_sweep(bf16={bf16})")
            del prod
        say(f"{line} {'ok' if ok and same else 'FAIL'}")
        if not (ok and same):
            raise SystemExit(f"probe stage {route} {s} disagrees with its "
                             f"plain version, itself or the production route")
        del got, again, ref
    return errs, plain


def check_probe_sass(dp):
    """Each stage kept its products and dropped what it removes, read from
    the machine code (static counts, not instructions executed): mmonly
    keeps the S products and has no contraction (bf16: no m64n112k16
    product; f32: no Z pair load, LDS.64); noyload and mmonly read no Y
    from shared memory and copy less into it than norecip. S and the
    contraction issue the same products per tile (bf16: 7 m64n64k16 =
    4 m64n112k16 in multiply-adds; f32: the two halves issue equal FMAs),
    so mmonly issues half of prod's products."""
    counts = dp.sass_counts(SASS_OPS)
    say(f"probe: static instruction counts per stage {json.dumps(counts)}")
    bad = []
    for route, stages in dp.ROUTE_STAGES.items():
        got = counts[route]
        if sorted(got) != sorted(stages):
            raise SystemExit(f"probe: {route} stages in the machine code "
                             f"{sorted(got)}, expected {sorted(stages)}")
        s_op, c_op, copy_op = (("HGMMA.64x64x16", "HGMMA.64x112x16",
                                "UTMALDG") if route == "wgmma" else
                               ("FFMA", "LDS.64", "LDGSTS"))
        for s in stages:
            c = got[s]
            y_reads = c["LDS.U8"] + c["LDS.U16"]
            if c[s_op] == 0:
                bad.append(f"{route} {s} lost its S products")
            if (c[c_op] == 0) != (s == "mmonly"):
                bad.append(f"{route} {s}: contraction ({c_op}) {c[c_op]}")
            if (y_reads == 0) != (s in ("noyload", "mmonly")):
                bad.append(f"{route} {s}: Y reads {y_reads}")
            if s in ("noyload", "mmonly") and \
                    c[copy_op] >= got["norecip"][copy_op]:
                bad.append(f"{route} {s}: {c[copy_op]} {copy_op}, not "
                           f"fewer than norecip's")
    # the counts are static (the loop is peeled and unrolled differently per
    # stage); per moving tile a warpgroup issues one S group (kq / 16 = 7
    # m64n64k16) and one contraction group (kTc / 16 = 4 m64n112k16)
    macs = {s: 7 * 64 * 64 * 16 * (c["HGMMA.64x64x16"] > 0) +
            4 * 64 * 112 * 16 * (c["HGMMA.64x112x16"] > 0)
            for s, c in counts["wgmma"].items()}
    say(f"probe: tensor-core multiply-adds per moving tile and warpgroup "
        f"{macs}: mmonly issues {macs['mmonly'] / macs['prod']:.2f} of "
        f"prod's; f32: mmonly keeps the S half's FMAs (FFMA "
        f"{counts['f32']['mmonly']['FFMA']} of prod's "
        f"{counts['f32']['prod']['FFMA']} in the code) and drops the "
        f"contraction half's, which issues as many per step")
    say(f"probe: each stage kept its products and dropped what it removes "
        f"{'ok' if not bad else 'FAIL ' + '; '.join(bad)}")
    if bad:
        raise SystemExit("a probe stage lost its products or kept what it "
                         "removes")
    return counts


def time_probe(dp, lin, y, bf16, reps):
    """{stage: median ms} of one route's stages on these inputs; the
    launches counted from 0 on this path alone."""
    dp.dense_probe.launches = 0
    for r in dp.dense_probe.launches_by_route:
        dp.dense_probe.launches_by_route[r] = 0
    times = dp.time_stages(*lin, y, dp.ROUTE_STAGES[dp.route_of(bf16)],
                           reps, bf16=bf16)
    launches = dp.dense_probe.launches_by_route[dp.route_of(bf16)]
    if launches == 0 or launches != dp.dense_probe.launches:
        raise SystemExit(f"the probe path launched the {dp.route_of(bf16)} "
                         f"stage kernels {launches} times")
    return times, launches


def say_stages(dp, where, n, m, bf16, times, plain):
    """One line per stage: its time beside the floor of its work."""
    route = dp.route_of(bf16)
    floors = {}
    for s, ms in times.items():
        floors[s], by = stage_floor(n, m, s, bf16)
        say(f"probe {where} {n}x{m}x{K} {route} {s:9s}: kernel {ms:.3f} ms, "
            f"floor of its work {floors[s]:.2f} ms ({by}), kernel at "
            f"{ms / floors[s]:.2f}x it; plain {plain[s]:.2f} ms")
    return floors


def phase_probe(df, gen, lin, y):
    """The dense kernels' stage probe (kernel #3) on both routes: every
    stage against its plain version at ML-1M shape first (a stage that
    hangs or is wrong fails there), the stages' machine code, then every
    stage timed on the Netflix Y (the path whose launches count) and held
    again to its plain version and, for prod, to the production route."""
    from hgaprec_tpu_torch.ops import dense_probe as dp
    lin_ml, y_ml, _ = random_inputs(gen, N_ML, M_ML, K, 6144, False, 0.045)
    for bf16 in (True, False):
        check_probe_stages(df, dp, lin_ml, y_ml, bf16, "ML-1M")
    del lin_ml, y_ml
    counts = check_probe_sass(dp)
    out = dict(stage_ms={}, stage_floor_ms={}, stage_plain_ms={},
               stage_max_abs_err={}, launches_by_path={})
    for bf16 in (True, False):
        route = dp.route_of(bf16)
        times, launches = time_probe(dp, lin, y, bf16, 3)
        errs, plain = check_probe_stages(df, dp, lin, y, bf16, "netflix")
        out["stage_floor_ms"][route] = say_stages(dp, "netflix", N_NF, M_NF,
                                                  bf16, times, plain)
        out["stage_ms"][route] = times
        out["stage_plain_ms"][route] = plain
        out["stage_max_abs_err"][route] = errs
        out["launches_by_path"][route] = {"netflix_probe": launches}
    bound_ms, bound_by = dense_bound(N_NF, M_NF, K)
    return dict(out, max_abs_err=max(max(e.values()) for e in
                                     out["stage_max_abs_err"].values()),
                ms=out["stage_ms"]["wgmma"]["prod"],
                plain_ms=out["stage_plain_ms"]["wgmma"]["prod"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                ms_f32=out["stage_ms"]["f32"]["prod"],
                plain_ms_f32=out["stage_plain_ms"]["f32"]["prod"],
                bound_ms_f32=dense_bound_f32(N_NF, M_NF, K)[0],
                sass_counts=counts)


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
    return window_ms(lambda n: multi(state, data, n), windows, steps)


def window_ms(multi, windows=5, steps=100):
    """(median, min, max) ms per step of `multi(n)` (n steps back to back)
    over `windows` windows of `steps`, each ended by a synchronize, after
    3 warm-up steps."""
    multi(3)
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        multi(steps)
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


def phase_cpu_reference(df, datdir, root):
    """Same config at "highest" (the default precision: the f32 dense
    route) on the card and on the CPU (the CPU run is the reference here,
    not a fallback); the card's steady-state step time at "highest"."""
    lls = {}
    for device in ("cuda", "cpu"):
        outdir = os.path.join(root, f"{device}_highest")
        tr = train(datdir, outdir, "highest", 10, 5, device)
        df.fused_dense_sweep.launches = 0
        t0 = time.perf_counter()
        tr.run()
        wall = time.perf_counter() - t0
        if device == "cuda":
            launches = df.fused_dense_sweep.launches
            ms_iter, ms_lo, ms_hi = steady_ms_per_iter(tr.mcfg, tr.state,
                                                       tr.data)
        tr.close()
        lls[device] = validation_ll(outdir)
        say(f"{device} run at highest, 11 iterations: {wall:.1f} s, "
            f"validation ll {[round(v, 6) for _, v in lls[device]]}")
    g, c = lls["cuda"], lls["cpu"]
    worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(g, c))
    ok = [a[0] for a in g] == [b[0] for b in c] and worst < CPU_REL and \
        launches > 0
    say(f"card vs CPU reference: worst relative gap {worst:.3e} over "
        f"{len(g)} reports (bound {CPU_REL}); f32 dense kernel launches "
        f"{launches} {'ok' if ok else 'FAIL'}; card steady state at highest "
        f"{ms_iter:.3f} ms/iter = {1e3 / ms_iter:.1f} iters/s (median of 5 "
        f"windows of 100; range {ms_lo:.3f}-{ms_hi:.3f})")
    if not ok:
        raise SystemExit("card and CPU runs disagree, or the card run at "
                         "highest never launched the f32 kernel")
    return launches, ms_iter


# ---------------------------------------------------------------------------
# the command line (python -m hgaprec_tpu_torch.cli) on ML-1M
# ---------------------------------------------------------------------------

CLI_CONTRACT = ("param.txt", "infer.log", "validation.txt", "test.txt",
                "precision.txt", "max.txt", "htheta.tsv", "hbeta.tsv",
                "thetarate.tsv", "betarate.tsv", "model.npz", "ranking.tsv",
                "itemrank.tsv", "byusers.tsv", "byitems.tsv")


def trace_summary(trace_dir):
    """Device busy share and kernels by name from the one
    `*.pt.trace.json` that torch.profiler's TensorBoard handler wrote:
    the window runs from the first to the last event of the trace; busy
    is the union of kernel, copy and fill intervals on the card."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise SystemExit(f"-trace wrote {files} into {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, t0
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = max(e["ts"], end), e["ts"] + e["dur"]
        if stop > start:
            busy += stop - start
            end = stop
    by_name = {}
    for e in device:
        if e["cat"] == "kernel":
            ms, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(file=files[0], window_ms=(t1 - t0) / 1e3,
                busy_ms=busy / 1e3, busy_share=busy / (t1 - t0),
                kernel_ms=sum(ms for ms, _ in by_name.values()),
                copy_ms=sum(e["dur"] for e in device
                            if e["cat"] != "kernel") / 1e3,
                top5=[(name, ms, n) for name, (ms, n) in top],
                names=set(by_name))


def cli_in_process(args):
    """(exit code, stdout) of `hgaprec_tpu_torch.cli.main(args)`."""
    import contextlib
    import io
    from hgaprec_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    if rc != 0:
        raise SystemExit(f"cli {args} exited {rc}: {buf.getvalue()}")
    return buf.getvalue()


def phase_cli(df, datdir, root, cpu_ref):
    """HPF K=100 on ML-1M through the port's command line: the training
    run as a user types it (a subprocess) against the CPU reference run,
    the same run in-process under -trace with kernel #1's f32 launches
    counted, a segment run with -logl counting kernel #4, then each mode
    on the trained model. Returns the launch counts of kernel #1's f32
    route and of kernel #4."""
    import shutil
    from hgaprec_tpu_torch.data.ratings import leave_one_out_map, load_dataset
    from hgaprec_tpu_torch.ops import segment_fused as sf
    here = os.path.dirname(os.path.abspath(__file__))
    base = ["-dir", datdir, "-n", str(N_ML), "-m", str(M_ML), "-k", str(K),
            "-hier", "-rfreq", "5", "-max-iterations", "10"]
    out = os.path.join(root, "cli")
    secs = {}

    # 1. the entry point as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hgaprec_tpu_torch.cli", *base, "-outdir",
         out], cwd=here, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=here))
    secs["train_subprocess"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"the CLI exited {proc.returncode}: "
                         f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    g, c = validation_ll(out), validation_ll(cpu_ref)
    worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(g, c))
    missing = [f for f in CLI_CONTRACT
               if not os.path.exists(os.path.join(out, f))]
    ok = [a[0] for a in g] == [b[0] for b in c] and worst < CPU_REL and \
        not missing
    say(f"cli: python -m hgaprec_tpu_torch.cli {' '.join(base[2:])} "
        f"(subprocess) in {secs['train_subprocess']:.1f} s wall; validation "
        f"ll {[(i, round(v, 6)) for i, v in g]} against the CPU run at "
        f"highest: worst relative gap {worst:.3e} (bound {CPU_REL}); "
        f"contract files {'present' if not missing else missing} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the CLI's run disagrees with the CPU reference "
                         "or left its output contract incomplete")

    # 2. the same run in-process under -trace, kernel #1 counted
    trace_dir = os.path.join(root, "cli_trace")
    df.fused_dense_sweep.launches = 0
    t0 = time.perf_counter()
    cli_in_process(base + ["-outdir", os.path.join(root, "cli_traced"),
                           "-trace", trace_dir])
    secs["train_traced"] = time.perf_counter() - t0
    launches_f32 = df.fused_dense_sweep.launches
    trace = trace_summary(trace_dir)
    named = [n for n in trace["names"] if "dense_simt_f32" in n]
    say(f"cli in-process with -trace: {secs['train_traced']:.1f} s wall; "
        f"f32 dense kernel launches {launches_f32}; trace "
        f"{trace['file']}: window {trace['window_ms']:.1f} ms, device busy "
        f"{trace['busy_ms']:.1f} ms ({100 * trace['busy_share']:.2f}%), "
        f"kernels {trace['kernel_ms']:.1f} ms, copies and fills "
        f"{trace['copy_ms']:.1f} ms; five longest kernels "
        f"{[(n[:60], round(ms, 3), k) for n, ms, k in trace['top5']]}")
    if launches_f32 == 0 or not named:
        raise SystemExit("the CLI at highest never launched the f32 dense "
                         "kernel, or the trace does not name it")

    # 3. segment training with the ELBO, kernel #4 counted
    seg_out = os.path.join(root, "cli_segment")
    sf.fused_segment_sweep.launches = 0
    t0 = time.perf_counter()
    cli_in_process(base[:-2] + ["-max-iterations", "5", "-sweep",
                                "segment-chunked", "-logl", "-outdir",
                                seg_out])
    secs["train_segment"] = time.perf_counter() - t0
    launches_seg = sf.fused_segment_sweep.launches
    logl = logl_rows(seg_out)
    say(f"cli -sweep segment-chunked -logl -max-iterations 5: "
        f"{secs['train_segment']:.1f} s wall; CSR sweep launches "
        f"{launches_seg}; logl.txt {logl}")
    if launches_seg == 0 or not logl or \
            not all(np.isfinite(v) for v in logl):
        raise SystemExit("the CLI's segment run never launched the CSR "
                         "sweep kernel or wrote no finite ELBO")

    # 4. the modes, on the trained model (each on its own copy of OUT:
    # a mode reopens the report files of its output directory)
    store, _, test = load_dataset(datdir, N_ML, M_ML, False, 1)

    def mode(name, args, copy=True):
        d = os.path.join(root, f"cli_{name}")
        if copy:
            shutil.copytree(out, d)
        t0 = time.perf_counter()
        text = cli_in_process(base + args + ["-outdir", d])
        secs[name] = time.perf_counter() - t0
        return d, text

    d, _ = mode("rmse", ["-rmse", "-load", out], copy=False)
    with open(os.path.join(d, "rmse.txt")) as f:
        rmse = float(f.read())
    n_scores = len(open(os.path.join(d, "test_scores.tsv")).readlines())
    if not np.isfinite(rmse) or n_scores != len(test):
        raise SystemExit(f"-rmse: {rmse}, {n_scores} test scores")
    d, _ = mode("gen_ranking", ["-gen-ranking"])
    ranked = {int(r.split("\t")[0]) for r in open(
        os.path.join(d, "ranking.tsv")) if r.strip()}
    want = {store.seq2user[int(u)] for u in store.read_test_users(
        os.path.join(datdir, "test_users.tsv"))}
    if ranked != want:
        raise SystemExit(f"-gen-ranking ranked {len(ranked)} users, "
                         f"test_users.tsv names {len(want)}")
    d, _ = mode("msr", ["-msr"])
    rows = len(open(os.path.join(d, "pred.csv")).readlines()) - 1
    if rows != len(leave_one_out_map(test)):
        raise SystemExit(f"-msr: {rows} rows in pred.csv")
    d, text = mode("resume", ["-resume", "-max-iterations", "15"])
    d_it = validation_ll(d)
    if "+ resuming from iteration 11" not in text or \
            [i for i, _ in d_it] != [15]:
        raise SystemExit(f"-resume: {text!r}, reports {d_it}")
    # TSV resume: with model.npz removed, the state comes back from the
    # model TSVs (Trainer.load_model's fallback, which -rmse, -msr,
    # -gen-ranking and -test use); its validation ll and RMSE against the
    # npz state's
    tsv = os.path.join(root, "cli_tsv_model")
    shutil.copytree(out, tsv)
    os.remove(os.path.join(tsv, "model.npz"))
    d, _ = mode("rmse_tsv", ["-rmse", "-load", tsv], copy=False)
    with open(os.path.join(d, "rmse.txt")) as f:
        rmse_tsv = float(f.read())
    tr = train(datdir, os.path.join(root, "cli_ll"), "highest", 10, 5,
               "cuda")
    t0 = time.perf_counter()
    tr.load_model(out)
    ll_npz = tr.compute_likelihood(True)
    tr.load_model(tsv)
    ll_tsv = tr.compute_likelihood(True)
    secs["tsv_load"] = time.perf_counter() - t0
    tr.close()
    rel = max(abs(ll_tsv - ll_npz) / abs(ll_npz),
              abs(rmse_tsv - rmse) / abs(rmse))
    say(f"cli modes: -rmse {rmse:.5f} over {n_scores} test pairs; "
        f"-gen-ranking {len(ranked)} users; -msr {rows} leave-one-out rows; "
        f"-resume from iteration 11, report at 15; TSV state: validation ll "
        f"{ll_tsv:.9f} against {ll_npz:.9f} from model.npz, rmse "
        f"{rmse_tsv:.5f}, worst relative gap {rel:.2e} (bound 1e-5) "
        f"{'ok' if rel < 1e-5 else 'FAIL'}")
    if not rel < 1e-5:
        raise SystemExit("the state read back from the TSVs disagrees with "
                         "model.npz")
    items = [store.seq2movie[0], store.seq2movie[1]]
    d, text = mode("test", ["-test", "-test-items",
                            f"{items[0]},{items[1]}", "-load", out],
                   copy=False)
    titles = text.split("predictions\n", 1)[-1].strip().splitlines()
    if "predictions" not in text or len(titles) != 21:
        raise SystemExit(f"-test printed {text!r}")
    d, _ = mode("nmf", ["-nmf"], copy=False)
    shapes = [np.loadtxt(os.path.join(d, f), ndmin=2).shape
              for f in ("nmf_theta.tsv", "nmf_beta.tsv")]
    if shapes != [(store.n, K + 2), (store.m, K + 2)]:
        raise SystemExit(f"-nmf wrote tables of shapes {shapes}")
    say(f"cli modes: -test printed 21 titles for items {items}; -nmf wrote "
        f"nmf_theta.tsv {shapes[0]} and nmf_beta.tsv {shapes[1]} on the "
        f"card")
    for name, t in secs.items():
        say(f"cli seconds {name}: {t:.2f}")
    return launches_f32, launches_seg


# ---------------------------------------------------------------------------
# the sharded run (hgaprec_tpu_torch/parallel/): one card, so a world of one
# over NCCL, and two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

SHARD_TOL = dict(rtol=1e-4, atol=1e-7)       # tests/test_torch_engine.py
SMALL_N, SMALL_M, SMALL_DRAWS, SMALL_T = 20000, 70000, 300000, 1024


def phase_sharded_cli(df, datdir, root, ref_dir):
    """Phase A: `-devices 2` through the command line on one card clamps
    to one device and trains the sharded loop in-process over a world of
    one (NCCL); its validation ll is held to the single-device run in
    `ref_dir` at every report, and kernel #1's f32 launches are counted.
    Returns (launches, wall seconds)."""
    if torch.cuda.device_count() != 1:
        raise SystemExit("the sharded CLI phase needs exactly one visible "
                         "card (set CUDA_VISIBLE_DEVICES)")
    out = os.path.join(root, "cli_devices")
    df.fused_dense_sweep.launches = 0
    t0 = time.perf_counter()
    text = cli_in_process(
        ["-dir", datdir, "-n", str(N_ML), "-m", str(M_ML), "-k", str(K),
         "-hier", "-rfreq", "5", "-max-iterations", "10", "-devices", "2",
         "-outdir", out])
    wall = time.perf_counter() - t0
    launches = df.fused_dense_sweep.launches
    g, c = validation_ll(out), validation_ll(ref_dir)
    worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(g, c))
    missing = [f for f in ("model.npz", "precision.txt", "ranking.tsv")
               if not os.path.exists(os.path.join(out, f))]
    ok = "+ only 1 devices available (requested 2)" in text and \
        "+ sharding over 1 devices" in text and launches > 0 and \
        [a[0] for a in g] == [b[0] for b in c] and worst < CPU_REL and \
        not missing
    say(f"sharded A: python -m hgaprec_tpu_torch.cli ... -devices 2 "
        f"(in-process, clamped to a world of one over NCCL) in {wall:.1f} s "
        f"wall; f32 dense kernel launches {launches}; validation ll "
        f"{[(i, round(v, 6)) for i, v in g]} against the single-device run: "
        f"worst relative gap {worst:.3e} (bound {CPU_REL}); files "
        f"{'present' if not missing else missing} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the sharded CLI run failed its checks: {text}")
    return launches, wall


def compare_states(got, want, bf16=False):
    """(max abs error, worst key) of two state_to_numpy dicts; raises
    unless every leaf but the log expectations agrees at SHARD_TOL, or
    with bf16 at BF16_REL relative (1e-3 clamp), the bound of `compare`.
    An elog is digamma(a) - log b, which cancels near 0 to the f32 error
    of its O(1) terms; the shape and rate it is computed from are
    held."""
    if sorted(got) != sorted(want):
        raise SystemExit(f"state keys differ: {sorted(got)} {sorted(want)}")
    err, worst = 0.0, None
    for key in (k for k in want if not k.endswith("elog")):
        if bf16:
            rel = np.abs(got[key] - want[key]) / np.maximum(
                np.abs(want[key]), 1e-3)
            if rel.size and not rel.max() < BF16_REL:
                raise SystemExit(f"{key}: relative error {rel.max():.3e} "
                                 f">= {BF16_REL}")
        else:
            np.testing.assert_allclose(got[key], want[key], **SHARD_TOL,
                                       err_msg=key)
        e = float(np.max(np.abs(got[key] - want[key]))) if want[key].size \
            else 0.0
        if e >= err:
            err, worst = e, key
    return err, worst


def allreduce_ms_per_step(run, steps=10):
    """(all-reduce ms per step, device ms per step): the two all-reduces
    of an HPF step ([K] column sums, [M, K] item statistics) on buffers
    of those shapes, timed with CUDA events (median of 5 windows of 20
    steps' worth), and the device time of a whole step under
    torch.profiler over `steps` steps."""
    import torch.distributed as dist
    k = run.cfg.k
    bufs = [torch.ones(k, device="cuda"),
            torch.ones((run.cfg.m, k), device="cuda")]

    def reduce_both():
        for b in bufs:
            dist.all_reduce(b, group=run.group)
    ar_ms = median_ms(reduce_both, 5, batch=20)
    by_kernel = device_ms_by_kernel(run.step, steps)
    if not by_kernel:
        raise SystemExit("torch.profiler saw no device activity")
    return ar_ms, sum(by_kernel.values())


def phase_sharded_run(df, datdir, root):
    """Phase B: ML-1M HPF K=100 through build_sharded_run over a world of
    one (NCCL) in both precisions, held to the single-device Trainer
    after the same steps; ms/iter of both, the all-reduce device time
    per step, and a report's gather seconds for both leaf sets. Returns
    {precision: dict of numbers}."""
    import torch.distributed as dist
    from hgaprec_tpu_torch import cli
    from hgaprec_tpu_torch.config import set_matmul_precision
    from hgaprec_tpu_torch.models.state import state_to_numpy
    from hgaprec_tpu_torch.models.step import cavi_step
    from hgaprec_tpu_torch.parallel import distributed
    from hgaprec_tpu_torch.parallel.sharded import build_sharded_run
    distributed.initialize_from_env(
        "cuda", init_method=f"tcp://localhost:{cli._free_port()}",
        world_size=1, rank=0)
    out = {}
    try:
        for precision in ("highest", "default"):
            tr = train(datdir, os.path.join(root, f"sharded_b_{precision}"),
                       precision, 10, 5, "cuda")
            for _ in range(5):
                tr.step(tr.state, tr.data)
            want = state_to_numpy(tr.state)
            single_ms = steady_ms_per_iter(tr.mcfg, tr.state, tr.data)[0]
            store, mcfg = tr.store, tr.mcfg
            tr.close()
            del tr
            torch.cuda.empty_cache()
            set_matmul_precision(precision)
            t0 = time.perf_counter()
            run = build_sharded_run(store, mcfg, dist.group.WORLD, "cuda")
            build_s = time.perf_counter() - t0
            df.fused_dense_sweep.launches = 0
            for _ in range(5):
                run.step()
            torch.cuda.synchronize()
            launches = df.fused_dense_sweep.launches
            err, worst = compare_states(state_to_numpy(run.unsharded_state()),
                                        want)
            ms, ms_lo, ms_hi = window_ms(run.multi_step)
            # the same shard stepped with no group: the layout and the row
            # mask without the collectives
            local_ms = window_ms(lambda n: [cavi_step(
                run.state, run.data, run.cfg, None, run.row_mask)
                for _ in range(n)])[0]
            ar_ms, dev_ms = allreduce_ms_per_step(run)
            gather = {}
            for leaves in ("full", "eval"):
                secs = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run.unsharded_state(leaves)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                gather[leaves] = statistics.median(secs)
            say(f"sharded B {precision}: build_sharded_run (world of one, "
                f"NCCL) {run.true_n}x{run.cfg.m} in {build_s:.2f} s; "
                f"kernel #1 launches {launches} in 5 steps; state after 5 "
                f"steps against the single-device Trainer's: max abs error "
                f"{err:.3e} ({worst}; rtol 1e-4, atol 1e-7) ok; steady "
                f"{ms:.3f} ms/iter (median of 5 windows of 100; range "
                f"{ms_lo:.3f}-{ms_hi:.3f}) against "
                f"{single_ms:.3f} single-device and {local_ms:.3f} for the "
                f"shard stepped with no group; the step's two all-reduces "
                f"{ar_ms:.4f} ms (CUDA events) beside {dev_ms:.3f} device "
                f"ms per step (torch.profiler); "
                f"report gather full {gather['full'] * 1e3:.2f} ms, eval "
                f"{gather['eval'] * 1e3:.2f} ms")
            if launches == 0:
                raise SystemExit("the sharded run never launched kernel #1")
            out[precision] = dict(launches=launches, max_abs_err=err,
                                  ms_per_iter=ms, single_ms_per_iter=single_ms,
                                  no_group_ms_per_iter=local_ms,
                                  allreduce_ms_per_step=ar_ms,
                                  gather_full_s=gather["full"],
                                  gather_eval_s=gather["eval"])
            del run
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


GLOO_RUNS = (
    ("hybrid_highest", dict(variant="hpf", sweep="hybrid",
                            hybrid_head_items=SMALL_T,
                            matmul_precision="highest")),
    ("hybrid_bf16", dict(variant="hpf", sweep="hybrid",
                         hybrid_head_items=SMALL_T,
                         matmul_precision="default")),
    ("segment", dict(variant="hpf", sweep="segment",
                     matmul_precision="highest")),
)
GLOO_STEPS = 3


def small_store():
    from hgaprec_tpu_torch.data.ratings import RatingsStore
    u, i, y, keys = power_law_coo(SMALL_N, SMALL_M, SMALL_DRAWS, SEED,
                                  cover=True)
    store = RatingsStore(SMALL_N, SMALL_M)
    store.add_training(u, i, y)
    store.finalize()
    return store, keys


def sharded_rank(rank, world, workdir):
    """One rank of phase C (`chip_smoke.py --rank R W DIR`, started by
    phase_sharded_gloo): joins a gloo group (NCCL refuses two ranks on one
    device) through DIR/pg, runs GLOO_RUNS on the card with its shard and
    writes DIR/<run>.rank<R>.json (launches per kernel, ms/iter) and, on
    rank 0, the gathered state after one step and after GLOO_STEPS as
    DIR/<run>.step1.npz and DIR/<run>.npz."""
    import torch.distributed as dist
    from hgaprec_tpu_torch.config import ModelConfig, set_matmul_precision
    from hgaprec_tpu_torch.models.state import state_to_numpy
    from hgaprec_tpu_torch.ops import dense_fused as df
    from hgaprec_tpu_torch.ops import segment_fused as sf
    from hgaprec_tpu_torch.ops import tail_fused as tf
    from hgaprec_tpu_torch.parallel import distributed
    from hgaprec_tpu_torch.parallel.sharded import build_sharded_run
    distributed.initialize_from_env(
        None, init_method="file://" + os.path.join(workdir, "pg"),
        world_size=world, rank=rank)
    store, _ = small_store()
    for name, kw in GLOO_RUNS:
        set_matmul_precision(kw["matmul_precision"])
        cfg = ModelConfig(n=store.n, m=store.m, k=K, **kw)
        run = build_sharded_run(store, cfg, dist.group.WORLD, "cuda")
        counters = (df.fused_dense_sweep, tf.fused_half_sweep,
                    sf.fused_segment_sweep)
        for c in counters:
            c.launches = 0
        run.step()
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        first = state_to_numpy(run.unsharded_state())
        for c in counters:
            c.launches = 0
        for _ in range(GLOO_STEPS - 1):
            run.step()
        torch.cuda.synchronize()
        launches = [a + c.launches for a, c in zip(launches, counters)]
        state = state_to_numpy(run.unsharded_state())
        dist.barrier()
        ms = window_ms(run.multi_step, windows=3, steps=5)[0]
        if rank == 0:
            np.savez(os.path.join(workdir, f"{name}.step1.npz"), **first)
            np.savez(os.path.join(workdir, f"{name}.npz"), **state)
        with open(os.path.join(workdir, f"{name}.rank{rank}.json"), "w") as f:
            json.dump(dict(launches=launches, n_local=run.n_local,
                           ms_per_iter=ms,
                           tail_nnz=(run.data.tail.nnz if run.data.tail
                                     is not None else 0)), f)
        del run
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 0


def phase_sharded_gloo(root):
    """Phase C: two ranks on the one card over gloo (a test harness: it
    is the only way one card shows a real exchange between ranks), on
    the small 20,000 x 70,000 store: the hybrid at "highest" (kernel #1's
    f32 route, kernel #2's f32 route) and in bf16 (kernel #1's wgmma
    route, kernel #2's bf16 route), and the segment sweep (kernel #4).
    Every rank must launch its kernels; the gathered state is held to the
    single-device Trainer's at SHARD_TOL after one step and, at "highest",
    after GLOO_STEPS. In bf16 the later steps are held at the bf16 bound:
    the ranks' partial item sums add in another order than one device's,
    and from the second step such f32 differences in A B^T move W's bf16
    rounding by a whole bf16 step (2^-8) where they cross a rounding
    boundary. Returns {run: [launches of rank 0, of rank 1]} and {run:
    ms/iter}."""
    from hgaprec_tpu_torch.config import ModelConfig, RunConfig
    from hgaprec_tpu_torch.models.engine import Trainer
    from hgaprec_tpu_torch.models.state import state_to_numpy
    workdir = os.path.join(root, "gloo")
    os.makedirs(workdir)
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, here, "--rank", str(r), "2", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    # the single-device references while the ranks run
    store, keys = small_store()
    validation, test = held_out_maps(store, SMALL_N, SMALL_M, keys, SEED + 1,
                                     2000)
    want = {}
    for name, kw in GLOO_RUNS:
        tr = Trainer(store, validation, test,
                     ModelConfig(n=store.n, m=store.m, k=K, **kw),
                     RunConfig(datdir=root, outdir=os.path.join(
                         workdir, f"single_{name}")), device="cuda")
        tr.step(tr.state, tr.data)
        first = state_to_numpy(tr.state)
        for _ in range(GLOO_STEPS - 1):
            tr.step(tr.state, tr.data)
        want[name] = (first, state_to_numpy(tr.state))
        tr.close()
        del tr
        torch.cuda.empty_cache()
    for r, p in enumerate(procs):
        try:
            text = p.communicate(timeout=600)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SystemExit("a gloo rank hung")
        if p.returncode != 0:
            raise SystemExit(f"gloo rank {r} exited {p.returncode}: "
                             f"{text[-4000:]}")
    wall = time.perf_counter() - t0
    launches, ms = {}, {}
    for name, _ in GLOO_RUNS:
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"{name}.rank{r}.json")) as f:
                ranks.append(json.load(f))
        got = []
        for f in (f"{name}.step1.npz", f"{name}.npz"):
            with np.load(os.path.join(workdir, f)) as z:
                got.append({k: z[k] for k in z.files})
        err1, worst1 = compare_states(got[0], want[name][0])
        bf16 = name.endswith("bf16")
        err, worst = compare_states(got[1], want[name][1], bf16=bf16)
        bound = "bf16 relative 2e-2" if bf16 else "rtol 1e-4, atol 1e-7"
        launches[name] = [x["launches"] for x in ranks]
        ms[name] = [x["ms_per_iter"] for x in ranks]
        # [dense, tail, segment] launches each rank must show
        need = [1, 1, 0] if name.startswith("hybrid") else [0, 0, 1]
        ok = all(all(c > 0 for c, n in zip(x["launches"], need) if n)
                 for x in ranks)
        say(f"sharded C {name}: 2 gloo ranks on one card, "
            f"{store.n}x{store.m} nnz={store.nratings:,}, n_local "
            f"{ranks[0]['n_local']}, tail nonzeros per rank "
            f"{[x['tail_nnz'] for x in ranks]}; launches [dense, tail, CSR] "
            f"per rank {launches[name]} in {GLOO_STEPS} steps; gathered state "
            f"against the single-device Trainer's: after one step max abs "
            f"error {err1:.3e} ({worst1}; rtol 1e-4, atol 1e-7), after "
            f"{GLOO_STEPS} {err:.3e} ({worst}; {bound}); "
            f"ms/iter per rank "
            f"{[round(v, 3) for v in ms[name]]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"a gloo rank of {name} launched no kernel")
    say(f"sharded C: {wall:.1f} s wall (rank start-up, store, builds, "
        f"runs; the single-device references meanwhile)")
    return launches, ms


# ---------------------------------------------------------------------------
# the big-sparse hybrid path
# ---------------------------------------------------------------------------

def power_law_coo(n, m, draws, seed, cover=False):
    """scripts/bigsparse_scale_check.py:46-64: user power(3.0), item
    zipf(1.2), deduplicated, user-sorted; also returns the sorted keys
    u * m + i. cover=True adds one nonzero per item and per user, so
    every id of a small catalog is present."""
    rng = np.random.default_rng(seed)
    u = (n * rng.power(3.0, draws)).astype(np.int64)
    i = np.minimum(rng.zipf(1.2, draws) - 1, m - 1).astype(np.int64)
    u = np.minimum(u, n - 1)
    if cover:
        u = np.concatenate([u, rng.integers(0, n, m), np.arange(n)])
        i = np.concatenate([i, np.arange(m), rng.integers(0, m, n)])
    # the harness's stable argsort + dedup of u * m + i gives the sorted
    # distinct keys; an in-place sort gives the same keys faster
    key = u * m + i
    key.sort()
    key = key[np.concatenate([[True], key[1:] != key[:-1]])]
    y = rng.integers(1, 5, key.size).astype(np.float32)
    return ((key // m).astype(np.int32), (key % m).astype(np.int32), y,
            key)


def held_out_maps(store, n, m, keys, seed, count):
    """Validation and test maps of `count` new pairs each, drawn from the
    training distribution and absent from training (keys sorted)."""
    rng = np.random.default_rng(seed)
    draws = 8 * count
    hu = np.minimum((n * rng.power(3.0, draws)).astype(np.int64), n - 1)
    hi = np.minimum(rng.zipf(1.2, draws) - 1, m - 1).astype(np.int64)
    hk = np.unique(hu * m + hi)
    pos = np.minimum(np.searchsorted(keys, hk), keys.size - 1)
    hk = rng.permutation(hk[keys[pos] != hk])
    maps = ({}, {})
    for key in hk:
        un = store.user2seq.get(int(key // m))
        mn = store.movie2seq.get(int(key % m))
        if un is None or mn is None:
            continue
        target = maps[0] if len(maps[0]) < count else maps[1]
        target[(un, mn)] = int(rng.integers(1, 5))
        if len(maps[1]) >= count:
            break
    return maps


def tail_layouts(rng):
    """(name, n, m, u, i, y): tests/test_pallas_tail.py's adversarial
    layouts, a row longer than several warp ranges, untouched rows."""
    def coo(n, m, nnz, gaps=False):
        u = rng.integers(0, n, nnz).astype(np.int32)
        if gaps:
            u = np.where(u % 3 == 0, u, (u * 997) % n).astype(np.int32)
        i = rng.integers(0, m, nnz).astype(np.int32)
        o = np.lexsort((i, u))
        return u[o], i[o], rng.integers(1, 5, nnz).astype(np.float32)
    every = np.repeat(np.arange(700, dtype=np.int32), 4)
    ei = rng.integers(0, 300, every.size).astype(np.int32)
    o = np.lexsort((ei, every))
    longu = np.repeat(np.arange(0, 40, 3, dtype=np.int32), 3000)
    li = rng.integers(0, 3000, longu.size).astype(np.int32)
    lo = np.lexsort((li, longu))
    return [
        ("dense runs", 5000, 900, *coo(5000, 900, 3300)),
        ("large id gaps", 5000, 900, *coo(5000, 900, 3300, gaps=True)),
        ("single short stream", 200, 50, *coo(200, 50, 512)),
        ("every user present", 700, 300, every[o], ei[o],
         rng.integers(1, 4, every.size).astype(np.float32)),
        ("rows of 3000 nonzeros (12 ranges)", 40, 3000, longu[lo], li[lo],
         rng.integers(1, 6, longu.size).astype(np.float32)),
        ("untouched rows", 9000, 2000, *coo(6000, 1500, 20000)),
    ]


def random_lin(gen, n, m, k, bias):
    """Linear factors [A, B] (and biases) exp(0.3 N(0, 1)) on the card."""
    shapes = [(n, k), (m, k)] + ([(n,), (m,)] if bias else [])
    lin = [torch.exp(0.3 * torch.randn(sh, device="cuda", generator=gen))
           for sh in shapes]
    return lin + [None, None] * (not bias)


def tail_f64_err(got, lin, stream):
    """Largest gap of the tail sums `got` from the tail laid out as the
    CSR sweep's COO through that sweep's plain version, whose row sums are
    f64 (ops/segment.py::segment_sweep_reference)."""
    from hgaprec_tpu_torch.data.device import DeviceData
    from hgaprec_tpu_torch.ops import segment as sg
    from hgaprec_tpu_torch.ops.tail import tail_tables
    k = lin[0].shape[1]
    out_a, out_b = sg.segment_sweep_reference(
        *tail_tables(*lin, bf16=False),
        DeviceData(u_ids=stream.u, i_ids=stream.i, y=stream.y,
                   item_order=stream.order, i_ids_sorted=stream.i_by_item,
                   u_ids_by_item=stream.u_by_item, dense_y=None))
    want = (out_a[:, :k], out_b[:, :k]) + ((out_a[:, k], out_b[:, k + 1])
                                           if lin[2] is not None else ())
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def half_timers(tf, a_t, b_t, stream):
    """(user-sorted half, item-sorted half) of the tail route for tables
    a_t, b_t: callables that each run one half alone on outputs and
    scratch made once. bf16: `fused_half_sweep` per half; f32: the CSR
    sweep's user pass, then its item pass over the tail's slab stream,
    reading the weights the user pass left (it runs once here first)."""
    from hgaprec_tpu_torch.ops import segment_fused as sf
    (n, kq), m, s = a_t.shape, b_t.shape[0], stream
    if a_t.dtype == torch.bfloat16:
        return (lambda: tf.fused_half_sweep(a_t, b_t, s.u, s.i, s.y, n),
                lambda: tf.fused_half_sweep(b_t, a_t, s.i_by_item,
                                            s.u_by_item, s.y_by_item, m))
    slabs = tf.tail_slabs(s, n, m, kq)
    sc = sf.Scratch.make(s.nnz, kq, a_t.device)
    out_a = torch.zeros_like(a_t)
    out_b = torch.empty_like(b_t)

    def user():
        sf.user_pass(a_t, b_t, s.u, s.i, s.y, out_a, sc, tail=True)
    user()
    return user, lambda: sf.item_pass(a_t, b_t, slabs, out_b, sc, tail=True)


def check_tail(name, n, m, k, stream, gen, bias, reps, by_kernel=False):
    """Kernel against plain on one stream, both routes (bf16 through
    csrc/tail_bf16.cu, f32 through the two passes of csrc/segment_sweep.cu)
    and rows no nonzero touches zero in both. Returns the bf16
    route's numbers (the main path's) and, under keys ending in _f32, the
    f32 route's, each beside its bound that counts every gathered row, and
    each half timed alone; with by_kernel, each half and both by device
    kernel (torch.profiler)."""
    from hgaprec_tpu_torch.ops import tail as tl
    from hgaprec_tpu_torch.ops import tail_fused as tf
    lin = random_lin(gen, n, m, k, bias)
    ref32 = tl.tail_sweep_reference(*lin, stream, bf16=False)
    untouched = [torch.bincount(ids.long(), minlength=rows) == 0
                 for ids, rows in ((stream.u, n), (stream.i, m))]
    out = {}
    for bf16 in (False, True):
        got = tf.tail_sweep(*lin, stream, bf16=bf16)
        again = tf.tail_sweep(*lin, stream, bf16=bf16)
        like = tl.tail_sweep_reference(*lin, stream, bf16=bf16)
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again)
                        if a is not None)
        pairs = [(g, r) for g, r in zip(got, ref32) if r is not None]
        err = max((g - r).abs().max().item() for g, r in pairs)
        err_like = max((g - r).abs().max().item()
                       for g, r in zip(got, like) if r is not None)
        if bf16:
            ok = all(((g - r).abs() / r.abs().clamp_min(1e-3)).max().item()
                     < BF16_REL for g, r in pairs)
        else:
            ok = all(torch.allclose(g, r, **TAIL_F32_TOL) for g, r in pairs)
        zero = all(g[z].abs().max().item() == 0 if z.any() else True
                   for g, z in zip(got[:2], untouched))
        # f32: also the CSR sweep's plain version, with f64 row sums
        f64 = "" if bf16 else \
            f", f64-sum CSR plain {tail_f64_err(got, lin, stream):.3e}"
        # both halves as a sweep runs them, and each alone, on tables
        # built once
        a_t, b_t = tl.tail_tables(*lin, bf16=bf16)
        ms = median_ms(lambda: tf.tail_halves(a_t, b_t, stream), reps, 5)
        ms_call = median_ms(lambda: tf.tail_halves(a_t, b_t, stream), reps)
        plain_ms = median_ms(
            lambda: tl.halves_reference(a_t, b_t, stream), reps)
        user_fn, item_fn = half_timers(tf, a_t, b_t, stream)
        user_ms, item_ms = median_ms(user_fn, reps), median_ms(item_fn, reps)
        kq = a_t.shape[1]
        nbytes = 2 * stream.nnz * (kq * a_t.element_size() + 12)
        gathered_ms = nbytes / HBM_BPS * 1e3
        say(f"tail kernel [{name}] {n}x{m}x{k} nnz={stream.nnz:,} "
            f"bias={bias} bf16={bf16} ({tf.plan(bf16, kq)[1]} lanes per "
            f"range): max_abs_err vs f32 plain {err:.3e} (vs plain in the "
            f"same mode {err_like:.3e}{f64}), two launches bitwise "
            f"{'equal' if same_bits else 'DIFFERENT'}, untouched rows "
            f"{'zero' if zero else 'NONZERO'} "
            f"{'ok' if ok and same_bits and zero else 'FAIL'}; both halves "
            f"kernel {ms:.4f} ms (5 back-to-back calls per window; "
            f"{ms_call:.4f} one call from an idle card), plain "
            f"{plain_ms:.4f} ms (median of {reps}); "
            f"{nbytes / ms / 1e6:.1f} GB/s of 2 x nnz x (kq x "
            f"{a_t.element_size()} + 12) B, whose bound is "
            f"{gathered_ms:.4f} ms ({100 * gathered_ms / ms:.0f}% of it); "
            f"alone: user-sorted half {user_ms:.4f} ms, item-sorted half "
            f"{item_ms:.4f} ms")
        if not (ok and same_bits and zero):
            raise SystemExit(f"tail kernel disagrees with its plain version "
                             f"[{name}] bias={bias} bf16={bf16}")
        # bound: the tables, both sorted streams and the outputs moved
        # once; dot and axpy of kq per nonzero in each half, f32 FMAs
        once = sum(x.nbytes for x in (a_t, b_t, stream.u, stream.i,
                                      stream.y, stream.i_by_item,
                                      stream.u_by_item, stream.y_by_item))
        bound_ms, bound_by = bound(once + 4 * kq * (n + m),
                                   8 * stream.nnz * kq, F32_FLOPS)
        mode = dict(kq=kq, max_abs_err=err_like, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    gbps=nbytes / ms / 1e6, bound_ms_gathered=gathered_ms,
                    ms_per_call=ms_call, ms_user_half=user_ms,
                    ms_item_half=item_ms)
        if by_kernel:
            split = {half: device_ms_by_kernel(fn, 3) for half, fn in (
                ("user_half", user_fn), ("item_half", item_fn),
                ("both", lambda: tf.tail_halves(a_t, b_t, stream)))}
            for half, kernels in split.items():
                say(f"tail kernel [{name}] bf16={bf16} {half} by device "
                    f"kernel (torch.profiler, ms per call, mean of 3): "
                    f"{ {k: round(v, 4) for k, v in sorted(kernels.items())} }")
            mode["ms_by_device_kernel"] = split
        if bf16:
            out.update(mode, library_ms=None,
                       bound_share_gathered=gathered_ms / ms)
        else:
            slabs = tf.tail_slabs(stream, n, m, kq)
            mode.update(pairs=slabs.pairs, slabs=slabs.slabs)
            out.update({"ms_f32" + key[2:] if key.startswith("ms_") else
                        f"{key}_f32": v for key, v in mode.items()})
    del lin, ref32
    return out


def phase_tail_layouts(gen):
    """Factor widths: K, 13 (a row of a few chunks) and 200 (f32 rows
    wider than one chunk per lane)."""
    from hgaprec_tpu_torch.ops.tail import build_tail_stream
    widths = {"dense runs": 13, "large id gaps": 200}
    for name, n, m, u, i, y in tail_layouts(np.random.default_rng(SEED)):
        stream = build_tail_stream(u, i, y, "cuda")
        for bias in (False, True):
            check_tail(name, n, m, widths.get(name, K), stream, gen, bias, 5)


# ---------------------------------------------------------------------------
# the segment path
# ---------------------------------------------------------------------------

def segment_layouts(rng):
    """tail_layouts plus a power-law catalog whose popular items run over
    many of the kernel's ranges in the item pass."""
    u, i, y, _ = power_law_coo(20000, 3000, 200000, SEED)
    return tail_layouts(rng) + [("power-law items", 20000, 3000, u, i, y)]


def check_segment(name, data, lin, reps, slab_bytes=None):
    """The CSR sweep kernel (both passes) against its plain version on one
    layout and factors `lin` (a_lin, b_lin, ba_lin | None, bb_lin | None),
    its item pass cut into user slabs of `slab_bytes` (the wrapper's
    budget by default): tolerance, two launches bitwise equal, untouched
    rows zero."""
    from hgaprec_tpu_torch.ops import segment as sg
    from hgaprec_tpu_torch.ops import segment_fused as sf
    from hgaprec_tpu_torch.ops.tail import tail_tables
    (n, k), m, bias = lin[0].shape, lin[1].shape[0], lin[2] is not None
    slab_bytes = slab_bytes or sf.SLAB_BYTES
    a_t, b_t = tail_tables(*lin, bf16=False)
    got = sf.fused_segment_sweep(a_t, b_t, data, slab_bytes)
    again = sf.fused_segment_sweep(a_t, b_t, data, slab_bytes)
    ref = sg.segment_sweep_reference(a_t, b_t, data)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(g, a) for g, a in zip(got, again))
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    tol = SEG_TOL if name == "echonest" else TAIL_F32_TOL
    ok = all(torch.allclose(g, r, **tol) for g, r in zip(got, ref))
    live = data.y > 0
    untouched = [torch.bincount(ids[live].long(), minlength=rows) == 0
                 for ids, rows in ((data.u_ids, n), (data.i_ids, m))]
    zero = all(g[z].abs().max().item() == 0 if z.any() else True
               for g, z in zip(got, untouched))
    ms = median_ms(lambda: sf.fused_segment_sweep(a_t, b_t, data,
                                                  slab_bytes), reps)
    plain_ms = median_ms(lambda: sg.segment_sweep_reference(a_t, b_t, data),
                         min(reps, 2) if name == "echonest" else reps)
    p, kq = data.nnz_padded, a_t.shape[1]
    slabs = sf.data_slabs(data, n, m, kq, slab_bytes)
    nbytes = 2 * p * (kq * 4 + 12) + 8 * p
    ranges = -(-int(torch.bincount(data.i_ids_sorted.long()).max()) //
               sf.RANGE) + 1
    say(f"segment kernel [{name}] {n}x{m}x{k} nnz={int(live.sum()):,} "
        f"padded {p:,} bias={bias} slabs={slabs.slabs} ((slab, item) rows "
        f"{slabs.pairs:,}; budget {slab_bytes:,} B): max_abs_err vs plain "
        f"{err:.3e}, two launches bitwise "
        f"{'equal' if same_bits else 'DIFFERENT'}, untouched rows "
        f"{'zero' if zero else 'NONZERO'} "
        f"{'ok' if ok and same_bits and zero else 'FAIL'}; longest item row "
        f"over {ranges} ranges; both passes kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; {nbytes / ms / 1e6:.1f} GB/s of "
        f"2 x P x (kq x 4 + 12) + 8 P B")
    if not (ok and same_bits and zero):
        raise SystemExit(f"segment kernel disagrees with its plain version "
                         f"[{name}] bias={bias} slabs={slabs.slabs}")
    # bound: the tables, the COO arrays the kernel reads (the user-sorted
    # stream and the slab stream) and the outputs moved once; dot and axpy
    # of kq per nonzero in each pass, f32 FMAs
    once = sum(x.nbytes for x in (a_t, b_t, data.u_ids, data.i_ids, data.y,
                                  slabs.pair, slabs.u, slabs.order))
    bound_ms, bound_by = bound(once + 4 * kq * (n + m), 8 * p * kq, F32_FLOPS)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, gbps=nbytes / ms / 1e6,
                bound_ms_gathered=nbytes / HBM_BPS * 1e3, slabs=slabs.slabs,
                slab_pairs=slabs.pairs)


def phase_segment_layouts(gen):
    """Every layout at K and at a small K, bias off and on, padded to a
    ragged multiple of 1000 entries (padding: y = 0, ids = last row), with
    the item pass in one slab (the wrapper's budget) and in about six (a
    budget of a sixth of the user table and the weights)."""
    from hgaprec_tpu_torch.data.device import DeviceData, sorted_coo
    for name, n, m, u, i, y in segment_layouts(np.random.default_rng(SEED)):
        data = DeviceData(**sorted_coo(u, i, y, n, m, "cuda", 1000),
                          dense_y=None)
        for k in (K, 13):
            kq = -(-(k + 2) // 4) * 4
            small = (4 * kq * n + 4 * data.nnz_padded) // 6
            for bias in (False, True):
                lin = random_lin(gen, n, m, k, bias)
                one = check_segment(name, data, lin, 3)
                several = check_segment(name, data, lin, 3, small)
                if one["slabs"] != 1 or several["slabs"] < 2:
                    raise SystemExit(f"segment layout [{name}] gave "
                                     f"{one['slabs']} and "
                                     f"{several['slabs']} slabs")


def logl_rows(outdir):
    with open(os.path.join(outdir, "logl.txt")) as f:
        return [float(r) for r in f if r.strip()]


def phase_echonest_segment(df, tf, hybrid, root, smi):
    """HPF K=100 at EchoNest shape through the Trainer with
    sweep="segment-chunked" and the training ELBO, on the hybrid phase's
    store: every nonzero through the CSR sweep kernel, twice per step."""
    from hgaprec_tpu_torch.config import ModelConfig, RunConfig
    from hgaprec_tpu_torch.models.engine import Trainer
    from hgaprec_tpu_torch.models.step import _resolve_mode
    from hgaprec_tpu_torch.ops import segment_fused as sf
    from hgaprec_tpu_torch.ops.sweep import sweep
    store = hybrid.store
    t0 = time.perf_counter()
    tr = Trainer(store, hybrid.validation, hybrid.test,
                 ModelConfig(n=store.n, m=store.m, k=K, variant="hpf",
                             sweep="segment-chunked"),
                 RunConfig(datdir=hybrid.rcfg.datdir,
                           outdir=os.path.join(root, "en_seg"), rfreq=5,
                           max_iterations=5, logl=True), device="cuda")
    torch.cuda.synchronize()
    data = tr.data
    mode = _resolve_mode(tr.mcfg, data)
    say(f"echonest segment Trainer built in {time.perf_counter() - t0:.1f} "
        f"s host; mode {mode}; dense_y "
        f"{'built' if data.dense_y is not None else 'none'}, head "
        f"{'built' if data.head_dense_y is not None else 'none'}; COO "
        f"{data.nnz_padded:,} padded entries")
    if mode != "segment-chunked" or data.dense_y is not None or \
            data.head_dense_y is not None:
        raise SystemExit("the EchoNest segment layout is not COO only")
    torch.cuda.reset_peak_memory_stats()
    df.fused_dense_sweep.launches = 0
    tf.fused_half_sweep.launches = 0
    sf.fused_segment_sweep.launches = 0
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (sf.fused_segment_sweep.launches,
                df.fused_dense_sweep.launches, tf.fused_half_sweep.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tr.close()
    if launches[0] == 0 or launches[1:] != (0, 0):
        raise SystemExit(f"the segment path's launches (segment, dense, "
                         f"tail) are {launches}")
    ll, logl = validation_ll(tr.outdir), logl_rows(tr.outdir)
    if len(ll) < 2 or len(logl) != len(ll) or \
            not all(np.isfinite(v) for _, v in ll) or \
            not all(np.isfinite(v) for v in logl):
        raise SystemExit(f"echonest segment ll {ll}, logl {logl}")
    ms_iter, ms_lo, ms_hi = steady_ms_per_iter(tr.mcfg, tr.state, data,
                                               windows=5, steps=10)
    # the kernel alone on the trained state, as one step calls it
    st = tr.state
    lin = [torch.exp(st.theta.elog), torch.exp(st.beta.elog), None, None]
    kernel = check_segment("echonest", data, lin, 5)
    kernel.update(segment_passes(data, lin, smi))
    fast = kernel["ms"] < kernel["bound_ms_gathered"]
    say(f"echonest segment kernel, both passes, {kernel['ms']:.4f} ms "
        f"(wrapper, zero-filled outputs included) against "
        f"{kernel['bound_ms_gathered']:.4f} ms, one HBM gather per nonzero "
        f"{'ok' if fast else 'FAIL'}")
    if not fast:
        raise SystemExit("the CSR sweep kernel is no faster than one HBM "
                         "gather per nonzero on the trained EchoNest state")
    say(f"echonest segment main path: Trainer HPF K={K} {store.n:,}x"
        f"{store.m:,} nnz={store.nratings:,} sweep=segment-chunked -> "
        f"{mode}; 6 iterations in {wall:.1f} s wall (reports, ELBO and "
        f"saves included); launches: segment kernel {launches[0]}, dense "
        f"{launches[1]}, tail {launches[2]}; validation ll by report "
        f"{[(i, round(v, 6)) for i, v in ll]}; logl.txt {logl}; peak card "
        f"memory {peak:.2f} GB")
    say(f"echonest segment steady state {ms_iter:.2f} ms/iter = "
        f"{1e3 / ms_iter:.2f} iters/s (median of 5 windows of 10; range "
        f"{ms_lo:.2f}-{ms_hi:.2f}): segment kernel {kernel['ms']:.2f} ms "
        f"(both passes; plain {kernel['plain_ms']:.1f} ms), rest "
        f"{ms_iter - kernel['ms']:.2f} ms; {kernel['gbps']:.1f} GB/s of the "
        f"counted bytes on {smi}")
    # one sweep on one fixed state: the CSR kernel against the hybrid
    # (head and tail kernels) at "highest"
    e = (st.theta.elog, st.beta.elog, None, None)
    seg = sweep(*e, data, "segment-chunked")
    hyb = sweep(*e, hybrid.data, "hybrid", precision="highest")
    torch.cuda.synchronize()
    err = max((g - r).abs().max().item() for g, r in zip(seg[:2], hyb[:2]))
    ok = all(torch.allclose(g, r, **SEG_TOL) for g, r in zip(seg[:2],
                                                            hyb[:2]))
    say(f"echonest segment sweep vs hybrid sweep at highest, one state: "
        f"max_abs_err {err:.3e} (rtol 2e-4, atol 1e-5) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the segment and hybrid sweeps disagree")
    del seg, hyb
    return dict(launches=launches[0], peak=peak, ms_iter=ms_iter, **kernel)


def segment_passes(data, lin, smi):
    """Each pass of the CSR sweep kernel timed alone on `data` (CUDA
    events, median of 5) beside its bounds (every input once; one gathered
    row, ids and weight per nonzero), the slab stream's build, the item
    pass at other slab budgets, and the kernels by name (torch.profiler).
    """
    from hgaprec_tpu_torch.ops import segment_fused as sf
    from hgaprec_tpu_torch.ops.tail import tail_tables
    a_t, b_t = tail_tables(*lin, bf16=False)
    (n, kq), m, p = a_t.shape, b_t.shape[0], data.nnz_padded
    data.slab_cache.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slabs = sf.data_slabs(data, n, m, kq)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_bytes = sum(x.nbytes for x in (
        slabs.pair, slabs.u, slabs.order, slabs.pair_item, slabs.item_start,
        slabs.item_pairs))
    sc = sf.Scratch.make(p, kq, a_t.device)
    out_a, out_b = torch.zeros_like(a_t), torch.zeros_like(b_t)
    user_ms = median_ms(lambda: sf.user_pass(
        a_t, b_t, data.u_ids, data.i_ids, data.y, out_a, sc), 5)
    item_ms = median_ms(lambda: sf.item_pass(a_t, b_t, slabs, out_b, sc), 5)
    row, ids = 4 * kq, 12 * p
    passes = {}
    for name, ms, table, out in (("user", user_ms, b_t, out_a),
                                 ("item", item_ms, a_t, out_b)):
        strict = bound(a_t.nbytes + b_t.nbytes + ids + out.nbytes, 4 * p * kq,
                       F32_FLOPS)[0]
        gathered = p * (row + 16) / HBM_BPS * 1e3
        passes[name] = dict(ms=ms, bound_ms=strict, bound_ms_gathered=gathered)
        say(f"echonest segment {name} pass alone: {ms:.4f} ms; bound "
            f"{strict:.4f} ms (every input once), {gathered:.4f} ms (one "
            f"{row} B row, ids and w per nonzero) on {smi}")
    say(f"echonest slab stream: {slabs.slabs} slabs of at most "
        f"{sf.SLAB_BYTES:,} B of A rows and w, {slabs.pairs:,} (slab, item) "
        f"pair rows ({2 * row * slabs.pairs / 1e9:.3f} GB written and read "
        f"again); built in {build_s:.3f} s on the card, "
        f"{build_bytes / 1e9:.3f} GB")
    trade = {}
    for budget in (1 << 40, 12 << 20, 48 << 20):
        st = sf.data_slabs(data, n, m, kq, budget)
        ms = median_ms(lambda: sf.item_pass(a_t, b_t, st, out_b, sc), 5)
        trade[str(budget)] = dict(slabs=st.slabs, pairs=st.pairs, ms=ms)
        data.slab_cache.pop((n, m, kq, budget, 0))
        say(f"echonest item pass at a slab budget of {budget:,} B: "
            f"{st.slabs} slabs, {st.pairs:,} (slab, item) rows, {ms:.4f} ms")
        del st
    by_kernel = device_ms_by_kernel(
        lambda: sf.fused_segment_sweep(a_t, b_t, data), 3)
    say(f"echonest segment kernel by device kernel (torch.profiler, ms per "
        f"sweep, mean of 3): "
        f"{ {k: round(v, 4) for k, v in sorted(by_kernel.items())} }")
    del a_t, b_t, sc, out_a, out_b
    return dict(user_pass=passes["user"], item_pass=passes["item"],
                slab_build_s=build_s, slab_build_bytes=build_bytes,
                item_pass_by_slab_budget=trade,
                ms_by_device_kernel=by_kernel)


def phase_segment_cpu_reference(root):
    """Five small segment runs on the card and on the CPU at "highest",
    each with the training ELBO: the CPU run is the reference here, not a
    fallback."""
    from hgaprec_tpu_torch.config import ModelConfig, RunConfig
    from hgaprec_tpu_torch.data.ratings import RatingsStore
    from hgaprec_tpu_torch.models.engine import Trainer
    from hgaprec_tpu_torch.ops import segment_fused as sf
    n, m = 20000, 70000
    u, i, y, keys = power_law_coo(n, m, 300000, SEED, cover=True)
    store = RatingsStore(n, m)
    store.add_training(u, i, y)
    store.finalize()
    validation, test = held_out_maps(store, n, m, keys, SEED + 1, 2000)
    launches = 0
    for name, kw in (("hpf", dict(variant="hpf")),
                     ("bpf+bias", dict(variant="bpf", bias=True)),
                     ("mle_user", dict(variant="mle_user")),
                     ("mle_item", dict(variant="mle_item")),
                     ("canny", dict(variant="canny"))):
        out = {}
        for device in ("cuda", "cpu"):
            outdir = os.path.join(root, f"seg_{name}_{device}")
            before = sf.fused_segment_sweep.launches
            tr = Trainer(store, validation, test,
                         ModelConfig(n=store.n, m=store.m, k=K,
                                     sweep="segment",
                                     matmul_precision="highest", **kw),
                         RunConfig(datdir=root, outdir=outdir, rfreq=5,
                                   max_iterations=10, logl=True,
                                   enforce_max_iterations=True),
                         device=device)
            t0 = time.perf_counter()
            tr.run()
            tr.close()
            out[device] = (validation_ll(outdir), logl_rows(outdir),
                           time.perf_counter() - t0)
            if device == "cuda":
                launches += sf.fused_segment_sweep.launches - before
        (gl, ge, gs), (cl, ce, cs) = out["cuda"], out["cpu"]
        gaps = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(gl, cl)] + \
            [abs(a - b) / abs(b) for a, b in zip(ge, ce)]
        ok = [a[0] for a in gl] == [b[0] for b in cl] and len(gl) >= 3 and \
            len(ge) == len(ce) == len(gl) and max(gaps) < CPU_REL
        say(f"segment {name} {store.n}x{store.m} nnz={store.nratings:,} "
            f"K={K} at highest, 11 iterations: card {gs:.1f} s, CPU "
            f"{cs:.1f} s; validation ll {[round(v, 6) for _, v in gl]}, "
            f"logl {ge}; worst relative gap card vs CPU {max(gaps):.3e} "
            f"over {len(gaps)} values (bound {CPU_REL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"segment {name}: card and CPU runs disagree")
    return launches


def timed(obj, name, sink):
    """Wrap obj.name so each call's host seconds land in `sink`."""
    real = getattr(obj, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        sink.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, wrapper)
    return real


def echonest_trainer(root):
    """The EchoNest store, maps and Trainer (its layout built by the
    Trainer, as a user's run builds it)."""
    from hgaprec_tpu_torch.config import ModelConfig, RunConfig
    from hgaprec_tpu_torch.data.ratings import RatingsStore
    from hgaprec_tpu_torch.models import engine
    t0 = time.perf_counter()
    u, i, y, keys = power_law_coo(N_EN, M_EN, EN_DRAWS, EN_SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = RatingsStore(N_EN, M_EN)
    store.add_training(u, i, y)
    store.finalize()
    validation, test = held_out_maps(store, N_EN, M_EN, keys, EN_SEED + 1,
                                     10000)
    t_store = time.perf_counter() - t0
    del u, i, y, keys
    say(f"echonest data: {store.nratings:,} training nonzeros (the "
        f"harness gave {EN_NNZ:,}; numpy {np.__version__}), {store.n:,} "
        f"users x {store.m:,} items present, {len(validation)} validation "
        f"/ {len(test)} test pairs; host {t_gen:.1f} s to generate, "
        f"{t_store:.1f} s to ingest and sort")
    if abs(store.nratings / EN_NNZ - 1) > 1e-3:
        raise SystemExit("the EchoNest generator drifted from the harness")
    datdir = os.path.join(root, "echonest")
    os.makedirs(datdir, exist_ok=True)
    users = sorted({store.seq2user[un] for un, _ in test})[:1000]
    with open(os.path.join(datdir, "test_users.tsv"), "w") as f:
        f.write("".join(f"{x}\n" for x in users))
    layout = []
    real = timed(engine, "build_device_data", layout)
    t0 = time.perf_counter()
    try:
        tr = engine.Trainer(
            store, validation, test,
            ModelConfig(n=store.n, m=store.m, k=K, variant="hpf",
                        matmul_precision="default"),
            RunConfig(datdir=datdir, outdir=os.path.join(root, "en_out"),
                      rfreq=5, max_iterations=10), device="cuda")
    finally:
        engine.build_device_data = real
    torch.cuda.synchronize()
    say(f"echonest Trainer built in {time.perf_counter() - t0:.1f} s host "
        f"(device layout {layout[0]:.1f} s; the rest is the initial state "
        f"and the marginals)")
    return tr


def phase_echonest_tail(data, n, m, gen, smi):
    """The tail kernel on the EchoNest tail, before training, both routes,
    each half alone and by device kernel, and the f32 route's item half by
    slab budget. The f32 route must take less than 1.5x the bf16 route's
    time (the main path's) there, both timed over back-to-back calls as a
    training step issues them."""
    tail = check_tail("echonest tail", n, m, K, data.tail, gen, False, 5,
                      by_kernel=True)
    check_tail("echonest tail", n, m, K, data.tail, gen, True, 3)
    tail.update(tail_slab_trade(data, n, m, gen, smi))
    torch.cuda.empty_cache()
    # the bf16 wrapper's zero-filled outputs, inside its timed window:
    # timed alone at its width
    kq = tail["kq"]
    tail["zero_fill_ms"] = median_ms(
        lambda: [torch.zeros((r, kq), device="cuda") for r in (n, m)], 5)
    ratio = tail["ms_f32"] / tail["ms"]
    ratio_call = tail["ms_f32_per_call"] / tail["ms_per_call"]
    say(f"tail kernel at the EchoNest tail, both halves, on {smi}: bf16 "
        f"route {tail['ms']:.4f} ms ({tail['gbps']:.1f} GB/s; gathered "
        f"bound {tail['bound_ms_gathered']:.4f} ms, "
        f"{100 * tail['bound_share_gathered']:.0f}% of it), f32 route "
        f"{tail['ms_f32']:.4f} ms ({ratio:.2f}x the bf16 route; "
        f"{tail['gbps_f32']:.1f} GB/s; gathered figure "
        f"{tail['bound_ms_gathered_f32']:.4f} ms; bound "
        f"{tail['bound_ms_f32']:.4f} ms, "
        f"{100 * tail['bound_ms_f32'] / tail['ms_f32']:.1f}% of it); one "
        f"call from an idle card: bf16 {tail['ms_per_call']:.4f} ms, f32 "
        f"{tail['ms_f32_per_call']:.4f} ms ({ratio_call:.2f}x); both routes "
        f"include their zero-fills, the bf16 route's "
        f"{tail['zero_fill_ms']:.4f} ms alone at kq = {kq} "
        f"{'ok' if ratio < 1.5 else 'FAIL'}")
    if ratio >= 1.5:
        raise SystemExit("the f32 tail route takes 1.5x the bf16 route's "
                         "time or more at the EchoNest tail")
    return tail


def tail_slab_trade(data, n, m, gen, smi):
    """The f32 route's slab stream of the EchoNest tail: its build on the
    card (seconds, bytes, pairs) and the item half alone at slab budgets of
    one slab, 12, 24 and 48 MB, each with every item in slab order (fill
    0) and with the sparse items first (fills 2, 4 and 8), each time checking
    that the item rows outside the tail (the head's) read zero."""
    from hgaprec_tpu_torch.ops import segment_fused as sf
    from hgaprec_tpu_torch.ops import tail as tl
    from hgaprec_tpu_torch.ops import tail_fused as tf
    s = data.tail
    a_t, b_t = tl.tail_tables(*random_lin(gen, n, m, K, False), bf16=False)
    kq = a_t.shape[1]
    s.slab_cache.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slabs = tf.tail_slabs(s, n, m, kq)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_bytes = sum(x.nbytes for x in (
        slabs.pair, slabs.u, slabs.order, slabs.pair_item, slabs.item_start,
        slabs.item_pairs))
    say(f"echonest tail slab stream: {slabs.slabs} slabs of at most "
        f"{tf.SLAB_BYTES:,} B of A rows and w after {slabs.cold:,} entries "
        f"of sparse items in item order (fill {tf.SLAB_FILL}), "
        f"{slabs.pairs:,} (slab, item) pair rows ({slabs.pairs / s.nnz:.3f} "
        f"per nonzero; {2 * 4 * kq * slabs.pairs / 1e9:.3f} GB written and "
        f"read again); built in {build_s:.3f} s on the card, "
        f"{build_bytes / 1e9:.3f} GB")
    sc = sf.Scratch.make(s.nnz, kq, a_t.device)
    out_a, out_b = torch.zeros_like(a_t), torch.empty_like(b_t)
    sf.user_pass(a_t, b_t, s.u, s.i, s.y, out_a, sc, tail=True)
    head = data.head_items.long()
    trade = {}
    for budget in (1 << 40, 12 << 20, 24 << 20, 48 << 20):
        for fill in (0, 2, 4, 8):
            st = tf.tail_slabs(s, n, m, kq, budget, fill)
            out_b.fill_(float("nan"))
            ms = median_ms(lambda: sf.item_pass(a_t, b_t, st, out_b, sc,
                                                tail=True), 5)
            zero = out_b[head].abs().max().item() == 0
            trade[f"{budget}/{fill}"] = dict(slabs=st.slabs, cold=st.cold,
                                             pairs=st.pairs, ms=ms)
            if (budget, fill) != (tf.SLAB_BYTES, tf.SLAB_FILL):
                s.slab_cache.pop((n, m, kq, budget, fill))
            say(f"echonest tail item half at a slab budget of {budget:,} B, "
                f"fill {fill}: {st.cold:,} entries in item order, then "
                f"{st.slabs} slabs; {st.pairs:,} (slab, item) rows, "
                f"{ms:.4f} ms on {smi}; head item rows "
                f"{'zero ok' if zero else 'NONZERO FAIL'}")
            if not zero:
                raise SystemExit("the f32 tail's item half left a head item "
                                 "row nonzero")
            del st
    del a_t, b_t, sc, out_a, out_b
    return dict(slab_build_s_f32=build_s, slab_build_bytes_f32=build_bytes,
                cold_f32=slabs.cold, item_half_by_slab_budget_f32=trade)


def phase_echonest(df, tf, tr, gen, smi):
    """Check the layout, the head kernel and the tail kernel at EchoNest
    shape, then train HPF K=100 through the Trainer on the hybrid path."""
    from hgaprec_tpu_torch.eval import ranking
    from hgaprec_tpu_torch.models.step import _resolve_mode
    from hgaprec_tpu_torch.ops import tail as tl
    data = tr.data
    mode = _resolve_mode(tr.mcfg, data)
    t = data.head_items.shape[0]
    deg = np.bincount(tr.store.coo_i, minlength=tr.store.m)
    cover = float(np.sort(deg)[::-1][:t].sum()) / tr.store.nratings
    say(f"echonest layout: mode {mode}; dense_y "
        f"{'built' if data.dense_y is not None else 'none'}; head "
        f"{tuple(data.head_dense_y.shape)} u8 (T={t}, expected {EN_T}; "
        f"{data.head_dense_y.numel() / 1e9:.2f} GB), coverage {cover:.4f} "
        f"(harness {EN_COVERAGE}); tail {data.tail.nnz:,} nonzeros "
        f"(harness {EN_TAIL:,}); card memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    in_tail = tr.store.nratings - data.tail.nnz
    if (mode != "hybrid" or data.dense_y is not None or t != EN_T or
            abs(cover - EN_COVERAGE) > 2e-3 or
            abs(in_tail / tr.store.nratings - cover) > 1e-6 or
            abs(data.tail.nnz / EN_TAIL - 1) > 1e-2):
        raise SystemExit("the EchoNest layout is not the expected hybrid")

    # the head kernel at the head shape (offsets past 2^31 bytes of Y): each
    # route twice (bitwise equal) beside its bound, f32 faster than the
    # plain version
    from hgaprec_tpu_torch.ops import dense_probe as dp
    n, m = tr.store.n, tr.store.m
    a_lin = torch.exp(0.3 * torch.randn((n, K), device="cuda",
                                        generator=gen))
    b_head = torch.exp(0.3 * torch.randn((t, K), device="cuda",
                                         generator=gen))
    hy = data.head_dense_y
    ref = df.fused_dense_sweep_reference(a_lin, b_head, hy)
    head = {}
    for bf16 in (False, True):
        got = df.fused_dense_sweep(a_lin, b_head, hy, bf16=bf16)
        again = df.fused_dense_sweep(a_lin, b_head, hy, bf16=bf16)
        torch.cuda.synchronize()
        err, ok = compare(got, ref, bf16)
        ok &= all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again
        ms = median_ms(lambda: df.fused_dense_sweep(
            a_lin, b_head, hy, bf16=bf16), 5)
        plain_ms = median_ms(lambda: df.fused_dense_sweep_reference(
            a_lin, b_head, hy, bf16=bf16), 3)
        line = (f"head kernel {n}x{t}x{K} ldy={hy.stride(0)} bf16={bf16}: "
                f"max_abs_err vs f32 plain {err:.3e}, two launches bitwise "
                f"equal {'ok' if ok else 'FAIL'}; kernel {ms:.2f} ms, plain "
                f"{plain_ms:.2f} ms; "
                f"{tflops(n, t, K, ms, 'wgmma' if bf16 else 'f32')}")
        if bf16:
            bound_ms, bound_by = dense_bound(n, t, K)
        else:           # the f32 route must beat its plain version
            bound_ms, bound_by = dense_bound_f32(n, t, K)
            ok &= ms < plain_ms
        line += (f"; bound {bound_ms:.2f} ms ({bound_by}), kernel at "
                 f"{ms / bound_ms:.2f}x it")
        say(line)
        if not ok:
            raise SystemExit("head kernel disagrees with its plain version or "
                             "itself, or (f32) is slower than the plain "
                             "version")
        head[bf16] = (ms, plain_ms, bound_ms)
    del a_lin, b_head, ref

    tail = phase_echonest_tail(data, n, m, gen, smi)
    report_s, topk_calls = [], []
    timed(tr, "report", report_s)
    timed(tr, "do_on_stop", report_s)
    streamed = {nm: getattr(ranking, nm)
                for nm in ("masked_topk", "item_ranks")}
    for nm, f in streamed.items():
        setattr(ranking, nm, (lambda f, nm: lambda *a, **kw: (
            topk_calls.append(nm), f(*a, **kw))[1])(f, nm))
    torch.cuda.reset_peak_memory_stats()
    df.fused_dense_sweep.launches = 0
    tf.fused_half_sweep.launches = 0
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (df.fused_dense_sweep.launches, tf.fused_half_sweep.launches)
    tr.close()
    for nm, f in streamed.items():
        setattr(ranking, nm, f)
    if min(launches) == 0:
        raise SystemExit(f"the hybrid path skipped a kernel: {launches}")
    outdir = tr.outdir
    ll = validation_ll(outdir)
    if len(ll) < 3 or not all(np.isfinite(v) for _, v in ll):
        raise SystemExit(f"echonest validation ll not finite: {ll}")
    contract = ("param.txt", "validation.txt", "test.txt", "precision.txt",
                "max.txt", "htheta.tsv", "hbeta.tsv", "model.npz",
                "ranking.tsv", "itemrank.tsv")
    missing = [f for f in contract if not os.path.exists(
        os.path.join(outdir, f))]
    with open(os.path.join(outdir, "precision.txt")) as f:
        prec = [r.split("\t") for r in f.read().splitlines() if r]
    if missing or not prec or "masked_topk" not in topk_calls or \
            "item_ranks" not in topk_calls:
        raise SystemExit(f"echonest contract: missing {missing}, precision "
                         f"rows {len(prec)}, streamed calls {topk_calls}")
    ms_iter, ms_lo, ms_hi = steady_ms_per_iter(tr.mcfg, tr.state, tr.data,
                                               windows=5, steps=10)
    # the kernels alone on the trained state, as one step calls them
    st = tr.state
    a_lin, b_lin = torch.exp(st.theta.elog), torch.exp(st.beta.elog)
    hd = data.head_items.long()
    head_ms = median_ms(lambda: df.fused_dense_sweep(
        a_lin, b_lin[hd], data.head_dense_y, bf16=True), 10)
    a_t, b_t = tl.tail_tables(a_lin, b_lin, None, None, bf16=True)
    s = data.tail
    tail_ms = median_ms(lambda: (
        tf.fused_half_sweep(a_t, b_t, s.u, s.i, s.y, n),
        tf.fused_half_sweep(b_t, a_t, s.i_by_item, s.u_by_item,
                            s.y_by_item, m)), 10)
    say(f"echonest main path: Trainer HPF K={K} {n:,}x{m:,} "
        f"nnz={tr.store.nratings:,} precision=default sweep=auto -> "
        f"{mode}; 11 iterations in {wall:.1f} s wall (reports included); "
        f"launches: head kernel {launches[0]}, tail kernel {launches[1]}; "
        f"validation ll by report {[(i, round(v, 6)) for i, v in ll]}; "
        f"precision@10 by report {[float(r[1]) for r in prec]} through "
        f"{sorted(set(topk_calls))}; contract files present; host s per "
        f"report {[round(x, 2) for x in report_s]} (last: save + ranking "
        f"for test_users.tsv); peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rest_ms = ms_iter - head_ms - tail_ms
    say(f"echonest steady state {ms_iter:.2f} ms/iter = "
        f"{1e3 / ms_iter:.2f} iters/s (median of 5 windows of 10; range "
        f"{ms_lo:.2f}-{ms_hi:.2f}): head kernel {head_ms:.2f} ms "
        f"({100 * head_ms / ms_iter:.0f}%), bf16 tail kernel "
        f"{tail_ms:.2f} ms ({100 * tail_ms / ms_iter:.0f}%, both halves), "
        f"rest {rest_ms:.2f} ms ({100 * rest_ms / ms_iter:.0f}%)")
    # the default precision, "highest" (f32 head and tail), on the same
    # trained state
    hcfg = dataclasses.replace(tr.mcfg, matmul_precision="highest")
    before = (df.fused_dense_sweep.launches, tf.fused_half_sweep.launches)
    torch.cuda.reset_peak_memory_stats()
    hi_iter, hi_lo, hi_hi = steady_ms_per_iter(hcfg, st, data, windows=3,
                                               steps=5)
    hi_peak = torch.cuda.max_memory_allocated() / 1e9
    hi_launches = (df.fused_dense_sweep.launches - before[0],
                   tf.fused_half_sweep.launches - before[1])
    head_f32_ms = median_ms(lambda: df.fused_dense_sweep(
        a_lin, b_lin[hd], data.head_dense_y), 3)
    a32, b32 = tl.tail_tables(a_lin, b_lin, None, None, bf16=False)
    tail_f32_ms = median_ms(lambda: tf.tail_halves(a32, b32, s), 5)
    glue_ms = hi_iter - head_f32_ms - tail_f32_ms
    say(f"echonest steady state at highest (f32) {hi_iter:.2f} ms/iter = "
        f"{1e3 / hi_iter:.2f} iters/s (median of 3 windows of 5; range "
        f"{hi_lo:.2f}-{hi_hi:.2f}; launches: f32 head kernel "
        f"{hi_launches[0]}, f32 tail kernel {hi_launches[1]}; peak card "
        f"memory {hi_peak:.2f} GB): head kernel {head_f32_ms:.2f} ms "
        f"({100 * head_f32_ms / hi_iter:.0f}%), f32 tail kernel "
        f"{tail_f32_ms:.2f} ms ({100 * tail_f32_ms / hi_iter:.0f}%, both "
        f"halves), rest {glue_ms:.2f} ms ({100 * glue_ms / hi_iter:.0f}%)")
    if min(hi_launches) == 0 or hi_launches[1] != 2 * hi_launches[0]:
        raise SystemExit(f"the hybrid step at highest launched the f32 head "
                         f"and tail kernels {hi_launches} times")
    # the f32 route's probe stages on the trained head (kernel #3)
    head_lin = (a_lin, b_lin[hd].contiguous())
    times, probe_launches = time_probe(dp, head_lin, data.head_dense_y,
                                       False, 5)
    # W = Y and W = 1 sum hundreds of thousands of raw terms for a head
    # item of the trained state, whose factors span orders of magnitude:
    # the kernel's sequential f32 sums lose more of the small terms than
    # cuBLAS's blocked ones, so each stage is held to its f64 sums at the
    # summation bound
    errs, plain = check_probe_stages(
        df, dp, head_lin, data.head_dense_y, False, "echonest head",
        exact_bound=summation_bound(df, n, t))
    floors = say_stages(dp, "echonest head", n, t, False, times, plain)
    probe = dict(stage_ms=times, stage_floor_ms=floors, stage_plain_ms=plain,
                 stage_max_abs_err=errs, launches=probe_launches)
    return dict(launches=launches, tail=tail, head=head, ms_iter=ms_iter,
                probe_f32=probe,
                head_ms_trained=head_ms, ms_iter_highest=hi_iter,
                launches_highest=hi_launches[0],
                tail_launches_highest=hi_launches[1],
                peak_gb_highest=hi_peak,
                head_f32_ms_trained=head_f32_ms, tail_ms_trained=tail_ms,
                tail_f32_ms_trained=tail_f32_ms)


def phase_hybrid_cpu_reference(root):
    """A small hybrid run on the card and on the CPU at "highest": the
    CPU run is the reference here, not a fallback."""
    from hgaprec_tpu_torch.config import ModelConfig, RunConfig
    from hgaprec_tpu_torch.data.ratings import RatingsStore
    from hgaprec_tpu_torch.models.engine import Trainer
    from hgaprec_tpu_torch.models.step import _resolve_mode
    n, m = 20000, 70000
    u, i, y, keys = power_law_coo(n, m, 300000, SEED, cover=True)
    lls = {}
    for device in ("cuda", "cpu"):
        store = RatingsStore(n, m)
        store.add_training(u, i, y)
        store.finalize()
        validation, test = held_out_maps(store, n, m, keys, SEED + 1, 2000)
        outdir = os.path.join(root, f"hybrid_{device}")
        tr = Trainer(store, validation, test,
                     ModelConfig(n=store.n, m=store.m, k=K, variant="hpf",
                                 sweep="hybrid", hybrid_head_items=1024,
                                 matmul_precision="highest"),
                     RunConfig(datdir=root, outdir=outdir, rfreq=5,
                               max_iterations=10), device=device)
        mode = _resolve_mode(tr.mcfg, tr.data)
        t0 = time.perf_counter()
        tr.run()
        tr.close()
        lls[device] = validation_ll(outdir)
        say(f"hybrid {store.n}x{store.m} nnz={store.nratings:,} head "
            f"T={tr.data.head_items.shape[0]} tail {tr.data.tail.nnz:,} "
            f"mode {mode} on {device} at highest, 11 iterations: "
            f"{time.perf_counter() - t0:.1f} s, validation ll "
            f"{[round(v, 6) for _, v in lls[device]]}")
        if mode != "hybrid":
            raise SystemExit("the small hybrid run did not resolve to hybrid")
    g, c = lls["cuda"], lls["cpu"]
    worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(g, c))
    ok = [a[0] for a in g] == [b[0] for b in c] and len(g) >= 3 and \
        worst < CPU_REL
    say(f"hybrid card vs CPU reference: worst relative gap {worst:.3e} over "
        f"{len(g)} reports (bound {CPU_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("hybrid card and CPU runs disagree")


def main():
    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--rank"] and len(sys.argv) == 5:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:] not in ([], ["--segment"], ["--tail"], ["--cli"],
                            ["--sharded"]):
        print("usage: chip_smoke.py [--segment | --tail | --cli | "
              "--sharded]", file=sys.stderr)
        return 2
    only = sys.argv[1][2:] if sys.argv[1:] else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hgaprec_tpu_torch.config import set_matmul_precision
    from hgaprec_tpu_torch.data import native
    from hgaprec_tpu_torch.data.synthetic import write_pf_dataset
    from hgaprec_tpu_torch.ops import build
    from hgaprec_tpu_torch.ops import dense_fused as df
    from hgaprec_tpu_torch.ops import tail_fused as tf

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
        f"{[os.path.relpath(s) for s in build.sources()]} (headers "
        f"{[os.path.relpath(s) for s in build.headers()]}) for sm_90a, one "
        f"nvcc per source in parallel, in {time.perf_counter() - t0:.1f} s")
    if os.path.exists(build.build_log_path()):
        with open(build.build_log_path()) as f:
            log = f.read()
        for line in log.splitlines():
            if line.startswith("==") or "registers" in line or \
                    "spill" in line or "Compiling entry" in line or \
                    "Potential Performance Loss" in line:
                say(f"  {line.strip()}")
        # the production routes' kernels must build with no spills
        for src in ("dense_wgmma.cu", "dense_simt.cu", "tail_bf16.cu",
                    "segment_sweep.cu"):
            start = log.index(f"== {src}")
            end = log.find("\n==", start)
            spills = [x.strip()
                      for x in log[start:end if end >= 0 else len(log)]
                      .splitlines()
                      if "spill stores" in x and
                      not x.strip().startswith("0 bytes stack frame, 0 bytes "
                                               "spill stores, 0 bytes spill")]
            if spills:
                raise SystemExit(f"csrc/{src} spills: {spills}")
        # ptxas serializes wgmma where a fragment may be touched in flight
        # (csrc/dense_wgmma.cu, hazard 5): the main path's width, every
        # stage of the probe included, must build without it
        serial = [x.strip() for x in log.splitlines()
                  if "Potential Performance Loss" in x and
                  "dense_wgmma_kernelILi112E" in x]
        if serial:
            raise SystemExit(f"wgmma serialized at kq = 112: {serial}")
    hgmma = df.hgmma_counts()
    main_kq = df.packed_width(K, "wgmma")
    hgmma_ok = hgmma.get(main_kq, 0) > 0 and min(hgmma.values()) > 0
    say(f"warpgroup tensor-core instructions (HGMMA) in the SASS of "
        f"csrc/dense_wgmma.cu, by packed width kq: {hgmma} (the main path "
        f"runs kq = {main_kq}) {'ok' if hgmma_ok else 'FAIL'}")
    if not hgmma_ok:
        raise SystemExit("an instantiation of the bf16 route's kernel has "
                         "no wgmma in its SASS")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if only == "sharded":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            datdir = os.path.join(root, "data")
            write_pf_dataset(datdir, np.random.default_rng(SEED), N_ML,
                             M_ML, k=8, a=0.3, ap=1.8, b=0.3, scale=0.7)
            phase_cpu_reference(df, datdir, root)
            phase_sharded_cli(df, datdir, root,
                              os.path.join(root, "cpu_highest"))
            phase_sharded_run(df, datdir, root)
            phase_sharded_gloo(root)
        say(f"sharded phases passed in {time.perf_counter() - t_start:.1f} "
            f"s (no result line: --sharded runs only the sharded paths)")
        return 0
    if only == "cli":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            datdir = os.path.join(root, "data")
            write_pf_dataset(datdir, np.random.default_rng(SEED), N_ML,
                             M_ML, k=8, a=0.3, ap=1.8, b=0.3, scale=0.7)
            phase_cpu_reference(df, datdir, root)
            phase_cli(df, datdir, root, os.path.join(root, "cpu_highest"))
        say(f"cli phases passed in {time.perf_counter() - t_start:.1f} s "
            f"(no result line: --cli runs only the command line's path)")
        return 0
    if only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            if only == "segment":
                phase_segment_layouts(gen)
                phase_echonest_segment(df, tf, echonest_trainer(root), root,
                                       smi)
            else:
                phase_tail_layouts(gen)
                tr = echonest_trainer(root)
                phase_echonest_tail(tr.data, tr.store.n, tr.store.m, gen, smi)
        say(f"{only} phases passed in {time.perf_counter() - t_start:.1f} s "
            f"(no result line: --{only} runs only the {only} path)")
        return 0
    main_kernel, f32_ml1m = phase_kernel(df, gen)
    probe, netflix = phase_netflix(df, gen)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        datdir = os.path.join(root, "data")
        t0 = time.perf_counter()
        nnz = write_pf_dataset(datdir, np.random.default_rng(SEED), N_ML,
                               M_ML, k=8, a=0.3, ap=1.8, b=0.3, scale=0.7)
        say(f"dataset: {N_ML}x{M_ML}, {nnz:,} nonzeros written in "
            f"{time.perf_counter() - t0:.1f} s")
        launches = phase_main(df, datdir, root)
        launches_ml1m_highest, ms_iter_ml1m_highest = phase_cpu_reference(
            df, datdir, root)
        cli_f32, cli_seg = phase_cli(
            df, datdir, root, os.path.join(root, "cpu_highest"))
        sh_cli, sh_cli_s = phase_sharded_cli(df, datdir, root,
                                             os.path.join(root, "cli"))
        sh_run = phase_sharded_run(df, datdir, root)
        gloo, gloo_ms = phase_sharded_gloo(root)

        phase_tail_layouts(gen)
        phase_segment_layouts(gen)
        say(f"checkpoint TSV writer: "
            f"{'native (' + os.path.relpath(native.library_path()) + ')' if native.available() else 'Python (no g++)'}")
        tr = echonest_trainer(root)
        en = phase_echonest(df, tf, tr, gen, smi)
        seg = phase_echonest_segment(df, tf, tr, root, smi)
        del tr
        torch.cuda.empty_cache()
        phase_hybrid_cpu_reference(root)
        seg_small = phase_segment_cpu_reference(root)

    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    head_ms, head_plain_ms, head_bound_ms = en["head"][True]
    probe_en = en["probe_f32"]

    def per_rank(run, kernel):      # [rank 0, rank 1] launches, phase C
        return [ranks[kernel] for ranks in gloo[run]]
    say(json.dumps({"kernels": [
        {"name": "fused_dense_sweep", "route": "cuda",
         "source": "hgaprec_tpu_torch/csrc/dense_wgmma.cu",
         "replaces": "hgaprec_tpu/ops/dense_pallas.py:50",
         "launches": launches + en["launches"][0] +
         sh_run["default"]["launches"] + sum(per_rank("hybrid_bf16", 0)),
         "launches_by_path": {"ml1m_dense": launches,
                              "echonest_hybrid": en["launches"][0],
                              "ml1m_sharded_world1_bf16":
                                  sh_run["default"]["launches"],
                              "gloo2_hybrid_bf16_per_rank":
                                  per_rank("hybrid_bf16", 0)},
         **main_kernel, "hgmma": hgmma, **netflix,
         "ms_echonest_head_bf16": head_ms,
         "plain_ms_echonest_head_bf16": head_plain_ms,
         "bound_ms_echonest_head_bf16": head_bound_ms,
         "ms_per_iter_echonest_hybrid": en["ms_iter"],
         "source_f32": "hgaprec_tpu_torch/csrc/dense_simt.cu",
         "launches_f32_by_path": {
             "ml1m_dense_highest": launches_ml1m_highest,
             "ml1m_cli_highest": cli_f32,
             "echonest_hybrid_highest_steady": en["launches_highest"],
             "ml1m_cli_devices_world1": sh_cli,
             "ml1m_sharded_world1_highest": sh_run["highest"]["launches"],
             "gloo2_hybrid_highest_per_rank":
                 per_rank("hybrid_highest", 0)},
         "sharded": {"cli_devices_world1_s": sh_cli_s,
                     "world1": sh_run, "gloo2_ms_per_iter_per_rank":
                         gloo_ms},
         **f32_ml1m,
         "ms_f32_echonest_head": en["head"][False][0],
         "plain_ms_f32_echonest_head": en["head"][False][1],
         "bound_ms_f32_echonest_head": en["head"][False][2],
         "ms_per_iter_ml1m_highest": ms_iter_ml1m_highest,
         "ms_per_iter_echonest_hybrid_highest": en["ms_iter_highest"]},
        {"name": "fused_half_sweep", "route": "cuda",
         "source": "hgaprec_tpu_torch/csrc/tail_bf16.cu",
         "replaces": "hgaprec_tpu/ops/pallas_tail.py:101",
         "launches": en["launches"][1] + sum(per_rank("hybrid_bf16", 1)),
         "launches_by_path": {"echonest_hybrid": en["launches"][1],
                              "gloo2_hybrid_bf16_per_rank":
                                  per_rank("hybrid_bf16", 1)},
         **en["tail"], "ms_trained": en["tail_ms_trained"],
         "source_f32": "hgaprec_tpu_torch/csrc/segment_sweep.cu",
         "launches_f32_by_path": {
             "echonest_hybrid_highest_steady":
                 en["tail_launches_highest"],
             "gloo2_hybrid_highest_per_rank":
                 per_rank("hybrid_highest", 1)},
         "ms_f32_trained": en["tail_f32_ms_trained"],
         "peak_gb_echonest_hybrid_highest": en["peak_gb_highest"]},
        {"name": "dense_probe", "route": "cuda",
         "source": "hgaprec_tpu_torch/csrc/dense_wgmma.cu",
         "source_f32": "hgaprec_tpu_torch/csrc/dense_simt.cu",
         "routes": {"wgmma": "hgaprec_tpu_torch/csrc/dense_wgmma.cu",
                    "f32": "hgaprec_tpu_torch/csrc/dense_simt.cu"},
         "replaces": "scripts/dense_mfu_probe.py:51",
         "launches": sum(sum(p.values()) for p in
                         probe["launches_by_path"].values()) +
         probe_en["launches"],
         "launches_by_route_and_path": {
             "wgmma": probe["launches_by_path"]["wgmma"],
             "f32": {**probe["launches_by_path"]["f32"],
                     "echonest_head_probe": probe_en["launches"]}},
         **{k: v for k, v in probe.items() if k != "launches_by_path"},
         "echonest_head_f32": {k: v for k, v in probe_en.items()
                               if k != "launches"}},
        {"name": "fused_segment_sweep", "route": "cuda",
         "source": "hgaprec_tpu_torch/csrc/segment_sweep.cu",
         "replaces": "docs/design/pallas_csr_sweep.py:80",
         "launches": seg["launches"] + cli_seg +
         sum(per_rank("segment", 2)),
         "launches_by_path": {"echonest_segment": seg["launches"],
                              "ml1m_cli_segment": cli_seg,
                              "small_segment_vs_cpu": seg_small,
                              "gloo2_segment_per_rank":
                                  per_rank("segment", 2)},
         **{k: v for k, v in seg.items()
            if k not in ("launches", "ms_iter", "peak")},
         "ms_per_iter_echonest_segment": seg["ms_iter"],
         "peak_gb_echonest_segment": seg["peak"]}]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
