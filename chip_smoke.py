#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `hgaprec_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, sweeps once at Netflix
shape, trains HPF K=100 on MovieLens-1M-shaped synthetic data through the
Trainer (the port's main entry point) and checks the card's run against
the port's own CPU run. Then the big-sparse hybrid path: the tail kernel
against its plain version on adversarial layouts and on the EchoNest
tail, HPF K=100 at the EchoNest preset shape (1,019,318 x 384,546, 45M
nonzeros) through the Trainer, and a small hybrid run on the card against
the CPU. Prints one line per phase, a JSON line with each kernel's
launches, error and times, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero, with no result line,
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
TAIL_F32_TOL = dict(rtol=2e-5, atol=1e-6)   # tests/test_pallas_tail.py:62-63
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


def check_tail(name, n, m, k, stream, gen, bias, reps):
    """Kernel against plain on one stream, four modes. Returns the
    no-bias bf16 line's numbers (the main path's configuration)."""
    from hgaprec_tpu_torch.ops import tail as tl
    from hgaprec_tpu_torch.ops import tail_fused as tf
    shapes = [(n, k), (m, k)] + ([(n,), (m,)] if bias else [])
    lin = [torch.exp(0.3 * torch.randn(s, device="cuda", generator=gen))
           for s in shapes]
    lin += [None, None] * (not bias)
    ref32 = tl.tail_sweep_reference(*lin, stream, bf16=False)
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
        # the two half-sweeps alone, on tables built once
        a_t, b_t = tl.tail_tables(*lin, bf16=bf16)
        halves = ((a_t, b_t, stream.u, stream.i, stream.y, n),
                  (b_t, a_t, stream.i_by_item, stream.u_by_item,
                   stream.y_by_item, m))
        ms = median_ms(lambda: [tf.fused_half_sweep(*h) for h in halves],
                       reps)
        plain_ms = median_ms(
            lambda: [tl.half_sweep_reference(*h) for h in halves], reps)
        kq = a_t.shape[1]
        nbytes = 2 * stream.nnz * (kq * a_t.element_size() + 12)
        say(f"tail kernel [{name}] {n}x{m}x{k} nnz={stream.nnz:,} "
            f"bias={bias} bf16={bf16}: max_abs_err vs f32 plain {err:.3e} "
            f"(vs plain in the same mode {err_like:.3e}), two launches "
            f"bitwise {'equal' if same_bits else 'DIFFERENT'} "
            f"{'ok' if ok and same_bits else 'FAIL'}; both halves kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of {reps}); "
            f"{nbytes / ms / 1e6:.1f} GB/s of 2 x nnz x (kq x "
            f"{a_t.element_size()} + 12) B")
        if not (ok and same_bits):
            raise SystemExit(f"tail kernel disagrees with its plain version "
                             f"[{name}] bias={bias} bf16={bf16}")
        if bf16:
            out = dict(max_abs_err=err_like, ms=ms, plain_ms=plain_ms,
                       gbps=nbytes / ms / 1e6)
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

    # the head kernel at the head shape (offsets past 2^31 bytes of Y)
    n, m = tr.store.n, tr.store.m
    a_lin = torch.exp(0.3 * torch.randn((n, K), device="cuda",
                                        generator=gen))
    b_head = torch.exp(0.3 * torch.randn((t, K), device="cuda",
                                         generator=gen))
    ref = df.fused_dense_sweep_reference(a_lin, b_head, data.head_dense_y)
    head = {}
    for bf16 in (False, True):
        kq = -(-K // (16 if bf16 else 4)) * (16 if bf16 else 4)
        got = df.fused_dense_sweep(a_lin, b_head, data.head_dense_y,
                                   bf16=bf16)
        torch.cuda.synchronize()
        err, ok = compare(got, ref, bf16)
        ms = median_ms(lambda: df.fused_dense_sweep(
            a_lin, b_head, data.head_dense_y, bf16=bf16), 5)
        plain_ms = median_ms(lambda: df.fused_dense_sweep_reference(
            a_lin, b_head, data.head_dense_y, bf16=bf16), 3)
        say(f"head kernel {n}x{t}x{K} ldy={data.head_dense_y.stride(0)} "
            f"bf16={bf16}: max_abs_err vs f32 plain {err:.3e} "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.2f} ms, plain "
            f"{plain_ms:.2f} ms; {8 * n * t * kq / ms / 1e9:.1f} TFLOP/s "
            f"of 8 N T kq (kq = {kq})")
        if not ok:
            raise SystemExit("head kernel disagrees with its plain version")
        head[bf16] = (ms, plain_ms)
    del a_lin, b_head, ref, got

    # the tail kernel on the EchoNest tail, before training
    tail = check_tail("echonest tail", n, m, K, data.tail, gen, False, 5)
    check_tail("echonest tail", n, m, K, data.tail, gen, True, 3)
    torch.cuda.empty_cache()

    report_s, topk_calls = [], []
    timed(tr, "report", report_s)
    timed(tr, "do_on_stop", report_s)
    streamed = {nm: getattr(ranking, nm)
                for nm in ("masked_topk", "item_ranks")}
    for nm, f in streamed.items():
        setattr(ranking, nm, (lambda f, nm: lambda *a, **kw: (
            topk_calls.append(nm), f(*a, **kw))[1])(f, nm))
    say(f"tail kernel at the EchoNest tail, bf16: {tail['gbps']:.1f} GB/s "
        f"of 2 x nnz x (kq x 2 + 12) B, on {smi}")
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
    say(f"echonest steady state {ms_iter:.2f} ms/iter = "
        f"{1e3 / ms_iter:.2f} iters/s (median of 5 windows of 10; range "
        f"{ms_lo:.2f}-{ms_hi:.2f}): head kernel {head_ms:.2f} ms, tail "
        f"kernel {tail_ms:.2f} ms (both halves), rest "
        f"{ms_iter - head_ms - tail_ms:.2f} ms")
    return dict(launches=launches, tail=tail, head=head)


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

        phase_tail_layouts(gen)
        say(f"checkpoint TSV writer: "
            f"{'native (' + os.path.relpath(native.library_path()) + ')' if native.available() else 'Python (no g++)'}")
        tr = echonest_trainer(root)
        en = phase_echonest(df, tf, tr, gen, smi)
        del tr
        torch.cuda.empty_cache()
        phase_hybrid_cpu_reference(root)

    say(json.dumps({"kernels": [
        {"name": "fused_dense_sweep", "route": "cuda",
         "source": "hgaprec_tpu_torch/csrc/dense_fused.cu",
         "replaces": "hgaprec_tpu/ops/dense_pallas.py:50",
         "launches": launches + en["launches"][0],
         "launches_by_path": {"ml1m_dense": launches,
                              "echonest_hybrid": en["launches"][0]},
         **main_kernel,
         "ms_echonest_head_bf16": en["head"][True][0],
         "plain_ms_echonest_head_bf16": en["head"][True][1]},
        {"name": "fused_half_sweep", "route": "cuda",
         "source": "hgaprec_tpu_torch/csrc/tail_fused.cu",
         "replaces": "hgaprec_tpu/ops/pallas_tail.py:101",
         "launches": en["launches"][1],
         "launches_by_path": {"echonest_hybrid": en["launches"][1]},
         "max_abs_err": en["tail"]["max_abs_err"],
         "ms": en["tail"]["ms"], "plain_ms": en["tail"]["plain_ms"],
         "gbps": en["tail"]["gbps"]}]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
