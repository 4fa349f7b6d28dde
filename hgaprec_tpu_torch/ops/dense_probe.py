"""Stage probe of the dense sweep kernels: which stage bounds each route?

Port of `scripts/dense_mfu_probe.py` (TPU kernel `_kernel_variant`,
wrapper `run_variant`). Both production kernels of the dense sweep take
the stage as a compile-time template parameter, and each stage is one
instantiation, timed on the same data:

    prod       the production kernel itself (its entry launches the same
               instantiation)
    bf16recip  W = bf16(Y) * bf16(rcp(bf16(max(S, 1e-30)))) (bf16 only)
    norecip    W = Y (no reciprocal or divide); the delta to prod is the
               W stage's arithmetic
    noyload    W = 1, Y never loaded; the delta to norecip is Y's traffic
    mmonly     only the S products (outputs S * 0): half of the products
               of prod, with no W and no contraction

bf16 runs the stages of `csrc/dense_wgmma.cu` (built at kq = 112, K up to
110), f32 ("highest") those of `csrc/dense_simt.cu` (kq up to 104), where
bf16recip has no meaning and is refused. Each stage has a plain torch
version here, held against the kernel on the card and against the TPU
probe's formulas on the CPU. Run on a card:

    python -m hgaprec_tpu_torch.ops.dense_probe [--f32] [n_users] [stages...]

It prints each stage's median time and the rate of 8 N M kq (the
production sweep's operation count, whatever the stage computes) at the
Netflix item count, with the card's name and power limit, and the count
of the route's product instructions (HGMMA or FFMA) in each stage's
machine code.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops.dense_fused import _check, _pack, launch_dense

STAGES = {"prod": 0, "bf16recip": 1, "norecip": 2, "noyload": 3,
          "mmonly": 4}
# the stages each route builds: wgmma is bf16, f32 is "highest"
ROUTE_STAGES = {"wgmma": tuple(STAGES),
                "f32": ("prod", "norecip", "noyload", "mmonly")}
# each route's kernel in the machine code, and its product instruction
_KERNEL_NAMES = {"wgmma": r"dense_wgmma_kernelILi112ELi(\d+)EE",
                 "f32": r"dense_simt_f32_kernelILi64ELi(\d+)EE"}
PRODUCT_OPCODE = {"wgmma": "HGMMA", "f32": "FFMA"}
M_PROBE, K_PROBE = 17770, 100          # Netflix items, the production K
_CLAMP = 1e-30


def route_of(bf16: bool) -> str:
    return "wgmma" if bf16 else "f32"


def check_stage(stage: str, bf16: bool) -> None:
    """Raise ValueError for a stage that is unknown or that the route of
    `bf16` does not build."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r} ({', '.join(STAGES)})")
    route = route_of(bf16)
    if stage not in ROUTE_STAGES[route]:
        raise ValueError(f"stage {stage!r} is not built on the {route} "
                         f"route ({', '.join(ROUTE_STAGES[route])})")


def dense_probe(a_lin: torch.Tensor, b_lin: torch.Tensor,
                dense_y: torch.Tensor, stage: str, *, bf16: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw_a f32 [N, K], raw_b f32 [M, K]): the dense sweep of the bf16
    (wgmma) or f32 route with `stage` (a key of ROUTE_STAGES[route]) in
    place of the production W stage; no bias. a_lin f32 [N, K], b_lin
    f32 [M, K] (K <= 110 in bf16, <= 104 in f32), dense_y u8 [>= N, >= M]
    (in bf16 its row stride and base at multiples of 16 bytes). A CPU
    tensor takes the plain version; any other device but CUDA raises."""
    check_stage(stage, bf16)
    _check(a_lin, b_lin, dense_y, None, None)
    if dense_y.device.type == "cpu":
        return dense_probe_reference(a_lin, b_lin, dense_y, stage, bf16=bf16)
    if dense_y.device.type != "cuda":
        raise ValueError(f"no kernel for device {dense_y.device}")
    k = a_lin.shape[1]
    route = route_of(bf16)
    acc_a, acc_b = launch_dense(a_lin, b_lin, dense_y, kernel=route,
                                stage=STAGES[stage])
    if a_lin.shape[0] and b_lin.shape[0]:
        dense_probe.launches += 1
        dense_probe.launches_by_route[route] += 1
    return acc_a[:, :k], acc_b[:, :k]


dense_probe.launches = 0
dense_probe.launches_by_route = {route: 0 for route in ROUTE_STAGES}


def _weights(stage: str, s: torch.Tensor, y: torch.Tensor,
             bf16: bool) -> torch.Tensor:
    """The stage's W for a block as the TPU probe writes it
    (dense_mfu_probe.py:58-76): in bf16 an f32 tensor holding bf16
    values, in f32 nothing rounded."""
    bf = torch.bfloat16
    if stage == "prod":
        w = y / torch.clamp_min(s, _CLAMP)
        return w.to(bf).float() if bf16 else w
    if stage == "bf16recip":
        sc = torch.clamp_min(s, _CLAMP).to(bf)
        r = (1.0 / sc.float()).to(bf)
        return (y.to(bf) * r).float()
    if stage == "norecip":
        return y                    # counts below 256 are exact in bf16
    return torch.ones_like(s)                      # noyload


def dense_probe_reference(a_lin: torch.Tensor, b_lin: torch.Tensor,
                          dense_y: torch.Tensor, stage: str, *,
                          bf16: bool = True, user_block: int = 8192,
                          item_block: int = 4096
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function for `stage` in blocked torch ops (same
    contract as `dense_probe`). In bf16 A, B and W are rounded to bf16
    where the kernel rounds them, products and sums f32; in f32 nothing
    is rounded, and prod is `fused_dense_sweep_reference(bf16=False)`
    op for op."""
    check_stage(stage, bf16)
    n, k = a_lin.shape
    m = b_lin.shape[0]
    a, b = _pack(a_lin, b_lin, None, None)
    if bf16:
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    acc_a = torch.zeros((n, k), dtype=torch.float32, device=a.device)
    acc_b = torch.zeros((m, k), dtype=torch.float32, device=a.device)
    if stage == "mmonly":                          # outputs S * 0
        return acc_a, acc_b
    for u0 in range(0, n, user_block):
        u1 = min(u0 + user_block, n)
        a_u = a[u0:u1]
        for c0 in range(0, m, item_block):
            c1 = min(c0 + item_block, m)
            b_c = b[c0:c1]
            y = dense_y[u0:u1, c0:c1].float()
            w = _weights(stage, a_u @ b_c.T, y, bf16)
            acc_a[u0:u1] += w @ b_c
            acc_b[c0:c1] += w.T @ a_u
    return acc_a, acc_b


def median_ms(fn, reps: int) -> float:
    """Median over `reps` calls, each timed with CUDA events."""
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


def time_stages(a_lin, b_lin, dense_y, stages: Iterable[str], reps: int,
                *, bf16: bool = True) -> Dict[str, float]:
    """Median ms of each stage's kernel on these inputs (on the card)."""
    return {s: median_ms(lambda s=s: dense_probe(a_lin, b_lin, dense_y, s,
                                                 bf16=bf16), reps)
            for s in stages}


def sass_counts(opcodes: Iterable[str],
                sass: Optional[str] = None) -> Dict[str, Dict[str, Dict]]:
    """{route: {stage: {opcode: count}}}: the instructions whose mnemonic
    starts with each of `opcodes` (e.g. "HGMMA.64x64x16", "LDS.U8") in
    each stage's kernel, read from the built library's machine code
    (cuobjdump), or from `sass`. Counts are static: instructions in the
    code, not instructions executed."""
    opcodes = tuple(opcodes)
    names = {v: s for s, v in STAGES.items()}
    counts: Dict[str, Dict[str, Dict]] = {r: {} for r in ROUTE_STAGES}
    cur = None
    for line in (build.sass() if sass is None else sass).splitlines():
        if "Function :" in line:
            cur = None
            for route, pattern in _KERNEL_NAMES.items():
                hit = re.search(pattern, line)
                if hit and int(hit.group(1)) in names:
                    cur = counts[route].setdefault(
                        names[int(hit.group(1))], dict.fromkeys(opcodes, 0))
            continue
        if cur is None:
            continue
        hit = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.x]*)", line)
        if hit:
            for op in opcodes:
                if hit.group(1).startswith(op):
                    cur[op] += 1
    return counts


def mma_counts(sass: Optional[str] = None) -> Dict[str, Dict[str, int]]:
    """{route: {stage: count}} of each route's product instructions in
    each stage's kernel: HGMMA (warpgroup tensor-core products) for the
    wgmma stages, FFMA for the f32 stages. A stage whose count fell to
    zero had its products folded away."""
    both = sass_counts(PRODUCT_OPCODE.values(), sass)
    return {route: {stage: c[PRODUCT_OPCODE[route]]
                    for stage, c in stages.items()}
            for route, stages in both.items()}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    bf16 = "--f32" not in args
    args = [a for a in args if a != "--f32"]
    n = int(args[0]) if args else 65536
    route = route_of(bf16)
    stages = args[1:] or list(ROUTE_STAGES[route])
    for s in stages:
        check_stage(s, bf16)
    if not torch.cuda.is_available():
        print("dense_probe: no CUDA device; the probe times the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from hgaprec_tpu_torch.data.device import dense_count_matrix
    g = torch.Generator(device="cuda").manual_seed(7)
    y = dense_count_matrix(n, M_PROBE, "cuda")
    for r0 in range(0, n, 16384):   # 1% of the counts are 3, as on the TPU
        hit = torch.rand((min(16384, n - r0), M_PROBE), device="cuda",
                         generator=g) < 0.01
        y[r0:r0 + hit.shape[0]] = hit.to(torch.uint8) * 3
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.gamma(0.3, 1.0, (r, K_PROBE)).astype(
        np.float32) + 0.01).cuda() for r in (n, M_PROBE))
    kq = 112 if bf16 else -(-K_PROBE // 4) * 4
    flops = 8 * n * M_PROBE * kq
    print(f"dense probe: n={n} m={M_PROBE} k={K_PROBE} (kq={kq}) "
          f"{'bf16' if bf16 else 'f32'} ({route}), 8 N M kq = "
          f"{flops / 1e12:.2f} TFLOP; {card_line()}", flush=True)
    print(f"{PRODUCT_OPCODE[route]} instructions per stage: "
          f"{mma_counts()[route]}", flush=True)
    for s, ms in time_stages(a, b, y, stages, 5, bf16=bf16).items():
        print(f"{s:10s}: {ms:8.3f} ms  ({flops / ms / 1e9:6.1f} TFLOP/s "
              f"of 8 N M kq)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
