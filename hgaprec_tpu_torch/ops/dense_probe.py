"""Stage probe of the dense sweep kernel: which stage bounds it?

Port of `scripts/dense_mfu_probe.py` (TPU kernel `_kernel_variant`,
wrapper `run_variant`). The bf16 dense kernel (`csrc/dense_fused.cu`) is
built once per stage, each a copy of the production kernel with one stage
of the W computation removed, and timed on the same data:

    prod       the production kernel, bit for bit
    bf16recip  W = bf16(Y) * bf16(approximate 1 / bf16(max(S, 1e-30)))
    norecip    W = Y (no reciprocal); the delta to prod is the W stage
    noyload    W = 1, Y never read; the delta to norecip is the Y reads
    mmonly     only the S products (outputs S * 0): half of the tensor-core
               work of prod, with no W and no contraction

Each stage has a plain torch version here, held against the kernel on the
card and against the TPU probe's formulas on the CPU. Run on a card:

    python -m hgaprec_tpu_torch.ops.dense_probe [n_users] [variants...]

It prints each variant's median time and TFLOP/s of 8 N M kq (the
production sweep's operation count, whatever the variant computes) at the
Netflix item count, with the card's name and power limit, and the count
of tensor-core instructions (HMMA) in each variant's machine code.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from hgaprec_tpu_torch.ops import build
from hgaprec_tpu_torch.ops.dense_fused import _check, _pack, launch_dense

STAGES = {"prod": 0, "bf16recip": 1, "norecip": 2, "noyload": 3,
          "mmonly": 4}
M_PROBE, K_PROBE = 17770, 100          # Netflix items, the production K
_CLAMP = 1e-30


def dense_probe(a_lin: torch.Tensor, b_lin: torch.Tensor,
                dense_y: torch.Tensor, stage: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw_a f32 [N, K], raw_b f32 [M, K]): the bf16 dense sweep with
    `stage` (a key of STAGES) in place of the production W stage; no
    bias. a_lin f32 [N, K], b_lin f32 [M, K] with a packed bf16 width up
    to 128, dense_y u8 [>= N, >= M]. A CPU tensor takes the plain
    version."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r} ({', '.join(STAGES)})")
    _check(a_lin, b_lin, dense_y, None, None)
    if dense_y.device.type == "cpu":
        return dense_probe_reference(a_lin, b_lin, dense_y, stage)
    if dense_y.device.type != "cuda":
        raise ValueError(f"no kernel for device {dense_y.device}")
    k = a_lin.shape[1]
    if -(-k // 16) * 16 > 128:
        raise ValueError(f"the probe's kernels take K <= 128, got {k}")
    acc_a, acc_b = launch_dense(a_lin, b_lin, dense_y, kernel="mma",
                                stage=STAGES[stage])
    if a_lin.shape[0] and b_lin.shape[0]:
        dense_probe.launches += 1
    return acc_a[:, :k], acc_b[:, :k]


dense_probe.launches = 0


def mma_sweep(a_lin: torch.Tensor, b_lin: torch.Tensor,
              dense_y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw_a, raw_b) of the earlier bf16 design's production entry
    (`hpf_dense_fused_sweep_bf16`, the mma.sync kernel the probe's stages
    are built from; no bias), on the card: what the prod stage is held to
    bit for bit. The production route runs csrc/dense_wgmma.cu instead."""
    _check(a_lin, b_lin, dense_y, None, None)
    k = a_lin.shape[1]
    acc_a, acc_b = launch_dense(a_lin, b_lin, dense_y, kernel="mma")
    return acc_a[:, :k], acc_b[:, :k]


def _weights(stage: str, s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The stage's W for a block (f32 holding bf16 values), as the TPU
    probe writes it (dense_mfu_probe.py:58-76)."""
    bf = torch.bfloat16
    if stage == "prod":
        return (y / torch.clamp_min(s, _CLAMP)).to(bf).float()
    if stage == "bf16recip":
        sc = torch.clamp_min(s, _CLAMP).to(bf)
        r = (1.0 / sc.float()).to(bf)
        return (y.to(bf) * r).float()
    if stage == "norecip":
        return y.to(bf).float()
    return torch.ones_like(s)                      # noyload


def dense_probe_reference(a_lin: torch.Tensor, b_lin: torch.Tensor,
                          dense_y: torch.Tensor, stage: str,
                          user_block: int = 8192, item_block: int = 4096
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function for `stage` in blocked torch ops (same
    contract as `dense_probe`). A, B and W are rounded to bf16 where the
    kernel rounds them; products and sums are f32."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    a, b = _pack(a_lin, b_lin, None, None)
    a = a.to(torch.bfloat16).float()
    b = b.to(torch.bfloat16).float()
    acc_a = torch.zeros((n, k), dtype=torch.float32, device=a.device)
    acc_b = torch.zeros((m, k), dtype=torch.float32, device=a.device)
    if stage == "mmonly":                          # outputs S * 0
        return acc_a, acc_b
    for u0 in range(0, n, user_block):
        a_u = a[u0:u0 + user_block]
        for c0 in range(0, m, item_block):
            b_c = b[c0:c0 + item_block]
            y = dense_y[u0:u0 + a_u.shape[0], c0:c0 + b_c.shape[0]].float()
            w = _weights(stage, a_u @ b_c.T, y)
            acc_a[u0:u0 + a_u.shape[0]] += w @ b_c
            acc_b[c0:c0 + b_c.shape[0]] += w.T @ a_u
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


def time_stages(a_lin, b_lin, dense_y, stages: Iterable[str],
                reps: int) -> Dict[str, float]:
    """Median ms of each stage's kernel on these inputs (on the card)."""
    return {s: median_ms(lambda s=s: dense_probe(a_lin, b_lin, dense_y, s),
                         reps) for s in stages}


def mma_counts() -> Dict[str, int]:
    """Tensor-core instructions (HMMA) in each stage's kernel, read from
    the built library's machine code with cuobjdump: a stage whose count
    fell to zero had its products folded away."""
    sass = build.sass()
    names = {v: s for s, v in STAGES.items()}
    counts: Dict[str, int] = {}
    stage = None
    for line in sass.splitlines():
        if "Function :" in line:
            hit = re.search(r"dense_fused_bf16_kernelILi128ELi(\d+)E", line)
            stage = names.get(int(hit.group(1))) if hit else None
            if stage is not None:
                counts[stage] = 0
        elif stage is not None and "HMMA" in line:
            counts[stage] += 1
    return counts


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    n = int(args[0]) if args else 65536
    stages = args[1:] or list(STAGES)
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
    kq = -(-K_PROBE // 16) * 16
    print(f"dense probe: n={n} m={M_PROBE} k={K_PROBE} (kq={kq}) bf16, "
          f"8 N M kq = {8 * n * M_PROBE * kq / 1e12:.2f} TFLOP; "
          f"{card_line()}", flush=True)
    print(f"HMMA instructions per stage: {mma_counts()}", flush=True)
    for s, ms in time_stages(a, b, y, stages, 5).items():
        print(f"{s:10s}: {ms:8.3f} ms  "
              f"({8 * n * M_PROBE * kq / ms / 1e9:6.1f} TFLOP/s of "
              f"8 N M kq)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
