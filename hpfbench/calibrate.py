#!/usr/bin/env python3
"""Readings from which the limits of limits/<cell>.json are set.

    python3 hpfbench/calibrate.py --config <config> --traffic <t> [<t> ...] \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...] [--out FILE]

For each seed, on the card, as a run of the cell makes them: the COO and
the initial state; for each traffic mix, the port's layout and its fused
multi-step driven through the checked iterations (one call each), the
state kept after each; then the float64 reference from the same initial
state, and the numbers that a run compares (compare.py) for each cell.

For each control seed, the same numbers of:

  * the control of each precision that the traffic mixes state: the
    reference in place of the program, its sweep's products' operands
    rounded one precision below (refs/<reference>.py, `BELOW`: TF32 below
    "highest", float32 with TF32 off; FP8 E4M3 below "default",
    bfloat16), the rest float32;
  * faults planted in the reference put in the program's place: a step
    that returns its state unchanged; half of the nonzeros left out and
    the other half's counts doubled (the mean over the rest); one
    element of the new theta shape altered where it is produced, by the
    precision's share (compare.ALTERED: 1% at "highest", 25% at
    "default").

Prints one JSON line per seed and cell (and appends it to --out). The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def planted(kind, ref, st, coo, k, priors, altered=0.01):
    """One step of the reference with fault `kind` planted, in float32."""
    import torch
    if kind == "unchanged":
        return {name: v.clone() for name, v in st.items()}
    if kind == "half_batch":
        keep = torch.arange(coo.nnz, device=coo.u.device) % 2 == 0
        return ref.hpf_step(st, coo.u[keep], coo.i[keep], 2 * coo.y[keep],
                            k, priors)
    if kind == "altered":
        out = ref.hpf_step(st, coo.u, coo.i, coo.y, k, priors)
        out["theta.shape"][0, 0] *= 1.0 + altered
        return out
    raise ValueError(kind)


def readings(chain, ref_chain):
    """{step name: worst gap} and the worst leaf of each step."""
    from hpfbench import compare
    nums, leaves = {}, {}
    for s in range(1, len(ref_chain)):
        gaps = compare.state_gaps(chain[s], ref_chain[s])
        worst = max(gaps, key=gaps.get)
        nums[compare.step_name(s)] = gaps[worst]
        leaves[compare.step_name(s)] = worst
    return nums, leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--control-seeds", nargs="*", type=int, default=[])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from hpfbench import compare, data, manifest, program
    from hpfbench.run import CHECKED_STEPS, host_copy, seed_bits
    from hpfbench.state_init import hpf_initial_state

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        program.load_kernels()
    bench = manifest.load(args.root)
    cfg = manifest.config(bench, args.config, args.root)
    ref = manifest.module("refs", cfg["reference"])
    k, priors = cfg["k"], cfg["priors"]
    traffics = {t: manifest.traffic(t, args.root) for t in args.traffic}
    precisions = sorted({t["matmul_precision"] for t in traffics.values()})
    steps = CHECKED_STEPS

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t_seed = time.perf_counter()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_bits(seed))
        coo = data.make_coo(cfg, gen, device).to("cpu")
        init = host_copy(hpf_initial_state(coo.n, coo.m, k, priors, gen,
                                           device))
        chains = {}
        if seed in args.seeds:
            for name, traffic in traffics.items():
                mcfg = program.model_config(cfg, traffic, coo.n, coo.m)
                dd, info, layout_s = program.layout(
                    mcfg, coo.u.numpy(), coo.i.numpy(), coo.y.numpy(),
                    device)
                state = program.model_state(
                    {n_: v.to(device, copy=True) for n_, v in init.items()})
                multi = program.make_multi_step(mcfg)
                chain = [init]
                for _ in range(steps):
                    multi(state, dd, 1)
                    chain.append(host_copy(program.leaves(state)))
                chains[name] = (chain, program.counts(multi), info, layout_s)
                multi.reset()
                del state, dd, multi
                if cuda:
                    torch.cuda.empty_cache()
        dcoo = coo.to(device)
        st = {n_: v.to(device).to(torch.float64) for n_, v in init.items()}
        ref_chain = [st]
        for _ in range(steps):
            ref_chain.append(ref.hpf_step(ref_chain[-1], dcoo.u, dcoo.i,
                                          dcoo.y, k, priors))
        base = {"config": args.config, "seed": seed, "nnz": coo.nnz,
                "n": coo.n, "m": coo.m,
                "device": torch.cuda.get_device_name(device) if cuda
                else "cpu"}
        for name, (chain, counts, info, layout_s) in chains.items():
            nums, leaves = readings(chain, ref_chain)
            emit({**base, "cell": f"{args.config}.{name}", "kind": "program",
                  "numbers": nums, "worst_leaves": leaves, "counts": counts,
                  "info": info, "layout_s": layout_s})
        if seed in args.control_seeds:
            st32 = {n_: v.to(device, copy=True) for n_, v in init.items()}

            def emit_chain(tags, one_step):
                chain = [st32]
                for _ in range(steps):
                    chain.append(one_step(chain[-1]))
                nums, leaves = readings(chain, ref_chain)
                emit({**base, **tags, "numbers": nums,
                      "worst_leaves": leaves})

            for prec in precisions:
                low = ref.BELOW[prec]
                emit_chain({"kind": f"control_{low}", "precision": prec},
                           lambda st: ref.hpf_step(st, dcoo.u, dcoo.i,
                                                   dcoo.y, k, priors,
                                                   low=low))
                emit_chain({"kind": "fault_altered", "precision": prec},
                           lambda st: planted("altered", ref, st, dcoo, k,
                                              priors, compare.ALTERED[prec]))
            # the faults that read alike at every precision
            for fault in ("unchanged", "half_batch"):
                emit_chain({"kind": f"fault_{fault}"},
                           lambda st: planted(fault, ref, st, dcoo, k,
                                              priors))
        del ref_chain, st, dcoo
        if cuda:
            torch.cuda.empty_cache()
        print(f"# seed {seed}: {time.perf_counter() - t_seed:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
