#!/usr/bin/env python3
"""calibrate.py's readings, each chain held to the reference in lockstep.

    python3 hpfbench/calibrate_lockstep.py --config <config> \\
        --traffic <t> [<t> ...] --seeds <n> [<n> ...] \\
        [--control-seeds <n> ...] [--out FILE]

The same seeds, chains and JSON lines as calibrate.py, for a configuration
whose reference states do not fit the card four at a time. calibrate.py
keeps the whole float64 reference chain on the card (four states) while
it compares; at K = 300 on the EchoNest counts a state is 13.5 GB, so the
chain and a control's float32 chain beside it pass the card's 80 GB.
Here every chain (the program's, kept on the host as a run keeps it, and
each control and planted fault) walks beside a reference chain of its
own, one step at a time, so that the card holds the reference's last and
next state, the chain's, and one step's temporaries. The reference is
computed once per chain instead of once per seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def lockstep(init, next_state, exact_step, steps, device):
    """({step name: worst gap}, {step name: worst leaf}) of the chain
    next_state(s, state) for s = 1 .. steps from `init` (host float32)
    against the float64 reference from the same state."""
    import torch

    from hpfbench import compare
    exact = {n: v.to(device).to(torch.float64) for n, v in init.items()}
    cur = {n: v.to(device, copy=True) for n, v in init.items()}
    nums, leaves = {}, {}
    for s in range(1, steps + 1):
        exact = exact_step(exact)
        cur = next_state(s, cur)
        gaps = compare.state_gaps(cur, exact)
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
    from hpfbench.calibrate import planted
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

    def free():
        if cuda:
            torch.cuda.empty_cache()

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t_seed = time.perf_counter()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_bits(seed))
        coo = data.make_coo(cfg, gen, device).to("cpu")
        init = host_copy(hpf_initial_state(coo.n, coo.m, k, priors, gen,
                                           device))
        dcoo = coo.to(device)

        def exact_step(st):
            return ref.hpf_step(st, dcoo.u, dcoo.i, dcoo.y, k, priors)

        base = {"config": args.config, "seed": seed, "nnz": coo.nnz,
                "n": coo.n, "m": coo.m,
                "device": torch.cuda.get_device_name(device) if cuda
                else "cpu"}
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
                counts = program.counts(multi)
                multi.reset()
                del state, dd, multi
                free()
                nums, leaves = lockstep(init, lambda s, _: chain[s],
                                        exact_step, steps, device)
                del chain
                free()
                emit({**base, "cell": f"{args.config}.{name}",
                      "kind": "program", "numbers": nums,
                      "worst_leaves": leaves, "counts": counts,
                      "info": info, "layout_s": layout_s})
        if seed in args.control_seeds:
            kinds = []
            for prec in precisions:
                low = ref.BELOW[prec]
                kinds.append(({"kind": f"control_{low}", "precision": prec},
                              lambda st, low=low: ref.hpf_step(
                                  st, dcoo.u, dcoo.i, dcoo.y, k, priors,
                                  low=low)))
                kinds.append(({"kind": "fault_altered", "precision": prec},
                              lambda st, prec=prec: planted(
                                  "altered", ref, st, dcoo, k, priors,
                                  compare.ALTERED[prec])))
            # the faults that read alike at every precision
            for fault in ("unchanged", "half_batch"):
                kinds.append(({"kind": f"fault_{fault}"},
                              lambda st, fault=fault: planted(
                                  fault, ref, st, dcoo, k, priors)))
            for tags, one_step in kinds:
                nums, leaves = lockstep(init, lambda s, st: one_step(st),
                                        exact_step, steps, device)
                free()
                emit({**base, **tags, "numbers": nums,
                      "worst_leaves": leaves})
        del dcoo
        free()
        print(f"# seed {seed}: {time.perf_counter() - t_seed:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
