#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,... [--controls c,d,e]

For each seed of `--seeds`, the program's compared numbers against the
plain reference, taken as a run takes them (the lower readings). For each
seed of `--controls`, the same numbers of the control: the reference in
the program's place at the precision just below the configuration's
(float32 -> TF32, bfloat16 -> int8 and fp8), and of the fault "half of the
batch left out, the mean taken over the rest", planted in the reference
(the upper readings). Each reading also gives the gaps after each checked
step (`loss_gap.k`, `delta_gap.k`, `delta_median_gap.k`), to show how
they grow from step to step. One process serves every seed, so set-up is
paid once. Prints one JSON line a seed and reading, then a summary line
`CALIBRATION {...}`. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL = {"float32": "tf32", "bfloat16": "int8,fp8"}


def seeds_of(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def train_readings(ctx, seeds, controls, precisions) -> list[dict]:
    from benchmark.common import compare
    from benchmark.drivers import train

    prog = train.Program(ctx)
    out = []
    for seed in seeds + controls:
        ctx.seed = seed
        t = time.perf_counter()
        if seed in seeds:
            prog.start()
            got = prog.checked()
            pool = prog.pool
            prog.free()
        else:
            pool = train.make_pool(ctx, ctx.device)
        ref = train.reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device)
        if seed in seeds:
            moved = compare.moved_leaves(ref["grad"])
            out.append({"seed": seed, "kind": "program", **train.numbers(got, ref),
                        "grad_worst_leaf": compare.worst_leaf_gap(got["grad"], ref["grad"])[1],
                        "delta_worst_leaf": compare.worst_leaf_gap(got["delta"], ref["delta"],
                                                                   moved)[1],
                        "leaves_left_out": len(ref["grad"]) - len(moved)})
        if seed in controls:
            for control in precisions:
                low = train.reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device,
                                            control)
                out.append({"seed": seed, "kind": f"control_{control}",
                            **train.numbers(low, ref)})
            half = train.reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device, half=True)
            out.append({"seed": seed, "kind": "fault_half_batch", **train.numbers(half, ref)})
        for line in out:
            if line["seed"] == seed:
                print(json.dumps({**line, "seconds": time.perf_counter() - t}), flush=True)
        ctx.free()
    return out


def main(argv=None, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program")
    ap.add_argument("--controls", default="", help="comma-separated seeds of the control")
    ap.add_argument("--control", default=None,
                    help="comma-separated precisions of the control (default: the one "
                         "below the configuration's)")
    ap.add_argument("--dtype", default=None,
                    help="run the program in this type instead of the configuration's "
                         "(a second witness: float32 should meet the reference)")
    args = ap.parse_args(argv)
    root = root or ROOT
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import run

    run.set_cache_dirs(root)
    _, cell, config, traffic = run.load_cell(root, args.workload)
    if args.dtype:
        config = dict(config, train_dtype=args.dtype)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    ctx = run.Context(root, cell, config, traffic, 0, 0.0, False, device, time.perf_counter())
    print(run.card_line(ctx.cuda), flush=True)
    seeds, controls = seeds_of(args.seeds), seeds_of(args.controls)
    precisions = (args.control or CONTROL[config["train_dtype"]]).split(",")
    out = train_readings(ctx, seeds, controls, precisions)
    summary = {}
    for line in out:
        for k, v in line.items():
            if k not in ("seed", "kind") and not isinstance(v, str):
                summary.setdefault(line["kind"], {}).setdefault(k, []).append(v)
    print("CALIBRATION " + json.dumps({k: {n: [min(v), max(v)] for n, v in d.items()}
                                       for k, d in summary.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
