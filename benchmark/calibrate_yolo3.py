#!/usr/bin/env python3
"""`calibrate.py`'s readings for a cell whose mix's driver is `train_yolo3`.

    python3 benchmark/calibrate_yolo3.py --workload yolov3_coco.train_b64_608 \
        --seeds a,b,... [--controls c,d,e] [--dtype float32] [--lr-scale s] \
        [--look] [--dump DIR]

The same arguments, lines and `CALIBRATION {...}` summary as `calibrate.py`:
for each seed of `--seeds` the program's compared numbers against the plain
reference (the lower readings); for each seed of `--controls` the reference
at the precision below the configuration's (bfloat16: int8 and fp8) and with
half of each batch left out, against the reference (the upper readings).
Each program line also names the worst leaf after each checked step, each
leaf against its own change (`delta_worst_leaf.k`, the leaf of
`delta_leaf_gap.k`), and its reference change over the median leaf's
(`delta_worst_share.k`).

Three more options look at why the worst leaf's gap grows from step to
step: `--lr-scale` multiplies the schedule's learning rate (program and
reference alike), `--look` adds the configuration's reference against the
reference in float32 (`reference_vs_float32`: how far the type alone puts
each leaf), and `--dump` writes every leaf's norms of each seed to
`DIR/<seed>.json`. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worst_by_step(got: dict, ref: dict, moved: list) -> dict:
    """The worst leaf of the change after each checked step, each leaf
    against its own (`delta_leaf_gap.k`), and its reference change over the
    median leaf's."""
    import statistics

    from benchmark.drivers import train_yolo3 as drv

    out = {}
    for k, (a, b) in enumerate(zip(got["deltas"], ref["deltas"]), 1):
        name = drv.own_leaf_gap(a, b, moved)[1]
        out[f"delta_worst_leaf.{k}"] = name
        out[f"delta_worst_share.{k}"] = b[name] / statistics.median(b[m] for m in moved)
    return out


def train_readings(ctx, seeds, controls, precisions, lr_scale=1.0, look=False,
                   dump=None) -> list[dict]:
    from benchmark.common import compare
    from benchmark.drivers import train_yolo3 as drv

    prog = drv.Program(ctx)
    prog.sched.base *= lr_scale
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
            pool = drv.make_pool(ctx, ctx.device)
        ref = drv.reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device)
        if seed in seeds:
            moved = compare.moved_leaves(ref["grad"])
            out.append({"seed": seed, "kind": "program", **drv.numbers(got, ref),
                        "grad_worst_leaf": compare.worst_leaf_gap(got["grad"], ref["grad"])[1],
                        "delta_worst_leaf": compare.worst_leaf_gap(got["delta"], ref["delta"],
                                                                   moved)[1],
                        **worst_by_step(got, ref, moved),
                        "leaves_left_out": len(ref["grad"]) - len(moved)})
            ref32 = None
            if look:
                config = ctx.config
                ctx.config = dict(config, train_dtype="float32")
                ref32 = drv.reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device)
                ctx.config = config
                out.append({"seed": seed, "kind": "reference_vs_float32",
                            **drv.numbers(ref, ref32), **worst_by_step(ref, ref32, moved)})
            if dump:
                with open(os.path.join(dump, f"{seed}.json"), "w") as f:
                    json.dump({"seed": seed, "dtype": ctx.config["train_dtype"],
                               "lr": [prog.sched.lr(ctx.traffic["start_batches"] + s)
                                      for s in range(ctx.traffic["checked_steps"])],
                               "program": got, "reference": ref, "reference_float32": ref32},
                              f)
        if seed in controls:
            for control in precisions:
                low = drv.reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device, control)
                out.append({"seed": seed, "kind": f"control_{control}",
                            **drv.numbers(low, ref)})
            half = drv.reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device, half=True)
            out.append({"seed": seed, "kind": "fault_half_batch", **drv.numbers(half, ref)})
        for line in out:
            if line["seed"] == seed:
                print(json.dumps({**line, "seconds": time.perf_counter() - t}), flush=True)
        ctx.free()
    return out


def main(argv=None, device=None, root=None) -> int:
    root = root or ROOT
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import calibrate, run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program")
    ap.add_argument("--controls", default="", help="comma-separated seeds of the control")
    ap.add_argument("--control", default=None,
                    help="comma-separated precisions of the control (default: the one "
                         "below the configuration's)")
    ap.add_argument("--dtype", default=None,
                    help="run the program in this type instead of the configuration's")
    ap.add_argument("--lr-scale", type=float, default=1.0,
                    help="multiply the schedule's learning rate by this")
    ap.add_argument("--look", action="store_true",
                    help="also read the reference against the reference in float32")
    ap.add_argument("--dump", default=None, help="write each seed's leaf norms here")
    args = ap.parse_args(argv)

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
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    ctx = run.Context(root, cell, config, traffic, 0, 0.0, False, device, time.perf_counter())
    print(run.card_line(ctx.cuda), flush=True)
    seeds, controls = calibrate.seeds_of(args.seeds), calibrate.seeds_of(args.controls)
    precisions = (args.control or calibrate.CONTROL[config["train_dtype"]]).split(",")
    out = train_readings(ctx, seeds, controls, precisions, args.lr_scale, args.look, args.dump)
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
