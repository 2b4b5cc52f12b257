#!/usr/bin/env python3
"""Where a full-width training step of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_train_profile.py [--dtype float32|bfloat16] [--steps N] [--remat]
                                           [--plain]

Needs a CUDA device. Builds the same step as `chip_smoke.py`'s train phase
(cfg/darknet_dynamic.cfg + cfg/reweighting_net.cfg, 416x416, batch 64, 15-way
support set, the tracked checkpoint, episodes painted from the seed) or, with
`--plain`, as its plain_train phase (PlainTrainer on cfg/yolo-voc.cfg,
416x416, batch 64, seeded weights, batches painted from the seed), warms it
up, times N steps untraced on the host's clock, then traces N more with
`torch.profiler` (device activity only) and prints one JSON line: the
host-clock time of an untraced step, the device time summed over the traced
kernels, the device's idle share (1 - device time / untraced step time; the
trace itself slows the host), the time by kind of kernel (convolution,
matrix product, elementwise, reduction, pooling, copies, the port's own
`bn_sums` kernels) and the ten kernels that took most. Device times are
CUPTI's; the kinds are told by kernel name, so "other" is what no pattern
caught. Print the card's name and power limit beside any number you keep.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from fewshot_detection_tpu_torch.config import parse_cfg  # noqa: E402
from fewshot_detection_tpu_torch.eval import valid  # noqa: E402
from fewshot_detection_tpu_torch.models.meta import MetaSpec  # noqa: E402
from fewshot_detection_tpu_torch.models.spec import build_spec  # noqa: E402
from fewshot_detection_tpu_torch.train import MetaTrainer, init_momentum  # noqa: E402

KINDS = (
    ("bn_sums", ("bn_sums_",)),
    ("convolution", ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop", "cutlass",
                     "fft", "winograd")),
    ("matrix product", ("gemm", "cublas", "gemv")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "where", "index", "scatter", "gather", "sort")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, pats in KINDS:
        if any(p in low for p in pats):
            return kind
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--plain", action="store_true", help="the plain YOLOv2 step instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    valid.set_float32_precision(tf32=False)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]

    dtype = getattr(torch, args.dtype)
    if args.plain:
        setup = cs.PlainTrainSetup(args.seed)
        batch_size, lr = setup.sched.batch_size, setup.sched.lr
        params = setup.load_params()
        trainer = setup.make_trainer(dtype, remat=args.remat)
        episodes = [cs.make_plain_episode(args.seed + i, batch_size, args.dtype)
                    for i in range(2 + 2 * args.steps)]
        seen = 0
    else:
        dblocks, lblocks = parse_cfg(cs.DARKNET_CFG), parse_cfg(cs.LEARNET_CFG)
        spec = MetaSpec(build_spec(dblocks), build_spec(lblocks))
        sched = cs.schedule_from_cfg(dblocks[0], cs.TRAIN_NEG_RATIO, cs.TRAIN_N_CLS)
        batch_size = sched.batch_size
        params, header = cs.load_train_state(spec)
        trainer = MetaTrainer(spec, momentum=sched.momentum, weight_decay=sched.weight_decay,
                              metain_type=2, image_dtype=dtype, remat=args.remat, device="cuda")
        episodes = [cs.make_episode(args.seed + i, batch_size, cs.TRAIN_N_CLS, 416, args.dtype)
                    for i in range(2 + 2 * args.steps)]
        seen, processed = header.seen, header.seen // batch_size

        def lr(i):
            return sched.lr(processed + i)
    mom = init_momentum(params)

    def step(i):
        nonlocal params, mom, seen
        seen += batch_size
        params, mom, metrics = trainer.step(params, mom, episodes[i], seen=seen, lr=lr(i))
        return cs.format_loss_line(seen, metrics)  # the step's one host sync

    n = args.steps
    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 2 + n):
        step(i)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(2 + n, 2 + 2 * n):
            step(i)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3

    by_kind: dict[str, float] = {}
    kernels = []
    launches = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if not dev_us or ev.device_type.name != "CUDA":
            continue
        by_kind[kind_of(ev.key)] = by_kind.get(kind_of(ev.key), 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, ev.key))
        launches += ev.count
    device_ms = sum(by_kind.values())
    kernels.sort(reverse=True)
    print(smi, flush=True)
    print(json.dumps({
        "card": smi, "step": "plain" if args.plain else "meta", "dtype": args.dtype,
        "remat": args.remat, "steps_traced": n, "batch": batch_size, "wall_ms_per_step": untraced_ms / n,
        "wall_ms_per_step_traced": traced_ms / n, "device_ms_per_step": device_ms / n,
        "device_idle_share": max(0.0, 1.0 - device_ms / untraced_ms) if device_ms else None,
        "kernel_launches_per_step": launches / n,
        "ms_per_step_by_kind": {k: v / n for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"ms_per_step": ms / n, "calls_per_step": c / n, "name": name[:120]}
                        for ms, c, name in kernels[:10]],
        "profiler_saw_device_time": bool(device_ms),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
