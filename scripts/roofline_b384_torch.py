#!/usr/bin/env python3
"""Roofline of the PyTorch port's bench step (batch 384, bfloat16) on
the card.

The counterpart of scripts/roofline_b384.py. The step is bench_torch.py's
(the same cfgs, seeded parameters, batch and trainer; momentum from zero).
XLA's cost analysis of a compiled step has no counterpart in an eager
program, so one whole step, forward and backward, is counted as it runs:

  flops  `torch.utils.flop_counter.FlopCounterMode`: convolutions and
         matrix products only (XLA's `flops` also counts elementwise
         work). `spec_flops` counts the same from the spec alone, and the
         two must agree exactly.
  bytes  a `TorchDispatchMode` that adds up, for every ATen op of the step
         (in an eager program each op is a launch, the counterpart of one
         XLA fusion), the bytes of its tensor inputs read once and of its
         tensor outputs written once. A broadcast input counts the memory
         it spans, not its shape; an in-place op counts its operand read
         and written; view ops and allocations move nothing. The bn_sums
         and bn_act kernels are ctypes calls the mode cannot see: their
         bytes come from the shapes their wrappers were given (bn_sums'
         forward reads x and writes 2*C floats, its backward reads x, dsum
         and dsq and writes dx; bn_act's forward reads y and writes out,
         its backward reads dout and y and writes dy, each with the pair);
         so do the maxpool2x2 kernels' (the forward reads x and writes y
         and its window code, a byte an output element; the backward reads
         dy and the code and writes dx).

Then 2 warm-up and 5 timed steps give the step time, and the roofline
shares are taken against the card's published dense bfloat16 tensor peak
and HBM rate (`PEAKS`, keyed on `torch.cuda.get_device_name()`; a card the
table lacks is refused). `mfu_pct` takes the place of the JAX script's
`mxu_util_pct`. What nvidia-smi reports of the card's clocks and its SM
count are printed beside the peaks, not used: 132 SMs x 4096 FLOP a clock x
the maximum SM clock gives more than the published peak whenever that clock
is above 1.83 GHz.

    python scripts/roofline_b384_torch.py [--device cuda]

Prints the card and its power limit, then one line `ROOFLINE {...}`.
`--device cpu` runs the same count on the CPU (the kernels' plain versions,
so the bytes differ), with no peak and no utilization; for tests only.
"""

import argparse
import contextlib
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SIZE, N_CLS, BATCH = 416, 15, 384
WARMUP, ITERS = 2, 5
FLOPS_COUNTED = "conv+matmul, fwd+bwd"
# published dense (no sparsity) bfloat16 tensor-core peak and HBM rate, by the
# name torch.cuda.get_device_name() reports (NVIDIA H100 SXM data sheet)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.4, "hbm_gbs": 3350.0}}


def peaks_of(name: str) -> dict:
    if name not in PEAKS:
        raise ValueError(f"no published peak for the card {name!r}; PEAKS holds "
                         f"{sorted(PEAKS)}: add the card's data-sheet figures")
    return PEAKS[name]


def spec_flops(spec, batch: int, n_cls: int, size: int) -> int:
    """Convolution and matrix-product FLOPs of one training step, forward
    and backward, from the spec alone. A conv: 2*N*Ho*Wo*Cin*Cout*k^2/groups
    forward, as much again for its weight gradient, and as much again for
    its input gradient except at a net's first conv, whose input needs
    none. The learnet runs on the n_cls support images, the backbone on the
    batch; the backbone's dynamic conv and the head after it run as the
    fused reweight+head product, (N*H*W, C) x (C, n_cls*K): 2*N*H*W*C*n_cls*K
    forward, and both of its operands' gradients."""
    return _net_flops(spec.learnet, n_cls, size, n_cls) + _net_flops(
        spec.darknet, batch, size, n_cls)


def _net_flops(net, n: int, size: int, n_cls: int) -> int:
    sides = {}
    side, total, first, fused = size, 0, True, False
    for i, layer in enumerate(net.layers):
        if fused:  # the head, inside the fused product
            fused = False
        elif layer.kind == "conv" and layer.dynamic:
            head = net.layers[i + 1]
            if not (layer.size == 1 and head.kind == "conv" and head.size == 1
                    and not head.dynamic and not layer.batch_normalize):
                raise ValueError(f"layer {layer.index}: a dynamic conv the trainer "
                                 "does not fuse with its head")
            total += 3 * 2 * n * side * side * layer.in_channels * n_cls * head.out_channels
            fused = True
        elif layer.kind == "conv":
            side = (side + 2 * layer.pad - layer.size) // layer.stride + 1
            fwd = (2 * n * side * side * layer.in_channels * layer.out_channels
                   * layer.size ** 2 // layer.groups)
            total += fwd * (2 if first else 3)
            first = False
        elif layer.kind == "maxpool" and layer.stride > 1:
            side = (side - layer.size) // layer.stride + 1
        elif layer.kind == "reorg":
            side //= layer.stride
        elif layer.kind == "route":
            side = sides[layer.sources[0]]
        elif layer.kind in ("globalmax", "globalavg", "avgpool"):
            side = 1
        sides[layer.index] = side
    return total


def _distinct_bytes(t) -> int:
    """Bytes of the memory a tensor spans: a zero stride repeats an
    element, it does not read another."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _byte_counter(device):
    """A TorchDispatchMode adding up the bytes of the ATen ops on `device`
    (see the module's docstring)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    aten = torch.ops.aten
    alloc_only = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
                  aten.new_empty_strided}

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and func.overloadpacket not in alloc_only:
                n = sum(_distinct_bytes(t) for t in tree_leaves((args, kwargs, out))
                        if isinstance(t, torch.Tensor) and t.device.type == device.type)
                if n:
                    self.bytes += n
                    self.ops += 1
            return out

    return ByteCounter()


@contextlib.contextmanager
def bn_sums_bytes(record: list):
    """Appends the bytes each bn_sums kernel launch moves to `record`, by
    standing in for the wrapper's two launch functions."""
    from fewshot_detection_tpu_torch.ops import bn_sums as bn_mod

    fwd, bwd = bn_mod._launch_forward, bn_mod._launch_backward

    def forward(x):
        record.append(x.numel() * x.element_size() + 2 * x.shape[-1] * 4)
        return fwd(x)

    def backward(x, dsum, dsq):
        record.append(2 * x.numel() * x.element_size() + 2 * x.shape[-1] * 4)
        return bwd(x, dsum, dsq)

    bn_mod._launch_forward, bn_mod._launch_backward = forward, backward
    try:
        yield record
    finally:
        bn_mod._launch_forward, bn_mod._launch_backward = fwd, bwd


@contextlib.contextmanager
def bn_act_bytes(record: list):
    """Appends the bytes each bn_act kernel launch moves to `record`, by
    standing in for the wrapper's two launch functions: the forward reads y
    and writes out, the backward reads dout and y and writes dy; the pair
    (2 x C floats) is read and its gradients written."""
    from fewshot_detection_tpu_torch.ops import bn_act as act_mod

    fwd, bwd = act_mod._launch_forward, act_mod._launch_backward

    def forward(y, inv, bias, act):
        record.append(2 * y.numel() * y.element_size() + 2 * y.shape[-1] * 4)
        return fwd(y, inv, bias, act)

    def backward(dout, y, inv, bias, act):
        record.append(3 * y.numel() * y.element_size() + 4 * y.shape[-1] * 4)
        return bwd(dout, y, inv, bias, act)

    act_mod._launch_forward, act_mod._launch_backward = forward, backward
    try:
        yield record
    finally:
        act_mod._launch_forward, act_mod._launch_backward = fwd, bwd


@contextlib.contextmanager
def pool_bytes(record: list):
    """Appends the bytes each maxpool2x2 kernel launch moves to `record`, by
    standing in for the wrapper's two launch functions: the forward reads x
    and writes y and, for a backward, a byte of code an output element; the
    backward reads dy and the code and writes dx."""
    from fewshot_detection_tpu_torch.ops import pool2x2 as pool_mod

    fwd, bwd = pool_mod._launch_forward, pool_mod._launch_backward

    def forward(x, with_code):
        b, h, w, c = x.shape
        out = b * (h // 2) * (w // 2) * c
        record.append((x.numel() + out) * x.element_size() + (out if with_code else 0))
        return fwd(x, with_code)

    def backward(dy, code, h, w):
        record.append(dy.numel() * dy.element_size() + code.numel()
                      + dy.shape[0] * h * w * dy.shape[3] * dy.element_size())
        return bwd(dy, code, h, w)

    pool_mod._launch_forward, pool_mod._launch_backward = forward, backward
    try:
        yield record
    finally:
        pool_mod._launch_forward, pool_mod._launch_backward = fwd, bwd


def count_step(trainer, params, mom, batch, seen: int) -> dict:
    """One training step with its FLOPs and bytes counted (the step is
    taken: params and mom move)."""
    from torch.utils.flop_counter import FlopCounterMode

    kernel, epilogue, pools = [], [], []
    with FlopCounterMode(display=False) as flops, _byte_counter(trainer.device) as mode, \
            bn_sums_bytes(kernel), bn_act_bytes(epilogue), pool_bytes(pools):
        _, _, metrics = trainer.step(params, mom, batch, seen=seen, lr=1e-5)
        float(metrics["loss"])
    return {"flops": flops.get_total_flops(), "aten_bytes": mode.bytes, "aten_ops": mode.ops,
            "bn_sums_bytes": sum(kernel), "bn_sums_launches": len(kernel),
            "bn_act_bytes": sum(epilogue), "bn_act_launches": len(epilogue),
            "pool_bytes": sum(pools), "pool_launches": len(pools)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the device the steps run on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    import bench_torch
    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.utils.card import card_line, nvidia_smi

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    print(card_line(dev), flush=True)
    peak = None
    if on_card:
        name = torch.cuda.get_device_name(dev)
        peak = peaks_of(name)
        clocks = nvidia_smi("clocks.max.sm,clocks.max.mem", dev.index or 0)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f"peaks of {name}: {peak['bf16_tflops']} TFLOP/s dense bfloat16, "
              f"{peak['hbm_gbs']} GB/s HBM (data sheet); nvidia-smi clocks.max.sm, "
              f"clocks.max.mem: {clocks}; {sms} SMs", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)

    trainer, p, m = bench_torch.make_trainer(dev)
    batch = bench_torch.make_batch(BATCH, dev, SIZE, N_CLS)
    counted = count_step(trainer, p, m, batch, seen=20000)
    flops = counted["flops"]
    bytes_acc = (counted["aten_bytes"] + counted["bn_sums_bytes"] + counted["bn_act_bytes"]
                 + counted["pool_bytes"])
    want = spec_flops(trainer.spec, BATCH, N_CLS, SIZE)

    for i in range(WARMUP):
        p, m, metrics = trainer.step(p, m, batch, seen=20001 + i, lr=1e-5)
    bench_torch.fence(dev, metrics)
    t0 = time.perf_counter()
    for i in range(ITERS):
        p, m, metrics = trainer.step(p, m, batch, seen=20100 + i, lr=1e-5)
    bench_torch.fence(dev, metrics)
    dt = (time.perf_counter() - t0) / ITERS

    out = {
        "batch": BATCH,
        "step_ms": round(dt * 1e3, 1),
        "img_per_s": round(BATCH / dt, 1),
        "cost_flops_per_step": flops,
        "cost_bytes_per_step": bytes_acc,
        "gflop_per_image": round(flops / BATCH / 1e9, 1),
        "hbm_mb_per_image": round(bytes_acc / BATCH / 1e6, 1),
        "arith_intensity_flop_per_byte": round(flops / bytes_acc, 1),
        "achieved_tflops": round(flops / dt / 1e12, 1),
        "achieved_gbs": round(bytes_acc / dt / 1e9, 1),
        "mfu_pct": round(100 * flops / dt / 1e12 / peak["bf16_tflops"], 1) if peak else None,
        "hbm_util_pct": round(100 * bytes_acc / dt / 1e9 / peak["hbm_gbs"], 1) if peak else None,
        "flops_counted": FLOPS_COUNTED,
        "spec_flops_per_step": want,
        "aten_bytes_per_step": counted["aten_bytes"],
        "aten_ops_per_step": counted["aten_ops"],
        "bn_sums_bytes_per_step": counted["bn_sums_bytes"],
        "bn_sums_launches_per_step": counted["bn_sums_launches"],
        "bn_act_bytes_per_step": counted["bn_act_bytes"],
        "bn_act_launches_per_step": counted["bn_act_launches"],
        "pool_bytes_per_step": counted["pool_bytes"],
        "pool_launches_per_step": counted["pool_launches"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if on_card else None,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    print("ROOFLINE " + json.dumps(out), flush=True)
    if flops != want:
        raise SystemExit(f"the counted FLOPs {flops} differ from the spec's {want}")
    return out


if __name__ == "__main__":
    main()
