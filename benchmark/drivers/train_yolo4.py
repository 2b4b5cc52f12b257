"""The YOLOv4 training traffic: `train_yolo3`'s closed loop of the
program's train step on a net with [yolo] heads (`PlainTrainer`, its loss
taken from the spec), on a cfg with YOLOv4's kinds.

The parameters of the mix, the scenes, the pool, the window, the readings
and the loss's profiled stretch are `train_yolo3`'s. What differs is the
plain reference, `reference/yolov4.py` (Mish, stride-1 max pools, routes of
any number of sources, `scale_x_y`, assignments above `iou_thresh` and the
CIoU box term), which walks the cfg for the nets, the FLOPs and the batch
norm shapes and takes the reference's checked steps; set-up also reads one
step's span counts (`mish_forward`, `mish_backward` of `train.step`), and
each checked step's assignments beyond the truths' best anchors
(`extra_positives`). With `--trace 1` the record carries the profiled
stretch for `mish_ms`, which reads the kernels whose names hold "mish".

A program that cannot build the cfg (a route of four sources, a Mish
layer, an odd stride-1 pool) fails when the trainer is built, at set-up.
"""

from __future__ import annotations

import time

import torch

from ..common.flops import bn_sums_bytes
from ..common.painting import seeded_weights
from ..common.trace import profile_stretch
from ..reference import yolov4 as ref
from . import train, train_yolo3
from .train import change_norms, is_state, readings_of, ref_leaves
# make_pool and own_leaf_gap are this driver's too: calibrate_yolo3.py reads them from
# the driver that calibrate_yolo4.py hands it
from .train_yolo3 import (LOSS_SPAN, bn_layers, loss_stretch, make_pool, numbers, own_leaf_gap,
                          step_flops)


def nets_of(ctx) -> dict:
    cfg = ref.parse(ctx.path(ctx.config["darknet_cfg"]))
    return {"darknet": ref.walk(cfg, ctx.traffic["size"])}


def reference_steps(ctx, nets, pool, sched, device, precision="fp32", half=False) -> dict:
    """`train_yolo3.reference_steps` with the YOLOv4 reference: the checked
    steps from the seed's weights on the same pool batches, in the
    configuration's `train_dtype` (TF32 off; the operands rounded to
    `precision` for the control); `half` plants the half-batch fault."""
    cfg, tr = ctx.config, ctx.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg["train_dtype"])
    w = seeded_weights(nets, ctx.seed, device)
    p = ref_leaves(w)
    for k, t in p.items():
        if not is_state(k):
            t.requires_grad_(True)
    p0 = {k: t.detach().clone() for k, t in p.items()}
    mom = {f"{i}.{k}": torch.zeros_like(t) for i, q in w["darknet"].items() for k, t in q.items()
           if not is_state(k)}
    processed = tr["start_batches"]
    losses, m1, deltas = [], None, []
    for step in range(tr["checked_steps"]):
        batch = pool[step]
        lr = sched.lr(processed)
        processed += 1
        x = batch["x"][0].to(device, dtype)
        target = torch.as_tensor(batch["target"][0], device=device)
        keep = torch.as_tensor(batch["keep"][0], device=device)
        b = x.shape[0]
        kb = b // 2 if half else b
        losses.append(ref.train_step(nets["darknet"], w["darknet"], mom, x[:kb], target[:kb],
                                     keep[:kb], lr=lr, momentum=sched.momentum,
                                     decay=sched.decay, precision=precision,
                                     recompute=tr["reference_recompute"], loss_scale=b / kb))
        deltas.append(change_norms(p0, p))
        if step == 0:
            m1 = {f"darknet.{k}": v.clone() for k, v in mom.items()}
    p3 = {k: t.detach() for k, t in p.items()}
    return readings_of(losses, p0, m1, deltas, p3, sched, cfg)


class Program(train_yolo3.Program):
    """`train_yolo3.Program` on the YOLOv4 reference's walk. With `counts`
    set, each step's per-head positives, ignored predictions and extra
    positives are kept (left on the device)."""

    def __init__(self, ctx):
        from fewshot_detection_tpu_torch.config import parse_cfg
        from fewshot_detection_tpu_torch.eval.valid import set_float32_precision
        from fewshot_detection_tpu_torch.models.spec import build_spec
        from fewshot_detection_tpu_torch.train import PlainTrainer
        from fewshot_detection_tpu_torch.utils import format_loss_line

        cfg, tr = ctx.config, ctx.traffic
        spec = build_spec(parse_cfg(ctx.path(cfg["darknet_cfg"])))
        self.ctx, self.format_loss_line = ctx, format_loss_line
        set_float32_precision(tf32=False)  # as the training CLIs set it
        self.nets = nets_of(ctx)
        self.sched = train.Schedule(ref.parse(ctx.path(cfg["darknet_cfg"]))[0], tr["batch"],
                                    cfg["lr_factor"])
        self.dtype = getattr(torch, cfg["train_dtype"])
        self.trainer = PlainTrainer(spec, momentum=self.sched.momentum,
                                    weight_decay=self.sched.decay, image_dtype=self.dtype,
                                    device=ctx.device)
        self.counts = None

    def step(self) -> dict:
        metrics = train.Program.step(self)
        if self.counts is not None:
            self.counts.append((metrics["positives"], metrics["ignored"],
                                metrics.get("extra_positives", torch.zeros(()))))
        return metrics


def step_counts(prog) -> dict:
    """The `train.step` span's counts of one step (the Mish calls each way
    among them)."""
    from fewshot_detection_tpu_torch.utils.profiling import recording

    with recording() as spans:
        prog.step()
    return next((dict(s.counts) for s in spans if s.name == "train.step"), {})


def run(ctx) -> dict:
    tr = ctx.traffic
    prog = Program(ctx)
    prog.start()
    ctx.log("program set up")
    prog.counts = []
    readings = prog.checked()
    counts = [([int(v) for v in p.tolist()], int(i), int(e)) for p, i, e in prog.counts]
    prog.counts = None
    ctx.log(f"checked steps: positives by head, ignored predictions and extra positives {counts}")
    ctx.log(f"a step's span counts: {step_counts(prog)}")
    for _ in range(tr["warmup_steps"] - 1):
        prog.step()
    ctx.sync()

    t_start = time.perf_counter()
    steps = 0
    while True:
        prog.step()
        steps += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_start
    setup_s = t_start - ctx.t0
    ctx.log(f"window: {steps} steps in {window_s:.3f} s")

    layers = prog.nets["darknet"]
    rec = {"kind": "train", "untraced_s": window_s, "steps": steps,
           "step_flops": step_flops(layers, tr["batch"]),
           "bn_bytes_per_step": bn_sums_bytes(bn_layers(layers, tr["batch"]),
                                              prog.dtype.itemsize)}
    if ctx.trace:
        n = tr["profiled_steps"]
        trace = rec["trace"] = profile_stretch(lambda: [prog.step() for _ in range(n)],
                                               ctx.cuda, n)
        ctx.log(f"untraced: {1e3 * window_s / steps:.2f} ms a step")
        for what, t in (("device activity alone", trace), ("with host operators", trace.named)):
            if t is not None and t.device:
                ctx.log(f"profiled, {what}: {1e3 * t.host_s / n:.2f} ms a step on the host, "
                        f"device busy {1e3 * t.busy_s / n:.2f} ms a step, idle {t.idle_pct():.2f}%")
        rec["loss_device_s"], spans = loss_stretch(prog, ctx, n)
        rec["loss_steps"] = n
        ctx.log(f"spans stretch: {spans} {LOSS_SPAN} spans in {n} steps, loss kernels "
                f"{rec['loss_device_s']} s")
    memory = ctx.memory_peak()
    pool = prog.pool
    prog.free()

    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ref_readings = reference_steps(ctx, prog.nets, pool, prog.sched, ctx.device)
    ctx.log(f"reference done, its peak device memory {ctx.memory_peak()} bytes")
    return {
        "e2e": {"train_img_s": steps * tr["batch"] / window_s, "setup_s": setup_s},
        "attempted": steps, "failed": 0, "memory": memory, "record": rec,
        "readings": numbers(readings, ref_readings),
    }
