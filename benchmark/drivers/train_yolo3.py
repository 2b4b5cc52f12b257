"""The YOLOv3 training traffic: a closed loop of the program's train step
on a net with [yolo] heads (`PlainTrainer`, its loss taken from the spec).

Parameters (the mix's file): `batch`, `size`, `pool` (distinct host
batches, cycled: every step copies its batch from pageable host memory, as
the CLI's loader hands it), `min_objects` and `max_objects` of a scene
(drawn uniformly), `object_sides` (rows [share, least, most]: a share of
the objects has the side, the root of its area, drawn uniformly between the
two, in pixels), `aspect` (the width over the height, drawn log-uniformly
between the two), `background_noise`, `reference_recompute` (the reference
keeps each convolution's input and computes the layer again in the
backward, so that it fits beside nothing else), `start_batches` (the
schedule's position), `checked_steps`, `warmup_steps` and
`profiled_steps`. The compute type is the configuration's `train_dtype`.

The run is `train.py`'s: set-up builds the trainer, the seed's weights and
the pool, takes the checked steps and reads them, warms up, then the
window; the plain reference (`reference/yolov3.py`) then takes the same
steps from the same seed. What differs is what the benchmark's own cfg
walk cannot read (the new kinds), the scenes (COCO's split of object
sizes, so that every head gets positives), one more reading (`numbers`:
the worst leaf's change, each leaf against its own), and with `--trace 1`
a third profiled stretch with the program's spans recorded, for
`yolo_loss_ms`.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from ..common import compare
from ..common.flops import bn_sums_bytes
from ..common.painting import Scene, paint, plain_labels, seeded_weights, torch_generator
from ..common.trace import SPIN, WARMUP_LAUNCHES, profile_stretch
from ..reference import yolov3 as ref
from . import train
from .train import change_norms, is_state, readings_of, ref_leaves

LOSS_SPAN = "train.loss"


def own_leaf_gap(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    """(worst gap, its leaf) over `leaves`, each leaf's gap taken against its
    own reference norm: |program - reference| / reference. A leaf left
    unmoved or moved twice reads 1 whatever its size (`compare`'s gap,
    over the larger of the leaf's and the median leaf's norm, reads less
    than 1 for a leaf that moves less than the median one)."""
    worst, where = 0.0, ""
    for k in sorted(leaves):
        gap = compare.rel_gap(prog[k], ref[k])
        if gap > worst or not where:
            worst, where = gap, k
    return worst, where


def numbers(prog: dict, ref: dict) -> dict:
    """`train.numbers`, and after each checked step k the worst leaf's
    change against its own (`delta_leaf_gap.k`, over the leaves the
    reference's gradient moves)."""
    moved = compare.moved_leaves(ref["grad"])
    out = train.numbers(prog, ref)
    for k, (a, b) in enumerate(zip(prog["deltas"], ref["deltas"]), 1):
        out[f"delta_leaf_gap.{k}"] = own_leaf_gap(a, b, moved)[0]
    return out


def nets_of(ctx) -> dict:
    cfg = ref.parse(ctx.path(ctx.config["darknet_cfg"]))
    return {"darknet": ref.walk(cfg, ctx.traffic["size"])}


def step_flops(layers, n: int) -> int:
    """FLOPs of a training step over n images, `common/flops.py`'s count:
    2*N*Ho*Wo*Cin*Cout*k^2 a conv forward, three times that in a step
    (forward, weight and input gradients), twice at the first conv, whose
    input needs no gradient. Shortcuts, routes, upsampling and the loss
    are not counted."""
    total, first = 0, True
    for layer in layers:
        if layer.kind != "conv":
            continue
        fwd = 2 * n * layer.side_out ** 2 * layer.c_in * layer.c_out * layer.size ** 2
        total += fwd * (2 if first else 3)
        first = False
    return total


def bn_layers(layers, n: int) -> list[tuple[int, int]]:
    """(M, C) of every batch-normalised conv output over n images."""
    return [(n * l.side_out ** 2, l.c_out) for l in layers if l.kind == "conv" and l.bn]


def layouts(rng: np.random.Generator, n: int, n_classes: int, tr: dict) -> list[Scene]:
    """n scene layouts [(cls, cx, cy, w, h, r, g, b)] normalised, with
    COCO-like object sizes (see the module's docstring); each scene
    carries its background's noise amplitude."""
    shares = np.array([row[0] for row in tr["object_sides"]], float)
    shares /= shares.sum()
    lo, hi = (math.log(a) for a in tr["aspect"])
    out = []
    for _ in range(n):
        amp = float(rng.uniform(*tr["background_noise"]))
        objs = []
        for _ in range(int(rng.integers(tr["min_objects"], tr["max_objects"] + 1))):
            _, least, most = tr["object_sides"][int(rng.choice(len(shares), p=shares))]
            side = rng.uniform(least, most) / tr["size"]
            aspect = math.exp(rng.uniform(lo, hi))
            w, h = side * math.sqrt(aspect), side / math.sqrt(aspect)
            cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
            objs.append((int(rng.integers(n_classes)), cx, cy, w, h,
                         *rng.uniform(120 / 255, 1.0, 3)))
        out.append(Scene(objs, amp))
    return out


def make_pool(ctx, device) -> list[dict]:
    """The mix's distinct host batches in the layout and type the CLI
    ships: images (1, b, S, S, 3), targets (1, b, 50, 5) and keep weights
    (1, b) as numpy arrays."""
    tr = ctx.traffic
    rng = np.random.default_rng(ctx.seed)
    gen = torch_generator(ctx.seed, device)
    dtype = getattr(torch, ctx.config["train_dtype"])
    pool = []
    for _ in range(tr["pool"]):
        scenes = layouts(rng, tr["batch"], ctx.config["classes"], tr)
        x = paint(scenes, tr["size"], tr["size"], gen, device).to(dtype)[None].cpu()
        pool.append({"x": x, "target": plain_labels(scenes)[None],
                     "keep": np.ones((1, tr["batch"]), np.float32)})
    return pool


def reference_steps(ctx, nets, pool, sched, device, precision="fp32", half=False) -> dict:
    """The plain reference's checked steps from the seed's weights on the
    same pool batches, in the configuration's `train_dtype` (TF32 off; the
    operands rounded to `precision` for the control). `half` plants a
    fault: half of each batch left out and the loss taken over the rest,
    times two."""
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


class Program(train.Program):
    """The program's side: `train.Program` with the trainer built from the
    cfg the program reads (the spec first, so that a program without the
    cfg's kinds fails at once), the nets from the reference's walk and the
    pool from this mix. With `counts` set, each step's per-head positives
    and ignored predictions are kept (left on the device)."""

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

    def start(self) -> None:
        from fewshot_detection_tpu_torch.models.convert import require_grads
        from fewshot_detection_tpu_torch.train import init_momentum

        ctx, tr = self.ctx, self.ctx.traffic
        weights = seeded_weights(self.nets, ctx.seed, ctx.device)
        self.params = require_grads(train.port_tree(self.nets, weights, "plain"))
        self.mom = init_momentum(self.params)
        self.pool = make_pool(ctx, ctx.device)
        self.i, self.processed = 0, tr["start_batches"]
        self.seen = tr["start_batches"] * tr["batch"]

    def step(self) -> dict:
        metrics = super().step()
        if self.counts is not None:
            self.counts.append((metrics["positives"], metrics["ignored"]))
        return metrics


def loss_stretch(prog, ctx, steps: int) -> tuple[float | None, int]:
    """(device seconds of the kernels launched while `train.loss` is the
    innermost open span, how many such spans) over `steps` steps profiled
    with device activity alone and the program's spans recorded. A kernel
    belongs to the span open at its launch (the `cuda_runtime` call of the
    same correlation id), as `utils/trace_summary.idle_by_span` lays spans
    over a trace; seconds None where the trace has no kernel (the CPU) or
    the program records no spans."""
    from torch.profiler import ProfilerActivity, profile

    try:
        from fewshot_detection_tpu_torch.utils.profiling import recording
    except ImportError:
        return None, 0
    acts = [ProfilerActivity.CUDA] if ctx.cuda else [ProfilerActivity.CPU]
    with recording() as spans:
        with profile(activities=acts) as prof:
            if ctx.cuda:  # a trace on the card can miss its first device events
                for _ in range(WARMUP_LAUNCHES):
                    torch.cuda._sleep(1)
                ctx.sync()
            for _ in range(steps):
                prog.step()
            ctx.sync()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    base = int(doc.get("baseTimeNanoseconds", 0))
    opened = sorted(((s.start - base) / 1e3, (s.end - base) / 1e3, s.name) for s in spans)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel" and SPIN not in e["name"]]
    n_spans = sum(name == LOSS_SPAN for *_, name in opened)
    if not kernels or not opened:
        return None, n_spans
    total = 0.0
    for e in kernels:
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        inner = [s for s in opened if s[0] <= t < s[1]]
        if inner and max(inner)[2] == LOSS_SPAN:  # the latest start is the innermost
            total += float(e["dur"]) / 1e6
    return total, n_spans


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    prog = Program(ctx)
    prog.start()
    ctx.log("program set up")
    prog.counts = []
    readings = prog.checked()
    counts = [([int(v) for v in p.tolist()], int(i)) for p, i in prog.counts]
    prog.counts = None
    ctx.log(f"checked steps: positives by head and ignored predictions {counts}")
    for _ in range(tr["warmup_steps"]):
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
