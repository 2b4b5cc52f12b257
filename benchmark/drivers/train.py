"""The training traffic: a closed loop of the program's train step.

Parameters (the mix's file): `batch`, `size`, `remat` (the program keeps
conv outputs and recomputes the epilogues in the backward; the reference
then recomputes each layer there, so that it fits too), `pool` (distinct
host batches, cycled: every step copies its batch from pageable host
memory, as the CLI's loader hands it), `max_objects` and
`background_noise` of a scene, `start_batches` (the schedule's position:
inside the cfg's first step of the learning rate, which takes a tenth of
it, and past the coordinate warm-up), `checked_steps`, `warmup_steps` and
`profiled_steps`. The compute type is the configuration's `train_dtype`,
as FSD_DTYPE sets it.

Set-up builds ONE trainer with its parameters and momentum, takes the
checked steps through the loop's own call on pool batches that all
differ, reads their losses, the first gradient (from the momentum after
one step: m1 = g1 + wd * p0) and the change of every leaf after each
checked step, then warms up and hands the same objects to the window.
After the window the program's state is freed and the plain reference
takes the same steps from the same seed (`reference_steps`), in the type
the configuration states.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common import compare
from ..common.cfgparse import parse, region, walk
from ..common.flops import bn_layers, bn_sums_bytes, meta_step_flops, net_flops
from ..common.painting import (binned_labels, box_mask, layouts, neg_keep, paint,
                               plain_labels, seeded_weights, torch_generator)
from ..common.trace import profile_stretch
from ..reference import darknet as ref_net
from ..reference.region_loss import lr_at, region_loss, region_loss_v2


def nets_of(ctx) -> dict:
    nets = {"darknet": walk(parse(ctx.path(ctx.config["darknet_cfg"])))}
    if ctx.config["model"] == "meta":
        nets["learnet"] = walk(parse(ctx.path(ctx.config["learnet_cfg"])))
    return nets


class Schedule:
    """The CLI's optimizer settings from the cfg's [net] block: the
    learning rate divided by the LR factor and handed over / batch, the
    decay times batch times factor."""

    def __init__(self, header: dict, batch: int, factor: float):
        self.batch, self.factor = batch, factor
        self.momentum = float(header["momentum"])
        self.decay = float(header["decay"]) * batch * factor
        self.base = float(header["learning_rate"]) / factor
        self.steps = tuple(float(s) for s in header["steps"].split(","))
        self.scales = tuple(float(s) for s in header["scales"].split(","))

    def lr(self, processed: int) -> float:
        return lr_at(processed, self.base, self.steps, self.scales) / self.batch


def make_pool(ctx, device) -> list[dict]:
    """The mix's distinct host batches, in the layout and dtype the CLI
    ships: images (1, b, S, S, 3), for the meta step one support image and
    box mask a class, targets and keep weights as numpy arrays."""
    tr, cfg = ctx.traffic, ctx.config
    rng = np.random.default_rng(ctx.seed)
    gen = torch_generator(ctx.seed, device)
    b, size = tr["batch"], tr["size"]
    dtype = getattr(torch, ctx.config["train_dtype"])
    noise = tuple(tr["background_noise"])

    def host(t):
        return t.to(dtype)[None].cpu()

    pool = []
    for _ in range(tr["pool"]):
        if cfg["model"] == "meta":
            n = cfg["train_classes"]
            scenes = layouts(rng, b, n, tr["max_objects"], lambda i: i % n, noise)
            sup = layouts(rng, n, n, 1, lambda i: i, noise)
            labels = binned_labels(scenes, n)
            keep = neg_keep(labels.reshape(b * n, -1), cfg["neg_ratio"], rng)
            pool.append({"x": host(paint(scenes, size, size, gen, device)),
                         "metax": host(paint(sup, size, size, gen, device)),
                         "mask": host(box_mask(sup, size, device)),
                         "target": labels[None], "keep": keep[None]})
        else:
            scenes = layouts(rng, b, cfg["classes"], tr["max_objects"], noise=noise)
            labels = plain_labels(scenes)
            keep = neg_keep(labels, cfg["neg_ratio"], rng)
            pool.append({"x": host(paint(scenes, size, size, gen, device)),
                         "target": labels[None], "keep": keep[None]})
    return pool


def port_tree(nets: dict, weights: dict, model: str):
    """The program's parameter tree (a list a net, OIHW channels-last conv
    weights, batch norm under "bn"), copied from the benchmark's weights."""
    def net(name):
        out = [None] * len(nets[name])
        for i, p in weights[name].items():
            q = {"w": p["w"].clone().contiguous(memory_format=torch.channels_last)}
            if "b" in p:
                q["b"] = p["b"].clone()
            if "gamma" in p:
                q["bn"] = {k: p[k].clone() for k in ("gamma", "beta", "mean", "var")}
            out[i] = q
        return out
    return {k: net(k) for k in nets} if model == "meta" else net("darknet")


def port_leaves(tree, model: str) -> dict:
    """{"net.index.key": tensor} of the program's tree."""
    out = {}
    for name, net in (tree.items() if model == "meta" else [("darknet", tree)]):
        for i, p in enumerate(net):
            for k, v in (p or {}).items():
                if k == "bn":
                    out.update({f"{name}.{i}.{s}": t for s, t in v.items()})
                else:
                    out[f"{name}.{i}.{k}"] = v
    return out


def ref_leaves(weights: dict) -> dict:
    return {f"{n}.{i}.{k}": t for n, net in weights.items() for i, p in net.items()
            for k, t in p.items()}


def is_state(name: str) -> bool:
    return name.endswith((".mean", ".var"))


def decay_of(name: str, cfg: dict, decay: float) -> float:
    if cfg["decay_bn_and_bias"] or not name.endswith((".gamma", ".beta", ".b")):
        return decay
    return 0.0


def change_norms(p0: dict, now: dict) -> dict:
    """Each weight leaf's change since p0, by its norm."""
    return compare.leaf_norms({k: now[k] - v for k, v in p0.items() if not is_state(k)})


def readings_of(losses, p0, m1, deltas, p3, sched, cfg) -> dict:
    """The norms a checked run gives: each step's loss, the first gradient
    leaf by leaf (m1 - wd * p0), each leaf's change after each checked step
    (`deltas`; the last is `delta`), the running statistics' change."""
    weights = {k: v for k, v in p0.items() if not is_state(k)}
    grad = {k: m1[k] - decay_of(k, cfg, sched.decay) * p0[k] for k in weights}
    return {"loss": losses, "grad": compare.leaf_norms(grad), "deltas": deltas,
            "delta": deltas[-1],
            "state": compare.leaf_norms({k: p3[k] - p0[k] for k in p0 if is_state(k)})}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers a training cell can compare, from two readings: the
    first step's loss and the worst step's, and the worst and the median
    leaf of the first gradient, of the change after the checked steps
    (over the leaves the reference's gradient moves) and of the running
    statistics' change; then, step by step, the loss's gap and the worst
    and median leaf's change (`loss_gap.k`, `delta_gap.k`,
    `delta_median_gap.k`), to show how the gaps grow. The cell's limits
    name the ones it compares."""
    moved = compare.moved_leaves(ref["grad"])
    gaps = [compare.rel_gap(a, b) for a, b in zip(prog["loss"], ref["loss"])]
    out = {
        "loss1_gap": gaps[0], "loss_gap": max(gaps),
        "grad_gap": compare.worst_leaf_gap(prog["grad"], ref["grad"])[0],
        "grad_median_gap": compare.median_leaf_gap(prog["grad"], ref["grad"]),
        "delta_gap": compare.worst_leaf_gap(prog["delta"], ref["delta"], moved)[0],
        "delta_median_gap": compare.median_leaf_gap(prog["delta"], ref["delta"], moved),
        "bn_state_gap": compare.worst_leaf_gap(prog["state"], ref["state"])[0],
        "bn_state_median_gap": compare.median_leaf_gap(prog["state"], ref["state"]),
    }
    for k, (a, b) in enumerate(zip(prog["deltas"], ref["deltas"]), 1):
        out[f"loss_gap.{k}"] = gaps[k - 1]
        out[f"delta_gap.{k}"] = compare.worst_leaf_gap(a, b, moved)[0]
        out[f"delta_median_gap.{k}"] = compare.median_leaf_gap(a, b, moved)
    return out


def reference_steps(ctx, nets, pool, sched, device, precision="fp32", half=False) -> dict:
    """The plain reference's checked steps from the seed's weights on the
    same pool batches, in the configuration's `train_dtype` (TF32 off; the
    convolutions' operands rounded to `precision` for the control). `half`
    plants a fault: half of each batch left out and the loss taken as the
    mean over the rest, times the batch."""
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
    mom = {k: torch.zeros_like(t) for k, t in p.items() if not is_state(k)}
    reg = region(nets["darknet"])
    processed = tr["start_batches"]
    seen = processed * tr["batch"]
    losses, m1, deltas = [], None, []
    for step in range(tr["checked_steps"]):
        batch = pool[step]
        lr = sched.lr(processed)
        processed += 1
        seen += tr["batch"]
        x = batch["x"][0].to(device, dtype)
        target = torch.as_tensor(batch["target"][0], device=device)
        keep = torch.as_tensor(batch["keep"][0], device=device)
        b = x.shape[0]
        keep_b = b // 2 if half else b
        if cfg["model"] == "meta":
            n = cfg["train_classes"]
            out = ref_net.meta_forward(nets["darknet"], nets["learnet"], w, x[:keep_b],
                                       batch["metax"][0].to(device, dtype),
                                       batch["mask"][0].to(device, dtype),
                                       train=True, precision=precision,
                                       recompute=tr["remat"])
            loss = region_loss_v2(out, target[:keep_b], keep[:keep_b * n], seen, reg, n)
        else:
            out = ref_net.forward(nets["darknet"], w["darknet"], x[:keep_b], train=True,
                                  precision=precision, recompute=tr["remat"])
            loss = region_loss(out, target[:keep_b], keep[:keep_b], seen, reg)
        loss = loss * (b / keep_b)
        names = [k for k in p if not is_state(k)]
        grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = torch.zeros_like(p[k]) if g is None else g
                d = g + decay_of(k, cfg, sched.decay) * p[k]
                mom[k].mul_(sched.momentum).add_(d)
                p[k].sub_(lr * mom[k])
        losses.append(float(loss.detach()))
        deltas.append(change_norms(p0, p))
        if step == 0:
            m1 = {k: v.clone() for k, v in mom.items()}
    p3 = {k: t.detach() for k, t in p.items()}
    return readings_of(losses, p0, m1, deltas, p3, sched, cfg)


class Program:
    """The program's side of a training cell: one trainer for the cell's
    configuration; `start(seed)` gives it the seed's weights, momentum and
    pool, `step()` is the loop's one call and feed, as the CLI makes it."""

    def __init__(self, ctx):
        from fewshot_detection_tpu_torch.config import parse_cfg
        from fewshot_detection_tpu_torch.eval.valid import set_float32_precision
        from fewshot_detection_tpu_torch.models.meta import MetaSpec
        from fewshot_detection_tpu_torch.models.spec import build_spec
        from fewshot_detection_tpu_torch.train import MetaTrainer, PlainTrainer
        from fewshot_detection_tpu_torch.utils import format_loss_line

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.format_loss_line = ctx, format_loss_line
        set_float32_precision(tf32=False)  # as the training CLIs set it
        self.nets = nets_of(ctx)
        self.sched = Schedule(parse(ctx.path(cfg["darknet_cfg"]))[0], tr["batch"],
                              cfg["lr_factor"])
        self.dtype = getattr(torch, cfg["train_dtype"])
        blocks = parse_cfg(ctx.path(cfg["darknet_cfg"]))
        if cfg["model"] == "meta":
            spec = MetaSpec(build_spec(blocks),
                            build_spec(parse_cfg(ctx.path(cfg["learnet_cfg"]))))
            self.trainer = MetaTrainer(spec, momentum=self.sched.momentum,
                                       weight_decay=self.sched.decay,
                                       metain_type=cfg["metain_type"], remat=tr["remat"],
                                       image_dtype=self.dtype, device=ctx.device)
        else:
            self.trainer = PlainTrainer(build_spec(blocks), momentum=self.sched.momentum,
                                        weight_decay=self.sched.decay,
                                        zero_tcls=cfg["zero_tcls"], remat=tr["remat"],
                                        image_dtype=self.dtype, device=ctx.device)

    def start(self) -> None:
        from fewshot_detection_tpu_torch.models.convert import require_grads
        from fewshot_detection_tpu_torch.train import init_momentum

        ctx, tr = self.ctx, self.ctx.traffic
        self.params = require_grads(port_tree(self.nets, seeded_weights(self.nets, ctx.seed,
                                                                        ctx.device),
                                              ctx.config["model"]))
        self.mom = init_momentum(self.params)
        self.pool = make_pool(ctx, ctx.device)
        self.i, self.processed = 0, tr["start_batches"]
        self.seen = tr["start_batches"] * tr["batch"]

    def step(self) -> dict:
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        lr = self.sched.lr(self.processed)
        self.processed += 1
        self.seen += self.ctx.traffic["batch"]
        self.params, self.mom, metrics = self.trainer.step(self.params, self.mom, batch,
                                                           seen=self.seen, lr=lr)
        self.format_loss_line(self.seen, metrics)  # the CLI's one host sync a step
        return metrics

    def checked(self) -> dict:
        """The checked steps from the start, and their readings."""
        model = self.ctx.config["model"]
        leaves = port_leaves(self.params, model)
        p0 = {k: t.detach().clone() for k, t in leaves.items()}
        losses, m1, deltas = [], None, []
        for s in range(self.ctx.traffic["checked_steps"]):
            losses.append(float(self.step()["loss"]))
            leaves = port_leaves(self.params, model)
            deltas.append(change_norms(p0, {k: t.detach() for k, t in leaves.items()}))
            if s == 0:
                m1 = {k: v.detach().clone() for k, v in port_leaves(self.mom, model).items()
                      if not is_state(k)}
        p3 = {k: t.detach() for k, t in leaves.items()}
        return readings_of(losses, p0, m1, deltas, p3, self.sched, self.ctx.config)

    def free(self) -> None:
        del self.params, self.mom
        self.ctx.free()


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    prog = Program(ctx)
    prog.start()
    ctx.log("program set up")
    readings = prog.checked()
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

    nets = prog.nets
    rec = {"kind": "train", "untraced_s": window_s, "steps": steps}
    if cfg["model"] == "meta":
        rec["step_flops"] = meta_step_flops(nets["darknet"], nets["learnet"], tr["batch"],
                                            cfg["train_classes"])
        shapes = (bn_layers(nets["darknet"], tr["batch"])
                  + bn_layers(nets["learnet"], cfg["train_classes"]))
    else:
        rec["step_flops"] = net_flops(nets["darknet"], tr["batch"])
        shapes = bn_layers(nets["darknet"], tr["batch"])
    rec["bn_bytes_per_step"] = bn_sums_bytes(shapes, prog.dtype.itemsize)
    if ctx.trace:
        n = tr["profiled_steps"]
        trace = rec["trace"] = profile_stretch(lambda: [prog.step() for _ in range(n)],
                                               ctx.cuda, n)
        ctx.log(f"untraced: {1e3 * window_s / steps:.2f} ms a step")
        for what, t in (("device activity alone", trace), ("with host operators", trace.named)):
            if t is not None and t.device:
                ctx.log(f"profiled, {what}: {1e3 * t.host_s / n:.2f} ms a step on the host, "
                        f"device busy {1e3 * t.busy_s / n:.2f} ms a step, idle {t.idle_pct():.2f}%")
        if trace.device:
            ctx.log("idle implied by the untraced steps: "
                    f"{100 * (1 - trace.busy_s / n / (window_s / steps)):.2f}%")
    memory = ctx.memory_peak()
    pool = prog.pool
    prog.free()

    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ref = reference_steps(ctx, nets, pool, prog.sched, ctx.device)
    ctx.log(f"reference done, its peak device memory {ctx.memory_peak()} bytes")
    return {
        "e2e": {"train_img_s": steps * tr["batch"] / window_s, "setup_s": setup_s},
        "attempted": steps, "failed": 0, "memory": memory, "record": rec,
        "readings": numbers(readings, ref),
    }
