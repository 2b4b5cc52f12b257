"""The plain reference against the program at a tiny size on the CPU: in
float32, where the two must agree to rounding, and in bfloat16, where the
reference rounds where the program does and the control does not."""

import os

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.common.cfgparse import parse, region, walk
from benchmark.reference import region_loss as ref_loss


def context(root, cell, seed=5, **config):
    _, c, cfg, tr = run.load_cell(root, cell)
    return run.Context(root, c, dict(cfg, **config), tr, seed, 1.0, False, "cpu", 0.0)


@pytest.mark.parametrize("cell", ["meta_voc15.train_b64", "yolov2_voc.train_b64"])
def test_train_steps_meet_the_reference_in_float32(tiny_root, cell):
    from benchmark.drivers import train

    ctx = context(tiny_root, cell, train_dtype="float32")
    prog = train.Program(ctx)
    prog.start()
    got = prog.checked()
    ref = train.reference_steps(ctx, prog.nets, prog.pool, prog.sched, ctx.device)
    numbers = train.numbers(got, ref)
    assert max(numbers.values()) < 1e-5, numbers


@pytest.mark.parametrize("cell", ["meta_voc15.train_b64", "yolov2_voc.train_b64"])
def test_bfloat16_steps_meet_the_reference_closer_than_the_control(tiny_root, cell):
    from benchmark.drivers import train

    ctx = context(tiny_root, cell)
    assert ctx.config["train_dtype"] == "bfloat16"
    prog = train.Program(ctx)
    prog.start()
    got = prog.checked()
    ref = train.reference_steps(ctx, prog.nets, prog.pool, prog.sched, ctx.device)
    low = train.reference_steps(ctx, prog.nets, prog.pool, prog.sched, ctx.device, "int8")
    ours, control = train.numbers(got, ref), train.numbers(low, ref)
    print(ours, control)
    for name in ("loss1_gap", "grad_gap", "delta_gap"):
        assert ours[name] < control[name], (name, ours, control)


@pytest.mark.parametrize("meta", [True, False])
def test_region_losses_meet_the_programs(tiny_root, meta):
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models.spec import build_spec
    from fewshot_detection_tpu_torch.ops import region_loss as prog_loss

    from benchmark.common.painting import binned_labels, layouts, neg_keep, plain_labels

    name = "darknet.cfg" if meta else "plain.cfg"
    path = os.path.join(tiny_root, "benchmark", "configs", "cfg", name)
    reg = region(walk(parse(path)))
    spec_region = build_spec(parse_cfg(path)).region
    rng = np.random.default_rng(3)
    g = torch.Generator().manual_seed(3)
    b, n_cls, side = 6, 4, 8
    for seen in (640, 64000):  # inside and past the coordinate warm-up
        if meta:
            scenes = layouts(rng, b, n_cls, 3, lambda i: i % n_cls)
            target = torch.from_numpy(binned_labels(scenes, n_cls))
            keep = torch.from_numpy(neg_keep(target.numpy().reshape(b * n_cls, -1), 1, rng))
            out = torch.randn((b * n_cls, side, side, 30), generator=g)
            want, _ = prog_loss.region_loss_v2(out, target, keep, seen, spec_region, n_cls)
            got = ref_loss.region_loss_v2(out, target, keep, seen, reg, n_cls)
        else:
            scenes = layouts(rng, b, 3, 3)
            target = torch.from_numpy(plain_labels(scenes))
            keep = torch.ones(b)
            out = torch.randn((b, side, side, 40), generator=g)
            want, _ = prog_loss.region_loss(out, target, keep, seen, spec_region)
            got = ref_loss.region_loss(out, target, keep, seen, reg)
        assert float(got) == pytest.approx(float(want), rel=1e-5)
