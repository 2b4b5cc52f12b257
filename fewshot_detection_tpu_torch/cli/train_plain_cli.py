"""Baseline YOLOv2 training loop (train.py CLI contract).

Usage: python train_torch.py datacfg cfgfile weightfile

Reproduces the reference script's control flow (train.py:28-230): optional
yolo_joint few-shot list merge (train.py:94-103), step-LR schedule with the
optimizer handed lr / batch_size and weight_decay = decay * batch_size,
weight decay exempting BN affine and biases (train.py:132-138), .weights
checkpoints every `save_interval` epochs. The per-step compute is
`train.trainer.PlainTrainer.step`, on one device or, under `torchrun
--nproc_per_node=N`, on N (one replica group a rank by default; see
train_meta_cli).

Environment switches honoured: FSD_DTYPE, FSD_INPUT_U8, FSD_CLIP_NORM,
FSD_WORKERS (loader worker processes, data/mploader.py), and those of the
datasets (FSD_NOAUG, FSD_RAM_CACHE, FSD_NATIVE, FSD_NATIVE_BATCH, ...). As in the JAX package's plain loop there are no
full-state checkpoints and no trace here. A device list in one process
raises NotImplementedError, as in the meta CLI
(`train_meta_cli.refuse_device_list`).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from ..data.datasets import DetectionDataset
from ..data.lists import load_lines
from ..data.loader import prefetch
from ..data.mploader import MPLoader, detection_stream
from ..eval.valid import set_float32_precision
from ..models import weights_io
from ..models.convert import from_jax_params, require_grads, to_jax_params
from ..models.darknet import init_params
from ..models.spec import build_spec
from ..ops.region_loss import sample_neg_keep
from ..parallel.mesh import replicate, shard_batch
from ..train import PlainTrainer, init_momentum, lr_schedule
from ..utils import format_loss_line, log
from .common import ensure_backup_dir, replica_layout, resolve_configs
from .train_meta_cli import Schedule, _image_host_dtype, agreed, compute_dtype, join_world


def make_plain_batch(imgs, labels, n_groups, neg_ratio, rng, dtype: str = "float32"):
    """Stack host arrays into PlainTrainer's (R, ...) layout; the images
    come back as a host tensor in the dtype they are shipped in."""
    tdt, enc = _image_host_dtype(dtype)
    B = imgs.shape[0]
    b = B // n_groups
    keep = sample_neg_keep(labels.reshape(B, -1), neg_ratio, rng)
    x = np.ascontiguousarray(enc(imgs.reshape(n_groups, b, *imgs.shape[1:])))
    return {
        "x": torch.from_numpy(x).to(tdt),
        "target": labels.reshape(n_groups, b, 50, 5),
        "keep": keep.reshape(n_groups, b),
    }


def plain_schedule_from_cfg(net_options: dict) -> Schedule:
    """The [net] block's schedule as the plain loop uses it: the optimizer
    handed lr / batch_size and weight_decay = decay * batch_size (factor 1:
    the plain loop has no neg-sampling LR factor)."""
    batch_size = int(net_options["batch"])
    return Schedule(
        batch_size=batch_size,
        max_batches=int(net_options["max_batches"]),
        learning_rate=float(net_options["learning_rate"]),
        momentum=float(net_options["momentum"]),
        weight_decay=float(net_options["decay"]) * batch_size,
        steps=tuple(float(s) for s in net_options["steps"].split(",")),
        scales=tuple(float(s) for s in net_options["scales"].split(",")),
        factor=1.0,
    )


def main(datacfg, cfgfile, weightfile, device="cuda", n_groups: int | None = None):
    mesh, device = join_world(device)
    chief = mesh is None or mesh.is_chief  # the one rank that logs and writes
    say = log if chief else (lambda msg: None)
    # float32 training is full float32: no TF32 in convolutions or products
    set_float32_precision(tf32=False)
    data_options, blocks, _, settings = resolve_configs(datacfg, cfgfile)
    sched = plain_schedule_from_cfg(blocks[0])
    batch_size, max_batches = sched.batch_size, sched.max_batches

    backupdir = ensure_backup_dir(settings)
    say("logging to " + backupdir)

    spec = build_spec(blocks)
    params = init_params(spec, agreed(mesh, int(time.time()) % (2**31)))
    (params,), header = weights_io.load_weights(weightfile, [spec], [params])
    seen = header.seen

    trainlist = load_lines(data_options["train"], settings)
    if settings.yolo_joint:
        # merge the few-shot support lists into training (train.py:94-103)
        extra = load_lines(data_options["meta"], settings, checkvalid=False)
        factor = max(len(trainlist) // max(len(extra), 1) // 4, 1)
        trainlist = trainlist + extra * factor

    nsamples = len(trainlist)
    processed_batches = seen // batch_size
    init_epoch = seen // max(nsamples, 1)
    max_epochs = max_batches * batch_size // max(nsamples, 1) + 1

    n_groups, _ = replica_layout(batch_size, n_groups, mesh)
    trainer = PlainTrainer(
        spec, momentum=sched.momentum, weight_decay=sched.weight_decay,
        zero_tcls=settings.metayolo,
        clip_norm=float(os.environ.get("FSD_CLIP_NORM", "0")),
        image_dtype=getattr(torch, compute_dtype()),
        warmup_seen=settings.warmup_seen,
        device=device,
        mesh=mesh,
    )
    params = require_grads(from_jax_params(spec, params, device))
    mom = init_momentum(params)
    if mesh is not None:
        replicate(mesh, (params, mom))

    rng = random.Random(agreed(mesh, int(time.time())))
    nprng = np.random.RandomState(rng.randrange(2**31))

    for epoch in range(init_epoch, max_epochs):
        t0 = time.time()
        ds = DetectionDataset(
            trainlist, settings, train=True, seen=seen, shuffle=False,
            rng=rng, filter_valid=False,
        )
        lr = lr_schedule(processed_batches, sched.learning_rate, sched.steps, sched.scales)
        say(
            f"epoch {epoch}/{max_epochs}, processed {epoch * nsamples} "
            f"samples, lr {lr:f}"
        )
        # FSD_WORKERS=N: N loader worker processes (torch num_workers
        # analogue); default keeps the single prefetch thread
        n_workers = int(os.environ.get("FSD_WORKERS", "0"))
        loader = None
        if n_workers > 0:
            loader = MPLoader(
                detection_stream,
                (trainlist, settings, batch_size, seen),
                num_workers=n_workers, seed=rng.randrange(2**31),
            )
        try:
            for imgs, labels in (iter(loader) if loader
                                 else prefetch(ds.batches(batch_size))):
                lr = sched.lr(processed_batches)
                processed_batches += 1
                batch = make_plain_batch(imgs, labels, n_groups, settings.neg_ratio, nprng,
                                         dtype=compute_dtype())
                if mesh is not None:
                    # every rank decodes the whole batch and keeps its own
                    # groups (one random stream; N times one process's
                    # host decode, as in train_meta_cli)
                    batch = shard_batch(mesh, batch)
                seen += imgs.shape[0]  # the global batch
                params, mom, metrics = trainer.step(params, mom, batch, seen=seen, lr=lr)
                line = format_loss_line(seen, metrics)  # the one place a step waits
                if chief:
                    print(line)
        finally:
            # close worker processes on every exit path, not just the clean
            # epoch end (a failure otherwise leaks them until exit)
            if loader is not None:
                loader.close()
        say(
            "training with %f samples/s"
            % (nsamples / max(time.time() - t0, 1e-9))
        )
        if (epoch + 1) % settings.save_interval == 0 and chief:
            out = f"{backupdir}/{epoch + 1:06d}.weights"
            say("save weights to " + out)
            weights_io.save_weights(
                out, [spec], [to_jax_params(spec, params)], seen=(epoch + 1) * nsamples
            )
    return params
