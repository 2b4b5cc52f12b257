"""Episodic meta training loop (train_meta.py CLI contract).

Usage: python train_meta_torch.py datacfg darknetcfg learnetcfg weightfile

Reproduces the reference script's control flow (train_meta.py:28-326):
schedule state restored from the .weights `seen` counter, per-epoch list
dataset + support stream, step-LR warmup schedule adjusted per batch, LR /
batch_size and weight_decay * batch_size * factor scaling, periodic
.weights checkpoints. The per-step compute (forward, loss, SGD, BN merge)
is `train.trainer.MetaTrainer.step`: on one device, or under `torchrun
--nproc_per_node=N` on N devices, one replica group a rank by default
(parallel/mesh.py; the same step as N groups on one device).

Environment switches honoured: FSD_DTYPE, FSD_INPUT_U8, FSD_CLIP_NORM,
FSD_OVERLAP_METRICS, FSD_BN_DARKNET, FSD_WARMUP_SEEN, FSD_NOAUG,
FSD_RAM_CACHE / FSD_RAM_CACHE_MB, FSD_PATH_MAP, FSD_NATIVE /
FSD_NATIVE_BATCH (the C++ image loader, native/), FSD_WORKERS (loader worker
processes, data/mploader.py), FSD_ORBAX_DIR / FSD_ASYNC_CKPT (full-state
checkpoints and resume, train/checkpoint.py) and FSD_PROFILE_DIR (a
torch.profiler trace of each epoch, utils/profiling.py). Each epoch ends
with the StepTimer line (data / step / sync phases and images/s). A device list
in one process raises NotImplementedError: N devices are N processes.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
import time

import numpy as np
import torch

from ..data import MetaDataset, build_dataset
from ..data.datasets import DetectionDataset
from ..data.loader import prefetch
from ..data.mploader import MPLoader, episode_stream
from ..eval.valid import set_float32_precision
from ..models import weights_io
from ..models.convert import from_jax_params, require_grads, to_jax_params
from ..models.meta import MetaSpec, init_meta_params
from ..models.spec import build_spec
from ..ops.region_loss import sample_neg_keep
from ..parallel.mesh import launched_by_torchrun, make_mesh, replicate, shard_batch
from ..train import MetaTrainer, init_momentum, lr_schedule, neg_ratio_lr_factor
from ..train.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
    wait_for_saves,
)
from ..utils import format_loss_line, log
from ..utils.card import resolve_device
from ..utils.profiling import StepTimer, trace
from .common import ensure_backup_dir, replica_layout, resolve_configs

def refuse_device_list(device=None) -> None:
    """Raise NotImplementedError when one process is asked to train on more
    than one device, rather than ignore the request: each device is a
    process of its own, one rank of a world that torchrun starts."""
    if isinstance(device, (list, tuple)) and len(device) > 1:
        raise NotImplementedError(
            "training on more than one device from one process: start one process a "
            "device with torchrun --nproc_per_node=N (parallel/mesh.py)"
        )


def join_world(device):
    """(mesh, device): the data-parallel world when this process is one rank
    of one (torchrun's environment, or a process group already joined), and
    the device this rank computes on; (None, device) for a process alone."""
    refuse_device_list(device)
    if not launched_by_torchrun():
        return None, resolve_device(device)
    mesh = make_mesh(device=device)
    return mesh, mesh.device


def agreed(mesh, value):
    """`value` as rank 0 has it (a seed drawn from the clock: every rank must
    draw the same episodes)."""
    return value if mesh is None else mesh.broadcast_object(value)


def compute_dtype() -> str:
    """Training compute dtype name: FSD_DTYPE=bfloat16 casts image inputs
    (BN statistics and loss math stay float32 regardless — ops/layers.py)."""
    return os.environ.get("FSD_DTYPE", "float32")


def _image_host_dtype(dtype: str):
    """FSD_INPUT_U8=1 ships image tensors as uint8 and rescales on device
    (trainer._decode_images): a quarter of the float32 bytes over the bus,
    with no precision loss relative to the bf16 compute cast."""
    if os.environ.get("FSD_INPUT_U8", "0") == "1":
        return torch.uint8, lambda a: np.round(
            np.asarray(a, np.float32) * 255.0
        ).astype(np.uint8)
    return getattr(torch, dtype), lambda a: a


def make_episode_batch(imgs, labels, metax, mask, n_groups, neg_ratio, rng,
                       dtype: str = "float32"):
    """Stack host arrays into the trainer's (R, ...) layout. Image tensors
    come back as host tensors in the dtype they are shipped in."""
    tdt, enc = _image_host_dtype(dtype)
    B = imgs.shape[0]
    n_cls = labels.shape[1]
    b = B // n_groups
    keep = sample_neg_keep(labels.reshape(B * n_cls, -1), neg_ratio, rng)

    def ship(a, lead):
        a = np.ascontiguousarray(enc(a.reshape(n_groups, lead, *a.shape[1:])))
        return torch.from_numpy(a).to(tdt)

    return {
        "x": ship(imgs, b),
        "metax": ship(metax, n_cls),
        "mask": ship(mask, n_cls),
        "target": labels.reshape(n_groups, b, n_cls, 50, 5),
        "keep": keep.reshape(n_groups, b * n_cls),
    }


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What the [net] block and the neg-sampling ratio fix for a run."""

    batch_size: int
    max_batches: int
    learning_rate: float  # already divided by `factor`
    momentum: float
    weight_decay: float  # decay * batch_size * factor
    steps: tuple[float, ...]
    scales: tuple[float, ...]
    factor: float

    def lr(self, processed_batches: int) -> float:
        """The learning rate the optimizer gets for this batch (train_meta.py
        hands SGD lr / batch_size)."""
        return lr_schedule(
            processed_batches, self.learning_rate, self.steps, self.scales
        ) / self.batch_size


def schedule_from_cfg(net_options: dict, neg_ratio, n_meta_classes: int) -> Schedule:
    """train_meta.py:107-147: LR / factor, weight_decay * batch * factor,
    with the factor keyed to the neg sampling ratio."""
    batch_size = int(net_options["batch"])
    factor = neg_ratio_lr_factor(neg_ratio, n_meta_classes)
    return Schedule(
        batch_size=batch_size,
        max_batches=int(net_options["max_batches"]),
        learning_rate=float(net_options["learning_rate"]) / factor,
        momentum=float(net_options["momentum"]),
        weight_decay=float(net_options["decay"]) * batch_size * factor,
        steps=tuple(float(s) for s in net_options["steps"].split(",")),
        scales=tuple(float(s) for s in net_options["scales"].split(",")),
        factor=factor,
    )


def main(datacfg, darknetcfg_path, learnetcfg_path, weightfile, device="cuda",
         n_groups: int | None = None):
    mesh, device = join_world(device)
    chief = mesh is None or mesh.is_chief  # the one rank that logs and writes
    say = log if chief else (lambda msg: None)
    # float32 training is full float32: no TF32 in convolutions or products
    set_float32_precision(tf32=False)
    data_options, darknetcfg, learnetcfg, settings = resolve_configs(
        datacfg, darknetcfg_path, learnetcfg_path
    )
    backupdir = ensure_backup_dir(settings)
    say("logging to " + backupdir)

    spec = MetaSpec(build_spec(darknetcfg), build_spec(learnetcfg))
    params = init_meta_params(spec, agreed(mesh, int(time.time()) % (2**31)))
    (dp, lp), header = weights_io.load_weights(
        weightfile, [spec.darknet, spec.learnet],
        [params["darknet"], params["learnet"]],
    )
    seen = header.seen

    trainlist = build_dataset(data_options, settings)
    nsamples = len(trainlist)

    # LR factor keyed to neg sampling (train_meta.py:123-135)
    probe_meta = MetaDataset(
        data_options["meta"], settings, train=True, num_replicas=1,
        rng=random.Random(0),
    )
    sched = schedule_from_cfg(darknetcfg[0], settings.neg_ratio, len(probe_meta.classes))
    batch_size, max_batches = sched.batch_size, sched.max_batches
    processed_batches = 0 if settings.tuning else seen // batch_size
    init_epoch = 0 if settings.tuning else seen // max(nsamples, 1)
    max_epochs = max_batches * batch_size // max(nsamples, 1) + 1
    if settings.tuning:
        max_epochs = int(math.ceil(settings.max_epoch * 1.0 / settings.repeat))
    say(f"{settings.repeat} {nsamples} {max_batches} {batch_size}")
    say(f"factor: {sched.factor}")

    n_groups, _ = replica_layout(batch_size, n_groups, mesh)
    trainer = MetaTrainer(
        spec, momentum=sched.momentum, weight_decay=sched.weight_decay,
        metain_type=settings.metain_type,
        # FSD_CLIP_NORM: opt-in global-norm gradient clipping — the
        # reference never trains from random init (always darknet19
        # pretrained), where the early conf loss can diverge plain SGD
        clip_norm=float(os.environ.get("FSD_CLIP_NORM", "0")),
        image_dtype=getattr(torch, compute_dtype()),
        warmup_seen=settings.warmup_seen,
        device=device,
        mesh=mesh,
    )
    params = require_grads({
        "darknet": from_jax_params(spec.darknet, dp, device),
        "learnet": from_jax_params(spec.learnet, lp, device),
    })
    mom = init_momentum(params)

    # Full-state resume (params + momentum + schedule counters) when a
    # checkpoint exists under FSD_ORBAX_DIR: richer than the .weights
    # seen-counter restore
    ckpt_dir = os.environ.get("FSD_ORBAX_DIR")
    if ckpt_dir:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            say(f"resuming train state from {latest}")
            state = restore_train_state(latest, {"params": params, "momentum": mom})
            params, mom = state["params"], state["momentum"]
            seen = state["counters"]["seen"]
            processed_batches = state["counters"]["processed_batches"]
            init_epoch = state["counters"]["step"]
    if mesh is not None:
        # every rank starts from rank 0's parameters and momentum
        replicate(mesh, (params, mom))

    rng = random.Random(agreed(mesh, int(time.time())))
    nprng = np.random.RandomState(rng.randrange(2**31))

    try:
        for epoch in range(init_epoch, max_epochs):
            timer = StepTimer()
            ds = DetectionDataset(
                trainlist, settings, train=True, seen=seen, shuffle=False,
                rng=rng, filter_valid=False,
            )
            metaset = MetaDataset(
                data_options["meta"], settings, train=True,
                num_replicas=n_groups, rng=rng,
            )
            meta_iter = metaset.batches(n_groups * len(metaset.classes))

            lr = lr_schedule(processed_batches, sched.learning_rate, sched.steps, sched.scales)
            say(
                f"epoch {epoch}/{max_epochs}, processed {epoch * nsamples} "
                f"samples, lr {lr:f}"
            )

            def episodes():
                # detection + support batches prepared together so the
                # background thread hides BOTH loads behind the device step
                for imgs, labels in ds.batches(batch_size):
                    metax, mask = next(meta_iter)
                    yield imgs, labels, metax, mask

            # FSD_WORKERS=N: N loader worker PROCESSES (the reference's torch
            # num_workers, train_meta.py:173-183) — the GIL-bound decode path
            # cannot scale on the prefetch thread alone
            n_workers = int(os.environ.get("FSD_WORKERS", "0"))
            mp_loader = None
            if n_workers > 0:
                mp_loader = MPLoader(
                    episode_stream,
                    (trainlist, data_options["meta"], settings, batch_size,
                     seen, n_groups),
                    num_workers=n_workers, seed=rng.randrange(2**31),
                )

            # FSD_OVERLAP_METRICS=1: fetch step i's loss scalars only AFTER
            # step i+1 is launched, so the blocking fetch overlaps the next
            # step's host work. Loss lines print one step late with their own
            # seen counter; checkpoint cadence and values are unchanged.
            overlap = os.environ.get("FSD_OVERLAP_METRICS", "0") == "1"
            pending = None

            def flush(p):
                with timer.phase("sync"):  # the one place a step waits, on every rank
                    line = format_loss_line(*p)
                if chief:
                    print(line)

            try:
                with trace(device=device):  # torch.profiler when FSD_PROFILE_DIR is set
                    it = iter(mp_loader) if mp_loader else prefetch(episodes())
                    while True:
                        with timer.phase("data"):
                            nxt = next(it, None)
                            if nxt is None:
                                break
                            imgs, labels, metax, mask = nxt
                        lr = sched.lr(processed_batches)
                        processed_batches += 1
                        with timer.phase("step"):
                            batch = make_episode_batch(
                                imgs, labels, metax, mask, n_groups,
                                settings.neg_ratio, nprng, dtype=compute_dtype(),
                            )
                            if mesh is not None:
                                # Every rank reads, decodes and augments the
                                # whole episode and keeps its own groups: the
                                # random draws (crops, flips, HSV, supports,
                                # negatives) are one stream all ranks walk in
                                # step. The host cost: N ranks decode N
                                # episodes where one would do (with
                                # FSD_WORKERS, N sets of loader processes).
                                batch = shard_batch(mesh, batch)
                            seen += imgs.shape[0]  # the global batch
                            params, mom, metrics = trainer.step(
                                params, mom, batch, seen=seen, lr=lr)
                        if overlap:
                            if pending is not None:
                                flush(pending)
                            pending = (seen, metrics)
                        else:
                            flush((seen, metrics))
                    if pending is not None:
                        flush(pending)
                        pending = None
            finally:
                # a failure mid-epoch must not leave FSD_WORKERS processes
                # decoding batches until interpreter exit
                if mp_loader is not None:
                    mp_loader.close()
            say(timer.summary(images=nsamples))

            if (epoch + 1) % settings.save_interval == 0:
                out = f"{backupdir}/{epoch + 1:06d}.weights"
                say("save weights to " + out)
                if chief:
                    weights_io.save_weights(
                        out, [spec.darknet, spec.learnet],
                        [to_jax_params(spec.darknet, params["darknet"]),
                         to_jax_params(spec.learnet, params["learnet"])],
                        seen=(epoch + 1) * nsamples,
                    )
                if ckpt_dir:
                    # the running `seen`, not the header's (epoch+1) *
                    # nsamples that the JAX package stores here too: a
                    # tuning run starts at the base checkpoint's seen, and
                    # the last batch of an epoch may be dropped, so that
                    # value would restart a resumed run elsewhere (inside
                    # the region loss's warm-up, for one)
                    save_train_state(
                        ckpt_dir, epoch + 1, params, mom,
                        seen=seen, processed_batches=processed_batches, mesh=mesh,
                    )
    finally:
        # commit an in-flight FSD_ASYNC_CKPT=1 background save also on an
        # exception or KeyboardInterrupt mid-training
        if ckpt_dir:
            wait_for_saves()
    return params
