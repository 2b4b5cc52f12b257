#!/usr/bin/env python3
"""Multiscale training on the card with the PyTorch port: the step at every
size of the schedule, peak memory, scale switches.

The reference resizes its training input every 64 samples once seen >=
256k (dataset.py:223-245 in the reference, {320..608 step 32}). This script
is the counterpart of scripts/multiscale_epoch.py, with the same argv (and a
--device, default cuda), prints and MSJSON line, on the flagship
MetaTrainer (cfg/darknet_dynamic.cfg + cfg/reweighting_net.cfg,
bfloat16 episodes, 15-way, batch 32 by default):

  phase A  per-bucket first step and the mean of 3 further steps, images/s
           and the peak device memory of that bucket alone (the counter is
           reset before each bucket; the JAX script reads a running peak).
           PyTorch keeps no compile cache (the JAX script's
           enable_compile_cache has no counterpart): on the card
           `first_step_s` is the first step at a new shape (cuDNN's choice
           of algorithms, the allocator's first blocks), not a compile
  phase B  a streaming "epoch" with `seen` pinned past the 256k threshold
           so every 64-sample block draws a random size from the full
           range — real decode+augment (DetectionDataset and MetaDataset on
           one random.Random(9), data/loader.py:prefetch, make_episode_batch),
           real scale switches, steady throughput measured across them

Usage: python scripts/multiscale_epoch_torch.py [--batch 32] [--batches 30]
       [--root DIR] [--skip-epoch] [--device DEVICE]
"""

import argparse
import itertools
import json
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_CLS = 15
SIZES = [320 + 32 * i for i in range(10)]
DARKNET_CFG = os.path.join(REPO, "cfg/darknet_dynamic.cfg")
LEARNET_CFG = os.path.join(REPO, "cfg/reweighting_net.cfg")
SEEN0 = 5 * 4000 * 64  # phase B: the full 320-608 range active


def epoch_data(root):
    """Phase B's synthetic VOC tree and its (train list, traindict, Settings)."""
    from fewshot_detection_tpu_torch.config import Settings, parse_cfg, read_data_cfg
    from fewshot_detection_tpu_torch.data.synth import make_voc_like

    d = make_voc_like(os.path.join(root, "voc"), n_images=192,
                      size=(256, 256), seed=5, style="shape")
    datacfg = os.path.join(root, "m.data")
    with open(datacfg, "w") as f:
        f.write(
            f"metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
            f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
            f"meta={d['traindict']}\ntrain={d['train_list']}\n"
            f"backup={root}/backup\ngpus=0\n"
        )
    settings = Settings.configure(read_data_cfg(datacfg), parse_cfg(DARKNET_CFG)[0], None)
    return d["train_list"], d["traindict"], settings


def episodes(train_list, traindict, settings, batch):
    """Phase B's endless stream of (imgs, labels, (metax, mask)): the
    datasets made anew each pass, all on one random.Random(9), so the sizes
    drawn every 64 samples follow the JAX script's order of draws."""
    from fewshot_detection_tpu_torch.data.datasets import DetectionDataset, MetaDataset

    prng = random.Random(9)
    while True:
        ds = DetectionDataset(
            open(train_list).read().split(), settings,
            train=True, seen=SEEN0, shuffle=False, rng=prng,
            filter_valid=False,
        )
        metaset = MetaDataset(traindict, settings, train=True,
                              num_replicas=1, rng=prng)
        meta_iter = metaset.batches(N_CLS)
        for imgs, labels in ds.batches(batch):
            yield imgs, labels, next(meta_iter)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--batches", type=int, default=30)
    ap.add_argument("--root", default=None)
    ap.add_argument("--skip-epoch", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the steps run on (default cuda)")
    args = ap.parse_args(argv)

    import tempfile

    import numpy as np
    import torch

    from fewshot_detection_tpu_torch.cli.train_meta_cli import make_episode_batch
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.data.loader import prefetch
    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
    from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
    from fewshot_detection_tpu_torch.models.spec import build_spec
    from fewshot_detection_tpu_torch.train import MetaTrainer, init_momentum

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(f"device: {dev.type} {kind}", flush=True)

    def sync(metrics):
        float(metrics["loss"])
        if on_card:
            torch.cuda.synchronize(dev)

    spec = MetaSpec(build_spec(parse_cfg(DARKNET_CFG)), build_spec(parse_cfg(LEARNET_CFG)))
    init = init_meta_params(spec, 0)
    params = require_grads({k: from_jax_params(getattr(spec, k), init[k], dev)
                            for k in ("darknet", "learnet")})
    trainer = MetaTrainer(spec, momentum=0.9, weight_decay=0.0005,
                          image_dtype=torch.bfloat16, device=dev)
    mom = init_momentum(params)
    rng = np.random.RandomState(0)
    m_side = spec.learnet.width

    def batch_for(size):
        target = np.zeros((1, args.batch, N_CLS, 50, 5), np.float32)
        for i in range(args.batch):
            target[0, i, i % N_CLS, 0] = [i % N_CLS, 0.5, 0.5, 0.3, 0.3]
        return {
            "x": torch.from_numpy(rng.rand(1, args.batch, size, size, 3)).to(torch.bfloat16),
            "metax": torch.from_numpy(rng.rand(1, N_CLS, m_side, m_side, 3)).to(torch.bfloat16),
            "mask": torch.from_numpy(rng.rand(1, N_CLS, m_side, m_side, 1) > 0.5).to(
                torch.bfloat16),
            "target": target,
            "keep": np.ones((1, args.batch * N_CLS), np.float32),
        }

    # ---- phase A: per-bucket first step + steady step + memory
    buckets = {}
    p, m = params, mom
    for size in SIZES:
        b = batch_for(size)
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        p, m, metrics = trainer.step(p, m, b, seen=300000, lr=1e-5)
        sync(metrics)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(3):
            p, m, metrics = trainer.step(p, m, b, seen=300001 + i, lr=1e-5)
        sync(metrics)
        cached = (time.perf_counter() - t0) / 3
        mem = round(torch.cuda.max_memory_allocated(dev) / 2**30, 2) if on_card else None
        buckets[size] = {
            "first_step_s": round(first, 1),
            "cached_step_ms": round(cached * 1000, 1),
            "img_per_s": round(args.batch / cached, 1),
            "peak_hbm_gib": mem,
        }
        print(f"bucket {size}: {buckets[size]}", flush=True)

    result = {"metric": "multiscale_hardware", "batch": args.batch,
              "buckets": buckets}

    # ---- phase B: streaming epoch across scale switches (real data)
    if not args.skip_epoch:
        root = args.root or tempfile.mkdtemp(prefix="fsd_ms_")
        train_list, traindict, settings = epoch_data(root)
        nprng = np.random.RandomState(1)
        # the stream ends with the last batch taken, so the loader's thread
        # ends with it
        it = prefetch(itertools.islice(
            episodes(train_list, traindict, settings, args.batch), args.batches))
        sizes_seen = []
        n_done = 0
        t0 = time.perf_counter()
        t_first = None
        for i in range(args.batches):
            imgs, labels, (metax, mask) = next(it)
            sizes_seen.append(imgs.shape[1])
            batch = make_episode_batch(imgs, labels, metax, mask, 1, 1,
                                       nprng, dtype="bfloat16")
            p, m, metrics = trainer.step(p, m, batch, seen=SEEN0 + i, lr=1e-5)
            if i == 0:
                sync(metrics)
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
            else:
                n_done += imgs.shape[0]
        sync(metrics)
        dt = time.perf_counter() - t0
        result["epoch"] = {
            "batches": args.batches,
            "sizes_crossed": sorted(set(sizes_seen)),
            "n_switches": sum(1 for a, b2 in zip(sizes_seen, sizes_seen[1:])
                              if a != b2),
            "first_batch_s": round(t_first, 1),
            "steady_img_per_s": round(n_done / dt, 1),
        }
        print(f"epoch: {result['epoch']}", flush=True)

    print("MSJSON " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
