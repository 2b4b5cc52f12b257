#!/usr/bin/env python3
"""Host input-pipeline throughput of the PyTorch port: PIL vs native vs
threaded vs worker processes, and with --train real train steps on the
card with the data in the loop.

The counterpart of scripts/bench_input_pipeline.py, with the same argv
(and --device, default cuda, where --train's steps run; without a card
it is refused unless cpu) and the same JSON keys. The
synthetic VOC tree is painted by the port's own data/synth.py (PNG files,
no PIL). Modes (detection images; episodic adds n_cls support images per
batch through the same path):

  pil            sequential PIL decode+augment (FSD_NATIVE unset). On a
                 host without PIL the key is null and `pil_error` says
                 why; every other mode still runs
  native         sequential C++ (FSD_NATIVE=1); a native library that
                 cannot be built raises
  native-batch   C++ pthread batch API, one call per batch (FSD_NATIVE_BATCH=1)
  mp-N-episodic  N loader worker processes (data/mploader.py:MPLoader,
                 spawned; they build numpy arrays and never touch CUDA)

The JAX script runs its worker modes and --train with FSD_NATIVE unset
(on PIL). Here they run with the caller's FSD_NATIVE and FSD_NATIVE_BATCH,
put back after the native modes, so that they also run on a host without
PIL: with neither set, as in the JAX script, they decode with PIL.

--train runs the port's MetaTrainer (flagship cfgs, seeded parameters, 15-way,
FSD_DTYPE as the JAX script reads it) on `--device`, its
batches made by cli/train_meta_cli.py:make_episode_batch from a
data/loader.py:prefetch thread: 3 warm-up steps, then --train-batches
timed ones.

Usage:
  python scripts/bench_input_pipeline_torch.py [--images N] [--batch B]
      [--size S] [--workers N] [--train] [--train-batches N] [--root DIR]
      [--device DEVICE]
"""

import argparse
import itertools
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DARKNET_CFG = os.path.join(REPO, "cfg/darknet_dynamic.cfg")
LEARNET_CFG = os.path.join(REPO, "cfg/reweighting_net.cfg")
NATIVE_VARS = ("FSD_NATIVE", "FSD_NATIVE_BATCH")
TRAIN_WARMUP = 3


def build_dataset(d, settings, lines, seed=3):
    import random

    from fewshot_detection_tpu_torch.data.datasets import DetectionDataset

    return DetectionDataset(list(lines), settings, train=True, seen=0,
                            shuffle=False, rng=random.Random(seed),
                            filter_valid=False)


def drain(batches, limit=None):
    n = 0
    t0 = time.perf_counter()
    for imgs, _labels in batches:
        n += imgs.shape[0]
        if limit and n >= limit:
            break
    return n / (time.perf_counter() - t0)


def set_native(native: str | None, batch: str | None) -> None:
    for name, value in zip(NATIVE_VARS, (native, batch)):
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=256, help="source image size")
    ap.add_argument("--workers", type=int, default=max(os.cpu_count(), 2))
    ap.add_argument("--train", action="store_true",
                    help="also run REAL episodic train steps on --device with "
                    "data in the loop")
    ap.add_argument("--train-batches", type=int, default=30)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device of --train's steps (default cuda; refused "
                    "without a card unless cpu)")
    args = ap.parse_args(argv)

    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.utils.card import card_line

    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    if args.root:
        return run(args, args.root, dev)
    with tempfile.TemporaryDirectory(prefix="fsd_inbench_") as root:
        return run(args, root, dev)


def run(args, root, dev):
    from fewshot_detection_tpu_torch.config import Settings, parse_cfg, read_data_cfg
    from fewshot_detection_tpu_torch.data.mploader import MPLoader, episode_stream
    from fewshot_detection_tpu_torch.data.synth import make_voc_like

    d = make_voc_like(os.path.join(root, "voc"), n_images=args.images,
                      size=(args.size, args.size), seed=3, style="shape")
    datacfg = os.path.join(root, "m.data")
    with open(datacfg, "w") as f:
        f.write(
            f"metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\nscale=0\n"
            f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
            f"meta={d['traindict']}\ntrain={d['train_list']}\n"
            f"backup={root}/backup\ngpus=0\n"
        )
    data_options = read_data_cfg(datacfg)
    settings = Settings.configure(data_options, parse_cfg(DARKNET_CFG)[0], None)
    lines = open(d["train_list"]).read().split()

    results = {}
    caller = tuple(os.environ.get(n) for n in NATIVE_VARS)
    try:
        set_native(None, None)
        try:
            results["pil"] = round(drain(
                build_dataset(d, settings, lines).batches(args.batch)), 1)
        except ImportError as e:  # no PIL on this host
            results["pil"] = None
            results["pil_error"] = f"{type(e).__name__}: {e}"
        set_native("1", None)
        results["native"] = round(drain(
            build_dataset(d, settings, lines).batches(args.batch)), 1)
        set_native("1", "1")
        results["native-batch"] = round(drain(
            build_dataset(d, settings, lines).batches(args.batch)), 1)
    finally:
        set_native(*caller)

    for w in sorted({1, 2, args.workers}):
        loader = MPLoader(
            episode_stream,
            (lines, data_options["meta"], settings, args.batch, 0),
            num_workers=w, seed=3,
        )
        # episodes carry n_cls extra support images each; count both
        n = 0
        t0 = time.perf_counter()
        for imgs, _l, metax, _m in loader:
            n += imgs.shape[0] + metax.shape[0]
        dt = time.perf_counter() - t0
        loader.close()
        results[f"mp-{w}-episodic"] = round(n / dt, 1)

    if args.train:
        results["trained"] = round(bench_trained(
            d, data_options, settings, lines, args.batch,
            args.train_batches, dev), 1)

    results["host_cores"] = os.cpu_count()
    line = {"metric": "input_pipeline_images_per_sec", **results}
    print(json.dumps(line), flush=True)
    return line


def bench_trained(d, data_options, settings, lines, batch_size, n_batches, dev):
    """Real episodic train steps on `dev` with REAL decode+augment in the
    loop."""
    import random

    import numpy as np
    import torch

    from fewshot_detection_tpu_torch.cli.train_meta_cli import make_episode_batch
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.data.datasets import MetaDataset
    from fewshot_detection_tpu_torch.data.loader import prefetch
    from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
    from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
    from fewshot_detection_tpu_torch.models.spec import build_spec
    from fewshot_detection_tpu_torch.train import MetaTrainer, init_momentum

    spec = MetaSpec(build_spec(parse_cfg(DARKNET_CFG)), build_spec(parse_cfg(LEARNET_CFG)))
    init = init_meta_params(spec, 0)
    params = require_grads({k: from_jax_params(getattr(spec, k), init[k], dev)
                            for k in ("darknet", "learnet")})
    trainer = MetaTrainer(spec, momentum=0.9, weight_decay=0.0005, device=dev)
    mom = init_momentum(params)
    nprng = np.random.RandomState(0)
    dtype = os.environ.get("FSD_DTYPE", "float32")

    def episodes():
        rng = random.Random(5)
        while True:
            ds = build_dataset(d, settings, lines, seed=rng.randrange(2**31))
            metaset = MetaDataset(data_options["meta"], settings, train=True,
                                  num_replicas=1, rng=rng)
            meta_iter = metaset.batches(len(metaset.classes))
            for imgs, labels in ds.batches(batch_size):
                metax, mask = next(meta_iter)
                yield imgs, labels, metax, mask

    def fence(metrics):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        float(metrics["loss"])

    # the stream ends with the last batch taken, and the loader's thread with it
    it = prefetch(itertools.islice(episodes(), TRAIN_WARMUP + n_batches))
    p, m = params, mom
    metrics = None
    for i in range(TRAIN_WARMUP):
        imgs, labels, metax, mask = next(it)
        batch = make_episode_batch(imgs, labels, metax, mask, 1, 1, nprng, dtype=dtype)
        p, m, metrics = trainer.step(p, m, batch, seen=20000 + i, lr=1e-5)
    fence(metrics)

    t0 = time.perf_counter()
    for i in range(n_batches):
        imgs, labels, metax, mask = next(it)
        batch = make_episode_batch(imgs, labels, metax, mask, 1, 1, nprng, dtype=dtype)
        p, m, metrics = trainer.step(p, m, batch, seen=30000 + i, lr=1e-5)
    fence(metrics)
    return batch_size * n_batches / (time.perf_counter() - t0)


if __name__ == "__main__":
    main()
