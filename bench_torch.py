"""Benchmark of the PyTorch port on the card: the meta-YOLO episodic train
step (forward, backward, update), images/sec/chip.

The counterpart of bench.py: the same step (cfg/darknet_dynamic.cfg +
cfg/reweighting_net.cfg, 416 px, a 15-way support set, batch 384, bfloat16
inputs; what bench.py's remat keeps for the backward, the conv outputs and
BN batch statistics, is all that training BN keeps here), the same batch
drawn in the same order from np.random.RandomState(0), the same seeded parameters, 3 warm-up and 10
timed steps, the same fallback chain and the same last line. What differs:

  - the batch is converted to bfloat16 on the host and copied to the card
    once; it stays there, as `jnp.asarray` leaves it on the TPU;
  - the trainer updates parameters and momentum in place (the JAX bench
    donates its buffers instead);
  - the fence is `torch.cuda.synchronize()` and then `float(loss)`;
  - only `torch.cuda.OutOfMemoryError` falls back to the next batch; the
    references of the failed batch are dropped and the allocator's cache
    emptied first. Any other error propagates with its traceback.

Lines before the result: the card and its power limit, the peak device
memory at each batch tried, the bn_sums forward and backward launches of a
step, and the message of each OOM.

    python bench_torch.py [--device cuda]

`--device` defaults to cuda and raises without a card; `--device cpu` runs
the same code on the CPU (its kernels' plain versions), for tests only.
"""

import argparse
import gc
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The JAX bench's estimate of the PyTorch-0.3 reference's per-GPU rate
# (bench.py:29, BASELINE.md "Derived reference throughput",
# scripts/derive_baseline.py), kept here as the same constant.
REF_IMG_PER_SEC_PER_GPU = 30.0

BATCH = 384
N_CLS = 15
SIZE = 416
WARMUP = 3
ITERS = 10
FALLBACK = (128, 64, 16)  # after BATCH, on smaller-memory cards


def make_batch(batch_size: int, device, size=None, n_cls=None):
    """bench.py's batch: the same arrays from np.random.RandomState(0) in the
    same order (x, metax, mask, then target and keep), images and masks
    rounded to bfloat16 on the host, everything copied to `device` once.
    `size` and `n_cls` default to SIZE and N_CLS."""
    import torch

    size = SIZE if size is None else size
    n_cls = N_CLS if n_cls is None else n_cls
    rng = np.random.RandomState(0)
    R, b = 1, batch_size
    target = np.zeros((R, b, n_cls, 50, 5), np.float32)
    for i in range(b):
        c = i % n_cls
        target[0, i, c, 0] = [c, 0.5, 0.5, 0.3, 0.3]

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).to(device)

    return {
        "x": bf16(rng.rand(R, b, size, size, 3)),
        "metax": bf16(rng.rand(R, n_cls, size, size, 3)),
        "mask": bf16(rng.rand(R, n_cls, size, size, 1) > 0.5),
        "target": torch.from_numpy(target).to(device),
        "keep": torch.ones((R, b * n_cls), dtype=torch.float32, device=device),
    }


def make_trainer(device):
    """(trainer, params, momentum) of the bench: the flagship cfgs, the
    seeded parameters of init_meta_params(spec, 0)."""
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
    from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
    from fewshot_detection_tpu_torch.models.spec import build_spec
    from fewshot_detection_tpu_torch.train import MetaTrainer, init_momentum

    spec = MetaSpec(
        build_spec(parse_cfg(os.path.join(REPO, "cfg", "darknet_dynamic.cfg"))),
        build_spec(parse_cfg(os.path.join(REPO, "cfg", "reweighting_net.cfg"))),
    )
    init = init_meta_params(spec, 0)
    params = require_grads({k: from_jax_params(getattr(spec, k), init[k], device)
                            for k in ("darknet", "learnet")})
    trainer = MetaTrainer(spec, momentum=0.9, weight_decay=0.0005, device=device)
    return trainer, params, init_momentum(params)


def fence(device, metrics) -> float:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return float(metrics["loss"])


def _run(batch_size: int, device="cuda") -> float:
    """Images/s of ITERS steps at `batch_size` after WARMUP steps; prints
    the bn_sums launches of a step and, on the card, the peak memory."""
    import torch

    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.ops.bn_sums import bn_sums

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer, p, m = make_trainer(dev)
    batch = make_batch(batch_size, dev)

    for i in range(WARMUP):
        p, m, metrics = trainer.step(p, m, batch, seen=20000 + i, lr=1e-5)
    fence(dev, metrics)

    fwd0, bwd0 = bn_sums.launches, bn_sums.backward_launches
    t0 = time.perf_counter()
    for i in range(ITERS):
        p, m, metrics = trainer.step(p, m, batch, seen=30000 + i, lr=1e-5)
    fence(dev, metrics)
    dt = time.perf_counter() - t0
    print(f"batch {batch_size}: bn_sums launches a step: "
          f"{(bn_sums.launches - fwd0) / ITERS:g} forward, "
          f"{(bn_sums.backward_launches - bwd0) / ITERS:g} backward", flush=True)
    if dev.type == "cuda":
        print(f"batch {batch_size}: peak device memory "
              f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    return batch_size * ITERS / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the device the steps run on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.utils.card import card_line

    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)

    img_per_sec = None
    used_batch = None
    for b in (BATCH, *FALLBACK):
        try:
            img_per_sec = _run(b, dev)
            used_batch = b
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"batch {b}: out of memory, retrying smaller: {e}", flush=True)
            if dev.type == "cuda":
                print(f"batch {b}: peak device memory "
                      f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
        # the failed batch's tensors are referenced by nothing once the
        # exception is gone
        gc.collect()
        torch.cuda.empty_cache()
    assert img_per_sec is not None, "bench OOM'd at every batch size"
    result = {
        "metric": "meta_yolo_train_images_per_sec_per_chip",
        "value": round(img_per_sec, 2),
        "unit": (
            f"images/sec/chip (fwd+bwd+update, 416px, 15-way, "
            f"batch {used_batch})"
        ),
        "vs_baseline": round(img_per_sec / REF_IMG_PER_SEC_PER_GPU, 2),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
