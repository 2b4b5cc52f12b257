#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N] [--batches N]

Needs a CUDA device and `nvcc`; without a device it exits non-zero and prints
no result. It imports the port only (`fewshot_detection_tpu_torch`), builds
the port's CUDA kernel from the sources in this checkout, and runs four
phases, each printing one JSON line:

  device   the card as nvidia-smi names it, its power limit, torch/CUDA versions
  build    nvcc on csrc/nms.cu, seconds taken
  kernels  `nms_rows` (the CUDA kernel) against `nms_rows_reference` (plain
           PyTorch) on the card: keep masks must be bit-equal at the main
           path's shapes and on an adversarial set
  serve    the ensemble-eval path at full width (cfg/darknet_dynamic.cfg +
           cfg/reweighting_net.cfg at 416x416, the tracked trained checkpoint,
           batch 16, top_k 256) on images made from the seed: class codes from
           every support image -> fixed-code sweep -> decode, rank and NMS on
           the card -> per-class result files, in float32 and in bfloat16, for
           20 and 15 classes; one batch is also redone on the host path and
           must give the same boxes; each sweep reports the most candidates
           any (image, class) row held, against the buffer's 256
  traffic  candidates per row on one batch of each image kind the script can
           paint (flat background, noisy background), for 20 and 15 classes:
           how far the checkpoint's output is from overflowing the buffer

Then the card's name and power limit, one JSON object describing every kernel
(`{"kernels": [...]}`), and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.
Any failed check raises, so the exit code is non-zero and the last line is
not printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fewshot_detection_tpu_torch.config.settings import VOC_CLASSES
from fewshot_detection_tpu_torch.eval import valid
from fewshot_detection_tpu_torch.eval.detector import MetaDetector
from fewshot_detection_tpu_torch.eval.device_pipeline import (
    MetaDevicePipeline,
    _decode_rank,
    _nms_and_rows,
    _rows_to_eval_boxes,
)
from fewshot_detection_tpu_torch.ops import nms_device
from fewshot_detection_tpu_torch.ops.boxes import get_region_boxes_v2, nms
from fewshot_detection_tpu_torch.ops.nms_device import nms_rows, nms_rows_reference

REPO = os.path.dirname(os.path.abspath(__file__))
DARKNET_CFG = os.path.join(REPO, "cfg", "darknet_dynamic.cfg")
LEARNET_CFG = os.path.join(REPO, "cfg", "reweighting_net.cfg")
WEIGHTS = os.path.join(REPO, "artifacts", "flagship_base_novel0", "base_latest.weights.bf16.gz")
SEEN = 59220
BATCH = 16
TOP_K = 256
SUPPORTS_PER_CLASS = 3
NMS_THRESH = valid.NMS_THRESH

# published peaks of one H100 SXM: device memory rate, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# float32 operations of one pairwise IoU and its comparison, as csrc/nms.cu does them
FLOPS_PER_PAIR = 38
# Greedy NMS is a chain: whether candidate j is kept is known only after every
# kept candidate before it has applied its suppressions. The least a dependent
# step can cost is one round trip through shared memory (the alive flag written
# by one step and read by the next), about 20 cycles at the SXM part's 1.98 GHz
# boost clock. Barrier and issue costs come on top, so this is a floor.
CHAIN_STEP_S = 20 / 1.98e9


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


# ---------------------------------------------------------------------------
# data made from the seed
# ---------------------------------------------------------------------------


def paint_images(rng: np.random.Generator, n: int, size: int, background: str = "flat"):
    """n images (n, size, size, 3) float32 in [0, 1] with one or two bright
    rectangles each on a flat dark or a uniformly noisy background; also the
    first rectangle of each image as a normalized (cx, cy, w, h) box. The
    main path is driven with flat ones; the traffic phase reports how many
    candidates per row each kind leaves above the threshold."""
    if background == "flat":
        imgs = np.full((n, size, size, 3), 30, np.uint8)
    else:
        imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    first = np.zeros((n, 4), np.float32)
    for i in range(n):
        for j in range(int(rng.integers(1, 3))):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            bw, bh = rng.uniform(0.15, 0.4, 2)
            x1, x2 = int((cx - bw / 2) * size), int((cx + bw / 2) * size)
            y1, y2 = int((cy - bh / 2) * size), int((cy + bh / 2) * size)
            imgs[i, max(y1, 0):y2, max(x1, 0):x2] = rng.integers(120, 256, 3)
            if j == 0:
                first[i] = (cx, cy, bw, bh)
    return imgs.astype(np.float32) / 255.0, first


class MemoryDetectionSet:
    """In-memory stand-in for data.DetectionDataset: the interface the sweep
    uses (`batches`, `lines`, `image_size`)."""

    def __init__(self, images: np.ndarray, orig_size=(500, 375)):
        self.images = images
        self.lines = [f"mem/{i:06d}.png" for i in range(len(images))]
        self.orig_size = orig_size

    def image_size(self, index: int):
        return self.orig_size

    def batches(self, batch_size: int, drop_last: bool = True):
        n = len(self.images)
        end = n - (n % batch_size) if drop_last else n
        for s in range(0, end, batch_size):
            yield self.images[s:s + batch_size], None


class MemorySupportSet:
    """In-memory stand-in for data.MetaDataset(ensemble=True, with_ids=True)."""

    def __init__(self, classes, metax, masks, clsids):
        self.classes = tuple(classes)
        self.metax, self.masks, self.clsids = metax, masks, clsids

    def batches(self, batch_size: int):
        for s in range(0, len(self.metax), batch_size):
            e = s + batch_size
            yield self.metax[s:e], self.masks[s:e], self.clsids[s:e]


def make_support_set(rng, classes, per_class: int, size: int) -> MemorySupportSet:
    n = len(classes) * per_class
    metax, boxes = paint_images(rng, n, size)
    masks = np.zeros((n, size, size, 1), np.float32)
    for i, (cx, cy, bw, bh) in enumerate(boxes):
        x1, x2 = int(max(0, round((cx - bw / 2) * size))), int(min(size, round((cx + bw / 2) * size)))
        y1, y2 = int(max(0, round((cy - bh / 2) * size))), int(min(size, round((cy + bh / 2) * size)))
        masks[i, y1:y2, x1:x2] = 1.0
    clsids = np.repeat(np.arange(len(classes)), per_class)
    return MemorySupportSet(classes, metax, masks, clsids)


def make_nms_rows(rng, r: int, k: int, kind: str = "clustered"):
    """Candidate rows for the kernel comparison: boxes (r, k, 4) float32,
    confidences (r, k) float32 descending with a masked tail.

    clustered  boxes scattered around a few centres per row (what a detector
               emits); rows end in masked slots of varying length
    adversarial  near-duplicates, tied scores, IoUs a few float32 steps on
               either side of the threshold, and rows that are all masked"""
    boxes = np.empty((r, k, 4), np.float32)
    centres = rng.uniform(0.2, 0.8, (r, 6, 2))
    which = rng.integers(0, 6, (r, k))
    boxes[..., :2] = np.take_along_axis(centres, np.repeat(which[..., None], 2, -1), 1)
    boxes[..., :2] += rng.normal(0, 0.02, (r, k, 2))
    boxes[..., 2:] = rng.uniform(0.05, 0.4, (r, k, 2))
    conf = -np.sort(-rng.uniform(0.01, 1.0, (r, k)).astype(np.float32), axis=1)
    n_valid = rng.integers(0, k + 1, r)
    n_valid[0] = k
    if kind == "adversarial":
        t = np.float32(NMS_THRESH)
        for row in range(r):
            mode = row % 4
            if mode == 0:  # near-duplicates of slot 0, a few ulp apart
                boxes[row] = boxes[row, :1]
                boxes[row, 1:, :] += (rng.integers(-3, 4, (k - 1, 4)) * 2.0 ** -24).astype(np.float32)
            elif mode == 1:  # same centre and width; height ratio = IoU around the threshold
                boxes[row, :, :3] = (0.5, 0.5, 0.4)
                steps = rng.integers(-40, 41, k).astype(np.float32)
                boxes[row, :, 3] = np.float32(0.4) * t * (1 + steps * np.float32(2.0 ** -23))
                boxes[row, 0, 3] = 0.4
            elif mode == 2:  # tied scores
                conf[row] = np.float32(0.5)
            else:  # nothing above the threshold in this row
                n_valid[row] = 0
    for row in range(r):
        conf[row, n_valid[row]:] = 0.0
    return np.ascontiguousarray(boxes), np.ascontiguousarray(conf)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = nms_device.build_nms_library(verbose=True)
    nms_device._kernel()
    emit("build", source=os.path.relpath(nms_device.NMS_SOURCE, REPO),
         library=os.path.relpath(lib, REPO), flags=list(nms_device.NVCC_FLAGS),
         seconds=round(time.perf_counter() - t0, 3))


def pairwise_work(dsel: torch.Tensor, keep: torch.Tensor) -> tuple[int, int, int]:
    """(IoU pairs the greedy pass needs on these inputs, valid candidates of
    the longest row, dependent steps of the longest chain): a kept candidate
    i is compared with every later valid one and is one step of its row's
    chain; a suppressed one is compared with none and is no step."""
    valid_n = (dsel > 0).sum(dim=1)  # masked slots form the tail
    idx = torch.arange(dsel.shape[1], device=dsel.device)[None, :]
    pairs = torch.where(keep, (valid_n[:, None] - idx - 1).clamp(min=0), 0).sum()
    return int(pairs), int(valid_n.max()), int(keep.sum(dim=1).max())


def bound_ms(r: int, k: int, pairs: int, chain: int) -> dict:
    """Least time the card could take: the largest of the bytes moved once
    over the memory rate, the float32 operations over their peak rate, and
    the rows' longest chain of dependent steps at CHAIN_STEP_S each (rows run
    side by side, steps of one row cannot). `bound_by` names bytes or
    operations; `bound_term` says which of the two kinds of operations."""
    terms = {
        "bytes": r * k * (16 + 4 + 1) / PEAK_BYTES_PER_S * 1e3,
        "flops": pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS * 1e3,
        "chain": chain * CHAIN_STEP_S * 1e3,
    }
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bytes_bound_ms": terms["bytes"],
            "flops_bound_ms": terms["flops"], "chain_bound_ms": terms["chain"]}


def compare_kernel(boxes: torch.Tensor, dsel: torch.Tensor, timed: bool) -> dict:
    """Kernel against plain version on one input; optionally time both."""
    got = nms_rows(boxes, dsel, NMS_THRESH)
    torch.cuda.synchronize()
    want = nms_rows_reference(boxes, dsel, NMS_THRESH)
    mismatch = int((got != want).sum())
    r, k = dsel.shape
    pairs, longest, chain = pairwise_work(dsel, want)
    out = {"shape": [r, k], "max_mismatch": mismatch, "kept": int(want.sum()),
           "valid": int((dsel > 0).sum()), "iou_pairs": pairs, "longest_row": longest,
           "chain_steps": chain, **bound_ms(r, k, pairs, chain)}
    if timed:
        out["kernel_ms"] = cuda_ms(lambda: nms_rows(boxes, dsel, NMS_THRESH), 50)
        out["plain_ms"] = cuda_ms(lambda: nms_rows_reference(boxes, dsel, NMS_THRESH), 2, warmup=1)
    return out


def phase_kernels(seed: int) -> int:
    rng = np.random.default_rng(seed)
    cases = [("clustered", 320, 256), ("clustered", 240, 256), ("clustered", 16, 845),
             ("clustered", 1, 1), ("adversarial", 64, 256), ("adversarial", 16, 845),
             ("adversarial", 8, 33)]
    worst = 0
    results = []
    for kind, r, k in cases:
        boxes, conf = make_nms_rows(rng, r, k, kind)
        res = compare_kernel(torch.from_numpy(boxes).cuda(), torch.from_numpy(conf).cuda(),
                             timed=(kind == "clustered" and k == 256))
        res["case"] = kind
        results.append(res)
        worst = max(worst, res["max_mismatch"])
    emit("kernels", name="nms_rows", thresh=NMS_THRESH, launches=nms_rows.launches, cases=results)
    check(worst == 0, f"nms_rows disagrees with nms_rows_reference in {worst} slots")
    check(any(c["case"] == "adversarial" and 0 < c["kept"] < c["valid"] for c in results),
          "the adversarial set suppressed nothing")
    return worst


def sweep(m, detset, codes, n_cls, classes, outdir, tag):
    """One fixed-code sweep through valid._meta_sweep, the main path. The
    kernel's launch count is set to 0 just before and read just after, so it
    holds the sweep's own launches and none of the comparisons'."""
    stats: dict = {}
    torch.cuda.synchronize()
    nms_rows.launches = 0  # the count is read right after the sweep, below
    t0 = time.perf_counter()
    prefix = valid._meta_sweep(m, detset, os.path.join(outdir, tag), "comp4_det_test_",
                               codes, n_cls, classes, BATCH, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = nms_rows.launches
    lines = {}
    for name in classes:
        with open(os.path.join(prefix, f"comp4_det_test_{name}.txt")) as f:
            rows = f.read().splitlines()
        check(all(len(r.split()) == 6 for r in rows), f"malformed result row for {name}")
        check(all(np.isfinite([float(v) for v in r.split()[1:]]).all() for r in rows),
              f"non-finite result row for {name}")
        lines[name] = len(rows)
    check(stats["batches"] == len(detset.lines) // BATCH, "sweep saw another number of batches")
    # a batch whose rows overflow the candidate buffer goes to the host path
    # by protocol and launches nothing; every other batch is one launch
    check(launches == stats["device_batches"] and launches > 0,
          f"{launches} kernel launches for {stats['device_batches']} device batches")
    check(sum(lines.values()) > 0, "every result file is empty")
    return {"n_cls": n_cls, "batches": stats["batches"],
            "device_batches": stats["device_batches"], "nms_launches": launches,
            "max_candidates_per_row": stats["max_candidates"], "top_k": TOP_K,
            "images": len(detset.lines), "seconds": seconds,
            "images_per_s": len(detset.lines) / seconds,
            "result_rows": sum(lines.values()),
            "non_empty_files": sum(1 for v in lines.values() if v)}


def host_parity_and_stages(m, images, codes, n_cls) -> tuple[dict, tuple]:
    """One batch: device pipeline against the host path box for box, then
    milliseconds per stage. Returns (report, (bsel, dsel) of that batch)."""
    region = m.region
    output = m.detect(images, codes)
    check(tuple(output.shape) == (BATCH * n_cls, 13, 13, 30), f"head output {tuple(output.shape)}")
    check(bool(torch.isfinite(output).all()), "head output is not finite")
    pipe = MetaDevicePipeline(region, n_cls, conf_thresh=valid.CONF_THRESH,
                              nms_thresh=NMS_THRESH, top_k=TOP_K)
    dev = pipe.eval_boxes(output)
    check(dev is not None, "the candidate buffer overflowed on the parity batch")
    host = get_region_boxes_v2(output, n_cls, valid.CONF_THRESH, region.num_classes,
                               region.anchor_wh, only_objectness=False, validation=True)
    host = [nms(bl, NMS_THRESH) for bl in host]
    n_boxes, worst = 0, 0.0
    for r, (d, h) in enumerate(zip(dev, host)):
        check(len(d) == len(h), f"row {r}: device kept {len(d)} boxes, host {len(h)}")
        for db, hb in zip(d, h):
            worst = max(worst, float(np.max(np.abs(np.asarray(db[:6]) - np.asarray(hb[:6])))))
            n_boxes += 1
    check(n_boxes > 0, "the parity batch kept no box at all")
    # float32 values taken from the same tensors on both paths
    check(worst <= 1e-6, f"device and host boxes differ by {worst}")

    args = (n_cls, region.anchor_wh, region.num_classes, valid.CONF_THRESH, TOP_K)
    # the stages as `eval_boxes` composes them
    bsel, dsel, cconf, cid, _, csel = _decode_rank(output.float(), *args)
    rows, keep = _nms_and_rows(bsel, dsel, cconf, cid, NMS_THRESH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        _rows_to_eval_boxes(rows, keep, csel, valid.CONF_THRESH)
    d2h_ms = (time.perf_counter() - t0) / 3 * 1e3
    stages = {
        "detect_ms": cuda_ms(lambda: m.detect(images, codes), 5),
        "decode_rank_ms": cuda_ms(lambda: _decode_rank(output.float(), *args), 10),
        "nms_ms": cuda_ms(lambda: nms_rows(bsel, dsel, NMS_THRESH), 50),
        "d2h_and_lists_ms": d2h_ms,
    }
    return {"parity_boxes": n_boxes, "parity_max_abs_diff": worst, **stages}, (bsel, dsel)


def phase_traffic(m, codes, rng) -> None:
    """Candidates above the threshold per (image, class) row, on one batch of
    each image kind, for 20 and 15 classes. Reports only: a kind whose rows
    overflow the buffer would, by protocol, send its batches to the host
    path, and the main path is not driven with it."""
    region = m.region
    report = []
    for background in ("flat", "noise"):
        images, _ = paint_images(rng, BATCH, m.width, background)
        for n_cls in (20, 15):
            output = m.detect(images, m.commit_codes([c[:n_cls] for c in codes]))
            counts = _decode_rank(output.float(), n_cls, region.anchor_wh, region.num_classes,
                                  valid.CONF_THRESH, TOP_K)[4]
            report.append({"background": background, "n_cls": n_cls,
                           "max_candidates_per_row": int(counts.max()),
                           "mean_candidates_per_row": float(counts.float().mean()),
                           "rows_over_top_k": int((counts > TOP_K).sum()),
                           "rows": int(counts.numel())})
    emit("traffic", dtype="float32", top_k=TOP_K, conf_thresh=valid.CONF_THRESH, kinds=report)


def phase_serve(seed: int, n_batches: int, outdir: str) -> dict:
    """Returns the main path's kernel launches (summed over its sweeps) and
    the candidate rows of its first batch."""
    rng = np.random.default_rng(seed)
    support = make_support_set(rng, VOC_CLASSES, SUPPORTS_PER_CLASS, 416)
    images, _ = paint_images(rng, n_batches * BATCH, 416)
    detset = MemoryDetectionSet(images)
    captured = None
    main_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        m = MetaDetector(DARKNET_CFG, LEARNET_CFG, WEIGHTS, metain_type=2,
                         compute_dtype=dtype, device="cuda")
        load_s = time.perf_counter() - t0
        check(m.header.seen == SEEN, f"checkpoint header says seen={m.header.seen}")
        check((m.width, m.height) == (416, 416), "detector is not at 416x416")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes, cnt = valid.ensemble_class_codes(m, support)
        torch.cuda.synchronize()
        codes_s = time.perf_counter() - t0
        check(cnt.tolist() == [SUPPORTS_PER_CLASS] * 20, f"support counts {cnt.tolist()}")
        check(codes[0].shape == (20, 1, 1, 1024) and np.isfinite(codes[0]).all(),
              f"class codes {codes[0].shape}")

        report = {"dtype": name, "load_seconds": load_s, "supports": len(support.metax),
                  "codes_seconds": codes_s, "sweeps": [], "one_batch": []}
        for n_cls in (20, 15):
            classes = VOC_CLASSES[:n_cls]
            dev_codes = m.commit_codes([c[:n_cls] for c in codes])
            # the one-batch pass comes first: it also warms the card up, so
            # the sweep's rate is not that of first calls
            one, rows = host_parity_and_stages(m, images[:BATCH], dev_codes, n_cls)
            report["one_batch"].append({"n_cls": n_cls, **one})
            report["sweeps"].append(
                sweep(m, detset, dev_codes, n_cls, classes, outdir, f"{name}_{n_cls}"))
            main_launches += report["sweeps"][-1]["nms_launches"]
            if captured is None:
                captured = rows
        emit("serve", **report)
        if dtype == torch.float32:
            phase_traffic(m, codes, np.random.default_rng(seed + 1))
    return {"rows": captured, "launches": main_launches}


def kernels_line(launches: int, worst: int, rows) -> dict:
    """The summary of every kernel of the port, timed on the candidate rows
    that the main path's first batch produced (20 classes, float32). The rows
    are in L2 when the kernel starts, as they are behind `_decode_rank`."""
    bsel, dsel = rows
    res = compare_kernel(bsel, dsel, timed=True)
    check(res["max_mismatch"] == 0, "nms_rows disagrees on the main path's rows")
    return {"kernels": [{
        "name": "nms_rows",
        "route": "cuda",
        "source": "fewshot_detection_tpu_torch/csrc/nms.cu",
        "replaces": "fewshot_detection_tpu/ops/nms_device.py:57",
        "launches": launches,
        "max_abs_err": float(max(worst, res["max_mismatch"])),
        "ms": res["kernel_ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,
        "shape": res["shape"],
        "valid": res["valid"],
        "kept": res["kept"],
        "iou_pairs": res["iou_pairs"],
        "longest_row": res["longest_row"],
        "chain_steps": res["chain_steps"],
        "bound_term": res["bound_term"],
        "bytes_bound_ms": res["bytes_bound_ms"],
        "flops_bound_ms": res["flops_bound_ms"],
        "chain_bound_ms": res["chain_bound_ms"],
    }]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=3, help="detection batches of 16 per sweep")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    # float32 runs are full float32: no TF32 in convolutions or matrix products
    valid.set_float32_precision(tf32=False)

    smi = phase_device()
    phase_build()
    worst = phase_kernels(args.seed)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as outdir:
        served = phase_serve(args.seed, args.batches, outdir)
    launches = served["launches"]
    check(launches > 0, "the main path never launched the NMS kernel")

    line = kernels_line(launches, worst, served["rows"])
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
