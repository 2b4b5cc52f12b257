#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N] [--batches N] [--phases a,b,...]

Needs a CUDA device and `nvcc`; without a device it exits non-zero and prints
no result. It imports the port only (`fewshot_detection_tpu_torch`), builds
the port's CUDA kernels from the sources in this checkout, and runs these
phases, each printing JSON lines:

  device   the card as nvidia-smi names it, its power limit, torch/CUDA versions
  build    nvcc on csrc/nms.cu, csrc/bn_sums.cu, csrc/bn_act.cu and
           csrc/maxpool.cu, side by side, seconds taken
  kernels  `nms_rows` (the CUDA kernel) against `nms_rows_reference` (plain
           PyTorch) on the card: keep masks must be bit-equal at the main
           path's shapes, on an adversarial set and on the edges of the
           kernel's groups of 32 (K not a multiple of 32, rows with no live
           candidate, rows that end inside a group, all-identical boxes),
           and on rows longer than the kernel's shared-memory limit MAX_K
           (up to (1, 12800), a 1024 x 2560 WIDER image's grid), which take
           its workspace path; every shorter case is also run through the
           workspace path and must give the same bits;
           `bn_sums` forward and backward against their plain versions,
           float32 and bfloat16, at the training path's shapes and at awkward
           ones that reach both forward kernels (the library says which ran:
           "vector" or "scalar"): the sums within a stated bound of a float64
           sum, one kernel a call on either path (counted by the profiler),
           two launches bit-equal, also back to back and on a second stream
           (the reused workspace), the backward bit-equal to the plain
           version. Times are taken twice: per call made from Python one after
           the other (`ms`, the measure of the earlier slices) and on the card
           alone (`card_ms`);
           `bn_act` (training BN's normalise + activation epilogue) forward
           and backward against their plain versions: leaky, relu and linear,
           float32 and bfloat16, on both paths (a misaligned base too): the
           output and dy bit-equal, the pair's gradients within one unit of
           the type (or SUM_TOL of their terms' magnitudes where a channel's
           sum cancels), two launches bit-equal, also on a second stream, a
           non-contiguous input copied and counted, one kernel a call each
           way; timed beside the plain versions and the byte bound at the
           bench step's first BN (66,453,504, 32) and the batch-64 cells'
           13 x 13 layers (10,816, 1024);
           `maxpool2x2` (2x2 stride-2 pools) forward and backward against
           `F.max_pool2d` and the plain versions, float32, bfloat16 and
           float16, on both paths: values and gradients bit-equal, one kernel
           a call each way; timed beside the plain versions, the library's
           pair (`F.max_pool2d` with its indices) and the byte bound at the
           bench step's first pool (384, 416, 416, 32) and the learnet's odd
           (15, 13, 13, 1024)
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

  train    the episodic meta-training step at full width (the same cfgs and
           checkpoint, 416x416, the cfg's batch 64, a 15-way support set, one
           replica group, lr and weight decay as the CLI derives them) on
           episodes painted from the seed, in float32 without TF32 and in
           bfloat16: the first step's loss and gradient norms against the same
           step through the plain `bn_sums` and `bn_act`, 2 warm-up + 5
           timed steps with 29 forward and 29 backward launches each of
           `bn_sums` and of `bn_act`, running statistics that moved, peak memory, images/s and the
           share of a step spent in the `bn_sums` kernels; then `train_s2d`:
           the space-to-depth stem (`s2d=True`) against the plain stem, one
           float32 step each way from the same parameters and episode (the
           loss within 1e-5, the norms of each leaf's update and of the
           whole tree's within 2e-2 and 2e-4 of the plain stem's, the
           first-step check's bounds for two float32 answers), and images/s and peak memory of both stems in both types,
           29 + 29 `bn_sums` launches a step; then `bn_sums_step`,
           the kernels' time and byte bound summed over the 29 BN layers of
           one step, forward and backward, both types
  plain_serve  the plain YOLOv2 family at full width (cfg/yolo-voc.cfg,
           Darknet-19 at 416x416, 20 classes) from seeded weights written to a
           .weights file and read back through PlainDetector (BN folded): the
           plain sweep at batch 16 with a candidate buffer of 845 (every anchor:
           the random head passes nearly all of them at the sweep's threshold)
           in float32 and bfloat16, one NMS launch a batch; one batch redone on
           the host path box for box; one batch at the default buffer of 256,
           where a batch whose rows overflow goes to the host path; the detect
           flow of detect_torch.py (serving thresholds, a buffer of every
           anchor) with a keep mask bit-equal to the plain version's and the
           host path's boxes
  plain_train  PlainTrainer at the cfg's batch 64, 416 px, one group, as
           train_plain_cli derives lr and weight decay, from the same seeded
           weights on images painted from the seed: as `train`, with 22 + 22
           `bn_sums` launches a step, `plain_train_s2d` as `train_s2d`; then
           `bn_sums_step` for its 22 layers
  debug    debug_torch.py's main on cfg/yolo-voc.cfg from the seeded weights
           and a painted PNG with its label file (FSD_NATIVE=1): one training
           forward and backward on the card, 22 + 22 `bn_sums` launches, the
           loss and every conv's largest weight gradient finite
  int8_serve  int8 serving (FSD_INT8=1, models/quant.py; the int8 products
           are torch._int_mm through ops/int8_mm.py) at full width on the
           tracked checkpoint over 32 images of the workflow's synthetic
           style (data/synth.py) written as PNG files: run_valid_ensemble in
           float32 with the int8 head and with FSD_INT8_HEAD=0 (result
           files, NMS and int8 launches per batch); then in float32 and
           bfloat16, in memory, class codes over every support image,
           valid.quantize_sweep (calibration seconds), detect_ms int8 against
           float, the first batch's head output against the float one (its
           deviation and confident boxes reported: on the trained checkpoint
           the scheme deviates far more than the JAX tests' bounds, in the
           JAX package too), and the sweep at 20 and 15 classes (the head's N = 450 padded to
           456), images/s; the card's int8 codes (every quantized input, the
           head's effective weight) equal to the CPU's for the same float
           tensor; PlainDetector.quantize_int8 on cfg/yolo-voc.cfg from the
           seeded weights; the JAX package's int8 closeness tests
           (tests/test_quant.py) on the card with their recipe and bounds
           (64 px, seeded weights: plain 0.05, meta 0.06, learnet and head
           0.08). Every int8 product (M, K, N) launched is
           recorded and held again on the card against the plain int64
           product on the CPU: the int32 results equal; card ms, TOP/s and
           bound per shape
  native   the host toolchain (`g++ --version`, zlib's header and library;
           nothing decides from it) and the port's native image library
           built with g++ from its sources (its own PNG decoder on zlib and
           JPEG decoder, -lz -pthread only): PNGs written by
           data/png.py decoding bit-equal to the arrays written, over every
           colour type, bit depth, row filter and Adam7 (to libpng's pixels,
           data/png.libpng_rgb); the JPEG fixtures of
           tests/data_torch/jpeg/ and the repo's predictions.jpg decoding to
           their committed SHA-256 digests (the JAX package's libjpeg-turbo
           decode: baseline, progressive, arithmetic; what that library fails
           on too is refused with an error that names it), image_size equal
           on each; decode throughput on the card's host (MB/s of RGB output
           and images/s, one thread) and the pthread batch assembler's
           images/s (64 images decoded, augmented and resized to 416), for
           VOC-sized PNGs, predictions.jpg, and its progressive and
           arithmetic transcodes; load_image_resized(predictions.jpg, 416,
           416) under FSD_NATIVE=1 (the port's decode, then its copy of PIL's
           default bicubic resize) against the committed SHA-256 of the JAX
           package's output (tests/data_torch/resize_digests.json)
  ckpt     full-state checkpoints of the meta step (the `train` phase's
           cfgs, checkpoint, batch 64, 15-way, bfloat16): 2 steps, a
           synchronous save, an async save (FSD_ASYNC_CKPT=1) with a step
           launched while it writes, both restored into a fresh tree on the
           card bit-equal to host copies taken at the saves; a torch.profiler
           trace of 3 steps (utils/profiling.trace) whose summary
           (utils/trace_summary) names the bn_sums kernels, 29 + 29 a step
  files    the path on image files: a VOC
           devkit painted from the seed (PNG images at VOC sizes, XML
           annotations, 20 classes), data/prep.py's labels, labels_1c,
           10-shot box and image fewlists and traindict, few-shot tuning
           through train_meta_cli.main from the tracked checkpoint at the
           cfgs' width and batch in bfloat16 with FSD_NATIVE=1
           FSD_NATIVE_BATCH=1 FSD_WORKERS=2 FSD_ORBAX_DIR FSD_ASYNC_CKPT=1
           FSD_PROFILE_DIR for 2 epochs, a second run resumed to 3 epochs from
           the newest checkpoint, then run_valid_ensemble on the tuned
           .weights over the painted test list (FSD_NATIVE=1, result files for
           20 classes through the NMS kernel) and voc_eval's mAP (a number for
           painted data, not a quality claim)
  workflow the paper's whole workflow (cli/workflow.py, the flagship mode)
           stage by stage on the card: synthetic VOC, plain YOLOv2 on
           cfg/yolo-voc.cfg, the conv-23 backbone, episodic base training and
           few-shot tuning on cfg/darknet_dynamic.cfg + cfg/reweighting_net.cfg
           at the workflow's batch of 32, the ensemble sweeps and voc_eval on
           the base and the tuned checkpoints; depth cut as WORKFLOW_ARGS
           says (listed as `reduced`); each stage's seconds, steps, first and
           last loss and bn_sums / nms_rows launches, and the two mAPs (numbers
           for synthetic data, not a quality claim)
  coco     the paper's COCO protocol (60 base / 20 novel classes, novel
           split 2 of data/coco_novels.txt) at full width: one 60-way base
           step and one 80-way tuning step (cfg/darknet_dynamic.cfg +
           cfg/reweighting_net.cfg, 416 px, batch 32, painted noisy
           episodes, the seeded initial weights) in float32 and bfloat16,
           2 warm-up + 3 timed steps each (images/s, peak memory, 29 + 29
           bn_sums launches a step, finite losses, the first step's class
           loss per object beside ln 60 and ln 80); then cli/workflow_coco.py
           stage by stage on the card (synthetic 80-class COCO, the 80-class
           425-filter plain head, conv-23 backbone, 60-way base training,
           10-shot lists, 80-way tuning, the sweeps and AP over 60 and over
           80 classes) at the depth COCO_REDUCED cuts it to (listed as
           `reduced`): each stage's seconds, steps and launches, the sweeps'
           images/s with the class codes, the host tail (d2h_and_lists_ms),
           the file writes and the scoring broken out; afterwards both
           kernels timed at the path's largest inputs
  dp       data parallelism over torch.distributed (parallel/mesh.py) on the
           card's one H100: the `train` phase's meta step at batch 64, 416 px,
           float32 (TF32 off) split into R = 2 replica groups of 32, first in
           this process with no mesh; then a world of one under NCCL (a
           spawned rank, both groups on it, through the mesh): its loss and
           the norms of each leaf's update and of the whole tree's against the
           one-process step within the first-step check's bounds for two
           float32 answers, the collectives a step (counted in the mesh),
           58 + 58 bn_sums launches, images/s with and without the mesh; then
           a world of two under gloo with both ranks on cuda:0 (NCCL refuses
           two ranks on one device; gloo's collectives go through host
           copies), one group a rank: the meta step and a PlainTrainer step
           (cfg/yolo-voc.cfg, seeded weights), both ranks' trees bit-equal and
           within the same bounds of the one-process step, each rank's peak
           memory; and in that world run_valid_ensemble under
           FSD_EVAL_MESH=2 (the serve cfgs and checkpoint, 16 painted PNGs at
           batch 5, so every batch is padded) with nms_rows launched on both
           ranks and result files line-equal to this process's sweep. Each
           world is joined within DP_WORLD_SECONDS; a rank that fails or runs
           past it fails the phase
  analysis the eight analysis tools (scripts/*_torch.py) on the card under
           FSD_NATIVE=1 on painted PNGs: multiscale_epoch at flagship width,
           batch 32, every size 320-608 (first step, steady step, images/s
           and peak memory a bucket; 29 + 29 bn_sums launches a step) and
           its streaming epoch cut to MS_EPOCH_BATCHES (at least 3 sizes
           crossed); support_snr on the tracked checkpoint, 15-way,
           SNR_DRAWS draws, the first draw's codes held to the CPU's within
           SNR_CODE_TOL; learning_check --full cut to LEARN_ARGS (a finite
           mAP, each part's seconds); a tiny workflow root (TINY_ARGS) and
           shot_sweep over it at SWEEP_SHOTS, its tuning cut; eval_widerface
           on cfg/yolo-voc.cfg from seeded weights over a painted WIDER tree
           (an image under MAX_K, two over it up to 12,800 candidates, one
           omitted): one nms_rows launch an image, on the workspace path past
           MAX_K, every image's boxes those of the host path; then
           tuning_delta and seed_stats over the workflow phase's root and the
           tiny root, and cls_curve over every training log, whose table must
           count every loss line. The cuts are listed as `reduced`
  bench    the five measurement scripts of the JAX tree, ported, on the card:
           bench_torch.py at its defaults (the meta-training step at batch
           384, 416 px, bfloat16, 3 + 10 steps, 29 + 29 bn_sums and bn_act
           launches a step; a fallback to a smaller batch is reported with
           its OOM message), scripts/roofline_b384_torch.py (its FlopCounter
           count equal to the spec's, mfu_pct and hbm_util_pct in (0, 100]),
           bench_meta_pipeline_torch.py at its defaults (the host path's
           counts in every row, 11 nms_rows launches), bench_int8_meta_torch.py on the tracked
           checkpoint (every deviation finite) and
           bench_input_pipeline_torch.py under FSD_NATIVE=1 with
           BENCH_INPUT_ARGS (on a host without PIL `pil` is null beside its
           reason); the batch that ran, images/s, mfu_pct, peak memory, the
           card and its power limit; afterwards both kernels timed at the
           path's largest inputs, (66,453,504, 32) bfloat16 and (240, 128)
  path_inputs  every path above (serve, plain_serve, int8_serve, train,
           plain_train, ckpt, files, workflow, coco, dp: the ranks' inputs
           too, analysis: every multi-scale bucket, the WIDER rows, bench:
           the batch-384 step's BN inputs) runs
           with its kernel inputs recorded
           (`PathInputs`, no launch of its own); afterwards each kernel is
           held against its plain version there, as in `kernels`: bn_sums at
           every distinct (M, C, dtype) a path launched, the workflow's
           also at 608 px (the top of the multi-scale schedule), and
           nms_rows on the first rows of each distinct (R, K) a sweep ranked

`--phases` runs a subset (for finding faults); the result line is printed
only when every phase ran. Then the card's name and power limit, one JSON
object describing every kernel
(`{"kernels": [...]}`), and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.
Any failed check raises, so the exit code is non-zero and the last line is
not printed.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import importlib
import io
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from fewshot_detection_tpu_torch.cli import train_meta_cli
from fewshot_detection_tpu_torch.cli.common import resolve_configs
from fewshot_detection_tpu_torch.cli.train_meta_cli import make_episode_batch, schedule_from_cfg
from fewshot_detection_tpu_torch.cli.train_plain_cli import (
    make_plain_batch,
    plain_schedule_from_cfg,
)
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.config.settings import VOC_CLASSES
from fewshot_detection_tpu_torch.data import png, prep
from fewshot_detection_tpu_torch.data.datasets import DetectionDataset, MetaDataset
from fewshot_detection_tpu_torch.data.synth import make_voc_like
from fewshot_detection_tpu_torch.data.augment import sample_augment_params
from fewshot_detection_tpu_torch.eval import device_pipeline, valid
from fewshot_detection_tpu_torch.eval.detector import MetaDetector, PlainDetector
from fewshot_detection_tpu_torch.eval.device_pipeline import (
    _decode_rank,
    _nms_and_rows,
    _rows_to_eval_boxes,
)
from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
from fewshot_detection_tpu_torch.models import meta as meta_mod, quant
from fewshot_detection_tpu_torch.models.darknet import apply_network, folded_spec, init_params
from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.eval.voc_eval import do_python_eval
from fewshot_detection_tpu_torch.models.weights_io import (
    load_weights_bf16_gz,
    read_bf16_gz,
    save_weights,
)
from fewshot_detection_tpu_torch.native import NativeImagePipe
from fewshot_detection_tpu_torch.native import build_library as build_native_library
from fewshot_detection_tpu_torch.native.loader import library_path as native_library_path
from fewshot_detection_tpu_torch.ops import _build, bn_act as act_mod, bn_sums as bn_mod, layers, nms_device
from fewshot_detection_tpu_torch.ops import pool2x2 as pool_mod
from fewshot_detection_tpu_torch.ops.bn_act import (
    bn_act,
    bn_act_backward_reference,
    bn_act_reference,
)
from fewshot_detection_tpu_torch.ops.bn_sums import (
    vector_width,
    bn_sums,
    bn_sums_backward,
    bn_sums_backward_reference,
    bn_sums_reference,
)
from fewshot_detection_tpu_torch.ops import int8_mm
from fewshot_detection_tpu_torch.ops.boxes import get_region_boxes, get_region_boxes_v2, nms
from fewshot_detection_tpu_torch.ops.int8_mm import int8_matmul, int8_matmul_reference
from fewshot_detection_tpu_torch.ops.pool2x2 import (
    maxpool2x2,
    maxpool2x2_backward_reference,
    maxpool2x2_reference,
)
from fewshot_detection_tpu_torch.ops.nms_device import nms_rows, nms_rows_reference
from fewshot_detection_tpu_torch.parallel import shard_batch
from fewshot_detection_tpu_torch.train import MetaTrainer, PlainTrainer, init_momentum
from fewshot_detection_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
    wait_for_saves,
)
from fewshot_detection_tpu_torch.train.optim import tree_leaves_with_path, tree_map
from fewshot_detection_tpu_torch.utils import format_loss_line
from fewshot_detection_tpu_torch.utils.card import nvidia_smi
from fewshot_detection_tpu_torch.utils.imaging import load_image_resized
from fewshot_detection_tpu_torch.utils.profiling import WARMUP_KERNEL, trace, warm_up_cuda_trace
from fewshot_detection_tpu_torch.utils.trace_summary import find_trace_files, load_events, summarize

import debug_torch
import detect_torch

REPO = os.path.dirname(os.path.abspath(__file__))
DARKNET_CFG = os.path.join(REPO, "cfg", "darknet_dynamic.cfg")
LEARNET_CFG = os.path.join(REPO, "cfg", "reweighting_net.cfg")
WEIGHTS = os.path.join(REPO, "artifacts", "flagship_base_novel0", "base_latest.weights.bf16.gz")
SEEN = 59220
DEVICE = "cuda"  # every tensor the script makes goes here
BATCH = 16
TOP_K = 256
SUPPORTS_PER_CLASS = 3
NMS_THRESH = valid.NMS_THRESH
# the train phase: the cfg's batch, a 15-way support set, the data cfg's neg=1
TRAIN_N_CLS = 15
TRAIN_NEG_RATIO = 1
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 5
# training BatchNorms of the two cfgs: 22 in the detector, 7 in the learnet
BN_LAYERS = 29
# the plain family: cfg/yolo-voc.cfg (Darknet-19, 416 px, 20 classes, 22 BN)
PLAIN_CFG = os.path.join(REPO, "cfg", "yolo-voc.cfg")
PLAIN_BN_LAYERS = 22
PLAIN_SEEN = 640  # written into the seeded weights' header, read back
# the plain sweep's candidate buffer: every anchor of the 13x13x5 grid. The
# random head passes nearly every anchor at the sweep's threshold 0.005
# (det about 0.5, the top class at least 1/20), more than the default 256.
PLAIN_TOP_K = 845
PLAIN_PICKS = {"conv0.w": (0, "w"), "conv0.gamma": (0, "bn", "gamma"),
               "conv13.w": (13, "w"), "conv29.beta": (29, "bn", "beta"), "head.w": (30, "w"),
               "head.b": (30, "b")}
# |sum - float64 sum| <= SUM_TOL * sum|x| per channel: float32 rounds each add
# to 2^-24 relative, and the longest chain of adds in the kernel (a thread's
# rows / 4, then 8 warps, then the blocks / 8, then 8) and in PyTorch's own
# reduction stays under a few hundred, of which the errors partly cancel
SUM_TOL = 2e-6

# published peaks of one H100 SXM: device memory rate, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# float32 operations of one pairwise IoU and its comparison, as csrc/nms.cu
# does them for a pair that meets (the terms of one box alone are computed
# once per box and not counted here)
FLOPS_PER_PAIR = 22
# Greedy NMS is a chain: whether candidate j is kept is known only after every
# kept candidate before it has been settled. The IoUs do not depend on the
# chain, so the least a dependent step can cost is one arithmetic operation
# on a register that the step before wrote ("is any kept bit set in this
# candidate's word"), 4 cycles at the SXM part's 1.98 GHz boost clock; a round
# trip through shared memory (about 20 cycles) is what a design costs that
# keeps the flags there, not what the function needs. Ballots, barriers and
# scheduling costs come on top, so this is a floor.
CHAIN_STEP_S = 4 / 1.98e9


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


def card_ms(fn, repeats: int) -> float:
    """Mean milliseconds fn() takes on the card: the launches are queued
    behind a spin kernel of some 10 ms, so the host has queued all of them
    before the first starts and its cost per call does not show. `cuda_ms`
    is what a caller sees who launches one call after the other; the two
    differ where a call costs the host more than the card."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
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


def make_support_set(rng, classes, per_class: int, size: int,
                     background: str = "flat") -> MemorySupportSet:
    n = len(classes) * per_class
    metax, boxes = paint_images(rng, n, size, background)
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
               either side of the threshold, and rows that are all masked
    edges      what a kernel that works in groups of 32 candidates can get
               wrong: rows of identical boxes (full and cut short), rows with
               no live candidate, rows whose live candidates end one past,
               at, and one before a group's end, a single live candidate"""
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
    if kind == "edges":
        lengths = (k, 0, 33, 32, 31, 1, 45, 64, 65, 0)
        for row in range(r):
            n_valid[row] = min(k, lengths[row % len(lengths)])
            if row % len(lengths) in (0, 6):  # all-identical boxes
                boxes[row] = boxes[row, :1]
    for row in range(r):
        conf[row, n_valid[row]:] = 0.0
    return np.ascontiguousarray(boxes), np.ascontiguousarray(conf)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = nvidia_smi("name,power.limit")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    """Every source is started before any is waited on."""
    t0 = time.perf_counter()
    names = ("nms", "bn_sums", "bn_act", "maxpool")
    handles = [_build.start_build(n, verbose=True) for n in names]
    for h in handles:
        _build.finish_build(h)
    nms_device._kernel()
    bn_mod._kernels()
    act_mod._kernels()
    pool_mod._kernels()
    emit("build", sources=[os.path.relpath(_build.source_path(n), REPO) for n in names],
         libraries=[os.path.relpath(_build.library_path(n), REPO) for n in names],
         flags=list(_build.NVCC_FLAGS), seconds=round(time.perf_counter() - t0, 3))


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
        out["card_ms"] = card_ms(lambda: nms_rows(boxes, dsel, NMS_THRESH), 50)
        out["plain_ms"] = cuda_ms(lambda: nms_rows_reference(boxes, dsel, NMS_THRESH), 2, warmup=1)
        out["share_of_bound"] = out["bound_ms"] / out["card_ms"]
        check(out["share_of_bound"] <= 1.0,
              f"nms_rows took {out['card_ms']} ms, under its bound {out['bound_ms']} ms: "
              "the bound is wrong")
    return out


# the longest row a path gives: a 1024 x 2560 WIDER image on yolo-voc's grid
# (5 anchors a cell at stride 32), past the kernel's shared-memory limit
LONG_ROW = 5 * (1024 // 32) * (2560 // 32)


def phase_kernels(seed: int) -> tuple[int, dict]:
    """nms_rows against its plain version on every case; a row longer than
    MAX_K takes the workspace path, and every shorter case is also run
    through that path (`_launch(..., long=True)`), which must give the same
    bits. Returns the worst mismatch and the timed (1, LONG_ROW) case."""
    rng = np.random.default_rng(seed)
    cases = [("clustered", 320, 256), ("clustered", 240, 256), ("clustered", 320, 845),
             ("clustered", 16, 845), ("clustered", 1, 1), ("adversarial", 64, 256),
             ("adversarial", 16, 845), ("adversarial", 8, 33), ("edges", 20, 256),
             ("edges", 20, 100), ("edges", 10, 845), ("edges", 10, 31), ("clustered", 37, 77),
             ("clustered", 1, LONG_ROW), ("clustered", 3, nms_device.MAX_K + 1),
             ("adversarial", 4, 6000), ("edges", 10, nms_device.MAX_K + 33)]
    worst = 0
    results = []
    for kind, r, k in cases:
        boxes, conf = (torch.from_numpy(a).cuda() for a in make_nms_rows(rng, r, k, kind))
        res = compare_kernel(boxes, conf, timed=(kind == "clustered" and k >= 256))
        res["case"] = kind
        res["path"] = "workspace" if k > nms_device.MAX_K else "shared"
        if k <= nms_device.MAX_K:
            got = nms_device._launch(boxes, conf, NMS_THRESH, True)
            res["workspace_path_mismatch"] = int(
                (got != nms_rows_reference(boxes, conf, NMS_THRESH)).sum())
            worst = max(worst, res["workspace_path_mismatch"])
        results.append(res)
        worst = max(worst, res["max_mismatch"])
    emit("kernels", name="nms_rows", thresh=NMS_THRESH, launches=nms_rows.launches,
         long_launches=nms_rows.long_launches, cases=results)
    check(worst == 0, f"nms_rows disagrees with nms_rows_reference in {worst} slots")
    for kind in ("adversarial", "edges"):
        check(any(c["case"] == kind and 0 < c["kept"] < c["valid"] for c in results),
              f"the {kind} set suppressed nothing")
    long = [c for c in results if c["shape"] == [1, LONG_ROW]][0]
    check(long["kept"] > 0 and "card_ms" in long, "the long row was not timed")
    return worst, long


# ---------------------------------------------------------------------------
# bn_sums: the kernels against their plain versions
# ---------------------------------------------------------------------------


def bn_bound_ms(m: int, c: int, itemsize: int, backward: bool) -> float:
    """Bytes moved once over the memory rate: the forward reads x and writes
    2*C floats, the backward reads x, dsum, dsq and writes dx. The arithmetic
    (3 operations a value) is far below the float32 rate, so bytes bind."""
    nbytes = m * c * itemsize * (2 if backward else 1) + 2 * c * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3


def make_activation(seed: int, m: int, c: int, dtype) -> torch.Tensor:
    """(m, c) values like a conv output before BN: per-channel offset and
    scale, made on the card from the seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((m, c), generator=g, device=DEVICE, dtype=torch.float32)
    x = x * torch.linspace(0.5, 2.0, c, device=DEVICE) + torch.linspace(-1.0, 1.0, c, device=DEVICE)
    return x.to(dtype)


def compare_bn_sums(x: torch.Tensor, seed: int) -> dict:
    """Kernel and plain version on one input: the sums against a float64 sum
    within SUM_TOL * sum|x|, two launches bit-equal, the backward bit-equal
    to the plain backward. Raises on any failure."""
    c = x.shape[-1]
    copies0 = bn_sums.layout_copies
    s, q = bn_sums(x)
    path = bn_sums.last_path  # which forward kernel the library launched
    s2, q2 = bn_sums(x)
    torch.cuda.synchronize()
    check(torch.equal(s, s2) and torch.equal(q, q2),
          f"bn_sums: two launches differ at {tuple(x.shape)} {x.dtype}")
    # the wrapper sizes its grid for the path it expects from shape and
    # alignment; the library chooses by the same rule and says what it chose
    xc = x.contiguous()
    want_path = "vector" if vector_width(c, x.element_size(), xc.data_ptr()) > 1 else "scalar"
    check(path == want_path or not x.is_contiguous(),
          f"bn_sums took the {path} path at {tuple(x.shape)} {x.dtype}, expected {want_path}")
    check_workspace_reuse(xc, s, q)
    ps, pq = bn_sums_reference(x)
    xd = x.reshape(-1, c).double()
    s64, q64 = xd.sum(0), (xd * xd).sum(0)
    room_s, room_q = SUM_TOL * xd.abs().sum(0), SUM_TOL * q64
    del xd
    rel = {}
    for name, (gs, gq) in (("kernel", (s, q)), ("plain", (ps, pq))):
        es, eq = (gs.double() - s64).abs(), (gq.double() - q64).abs()
        check(bool((es <= room_s).all()) and bool((eq <= room_q).all()),
              f"bn_sums {name} sums off their bound at {tuple(x.shape)} {x.dtype}")
        rel[name] = float(torch.maximum(es / room_s.clamp(min=1e-300),
                                        eq / room_q.clamp(min=1e-300)).max()) * SUM_TOL
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    dsum = torch.randn(c, generator=g, device=DEVICE)
    dsq = torch.randn(c, generator=g, device=DEVICE)
    worst_dx = 0.0
    for ds, dq in ((dsum, dsq), (None, dsq), (dsum, None)):
        dx = bn_sums_backward(xc, ds, dq)
        want = bn_sums_backward_reference(xc, ds, dq)
        torch.cuda.synchronize()
        check(dx.dtype == x.dtype and dx.shape == x.shape, "bn_sums backward shape or dtype")
        diff = float((dx.float() - want.float()).abs().max())
        worst_dx = max(worst_dx, diff)
        if x.dtype == torch.float32:
            check(torch.equal(dx, want), f"bn_sums backward differs by {diff} at {tuple(x.shape)}")
        else:  # within one bfloat16 rounding step (2^-8 relative)
            check(bool(((dx.float() - want.float()).abs() <= want.float().abs() * 2.0 ** -8).all()),
                  f"bn_sums backward off by {diff} at {tuple(x.shape)} bfloat16")
    return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1], "path": path,
            "aligned16": xc.data_ptr() % 16 == 0, "contiguous": x.is_contiguous(),
            "layout_copies": bn_sums.layout_copies - copies0,
            "sum_abs_err": float((s.double() - s64).abs().max()),
            "sumsq_abs_err": float((q.double() - q64).abs().max()),
            "kernel_err_over_sum_abs": rel["kernel"], "plain_err_over_sum_abs": rel["plain"],
            "tolerance_over_sum_abs": SUM_TOL, "backward_max_abs_err": worst_dx}


SIDE_STREAM = None  # made once: a second stream for the workspace checks


def check_workspace_reuse(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> None:
    """The forward's table of partials and its tickets are reused from call
    to call. Many launches back to back on one stream, then the same call on
    a second stream while the first is still busy, must all give the bits of
    the first launch (s, q)."""
    global SIDE_STREAM
    if SIDE_STREAM is None:
        SIDE_STREAM = torch.cuda.Stream()
    repeats = 4 if x.numel() > 1 << 26 else 16
    outs = [bn_mod._launch_forward(x) for _ in range(repeats)]
    SIDE_STREAM.wait_stream(torch.cuda.current_stream())  # x is ready
    with torch.cuda.stream(SIDE_STREAM):
        side = [bn_mod._launch_forward(x) for _ in range(repeats)]
    outs += [bn_mod._launch_forward(x) for _ in range(repeats)]  # beside the side stream's
    torch.cuda.synchronize()
    for tag, group in (("back to back", outs), ("on a second stream", side)):
        check(all(torch.equal(a, s) and torch.equal(b, q) for a, b in group),
              f"bn_sums: launches {tag} differ at {tuple(x.shape)} {x.dtype}")


# The profiler now and then hands back a trace with no device event at all
# (seen once on an H100, for one short call whose output was checked). Such a
# trace says nothing of the call, so it is taken again, up to this many times;
# a trace that holds any device event is the answer.
TRACE_ATTEMPTS = 3


def kernels_of_one_call(fn) -> tuple[list, int]:
    """Names of the kernels, copies and memsets that one fn() puts on the
    card, as the profiler's device trace lists them, and the number of
    traces it took to get a trace with a device event of fn() in it. A
    trace can miss its first device events, the only kernel of one short
    call among them (utils/profiling.py), so `warm_up_cuda_trace` runs first
    in each, and its spin kernels are left out of the names."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            warm_up_cuda_trace()
            fn()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages() if ev.device_type.name == "CUDA"
                 and WARMUP_KERNEL not in ev.key for _ in range(ev.count)]
        if names:
            break
    return names, attempt


def time_bn_sums(x: torch.Tensor) -> dict:
    """Kernel, plain version and the one-call library yardstick, forward and
    backward, on x (larger than the L2 cache at the main path's top shape):
    `*_ms` is the time of a call made from Python one after the other,
    `*_card_ms` the time on the card."""
    m, c = x.shape
    dsum = torch.randn(c, device=DEVICE)
    dsq = torch.randn(c, device=DEVICE)
    runs = {
        "fwd": lambda: bn_mod._launch_forward(x),
        "fwd_plain": lambda: bn_sums_reference(x),
        "fwd_library": lambda: torch.var_mean(x, dim=0, correction=0),
        "bwd": lambda: bn_mod._launch_backward(x, dsum, dsq),
        "bwd_plain": lambda: bn_sums_backward_reference(x, dsum, dsq),
        "bwd_library": lambda: torch.addcmul(dsum.to(x.dtype), x, (2 * dsq).to(x.dtype)),
    }
    out = {"fwd_bound_ms": bn_bound_ms(m, c, x.element_size(), False),
           "bwd_bound_ms": bn_bound_ms(m, c, x.element_size(), True)}
    for name, fn in runs.items():
        repeats = 5 if name.endswith("plain") else 20
        out[f"{name}_ms"] = cuda_ms(fn, repeats)
        out[f"{name}_card_ms"] = card_ms(fn, repeats)
    return out


# the main path's extreme shapes at batch 64 / 15-way / 416 px and a middle
# one, then awkward ones: (50000, 48) and (777, 24) have C between V and 32*V
# (vector path, a warp's lanes not all used), the others C % V != 0 in one or
# both types (scalar path)
BN_MAIN_SHAPES = [(64 * 416 * 416, 32), (64 * 13 * 13, 1024), (15 * 6 * 6, 1024),
                  (64 * 52 * 52, 256)]
BN_AWKWARD_SHAPES = [(1, 1), (1000003, 30), (7, 1280), (4099, 3), (50000, 48), (777, 24),
                     (3, 36)]


def phase_bn_kernels(seed: int) -> dict:
    """Returns what the kernels line needs: the worst errors and the times at
    the main path's shapes."""
    cases, times = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (m, c) in enumerate(BN_MAIN_SHAPES + BN_AWKWARD_SHAPES):
            x = make_activation(seed + i, m, c, dtype)
            res = compare_bn_sums(x, seed + i)
            check(res["layout_copies"] == 0, "a contiguous input was copied")
            if (m, c) in ((64 * 13 * 13, 1024), (4099, 3)):  # one kernel a call, either path
                names, traces = kernels_of_one_call(lambda: bn_mod._launch_forward(x))
                check(len(names) == 1 and f"bn_sums_{res['path'][:3]}" in names[0],
                      f"one {res['path']} forward at {(m, c)} {name} put {names} on the card"
                      f" ({traces} traces)")
                res["kernels_of_a_call"] = names
                res["traces_taken"] = traces
            if (m, c) in BN_MAIN_SHAPES:  # the smaller two fit the L2 cache, as behind a conv
                times.setdefault(name, {})[f"{m}x{c}"] = time_bn_sums(x)
            cases.append(res)
            del x
        # C % V == 0 but the base is one element past a 16-byte boundary:
        # contiguous, no copy, and the scalar path
        flat = make_activation(seed + 99, 1, 20000 * 64 + 1, dtype).reshape(-1)
        res = compare_bn_sums(flat[1:].view(20000, 64), seed + 99)
        check(res["path"] == "scalar" and res["layout_copies"] == 0 and not res["aligned16"],
              f"the misaligned case ran {res}")
        cases.append(res)
        # a view that is not row-major: the wrapper copies it, and counts it
        wide = make_activation(seed + 100, 3001, 96, dtype)
        res = compare_bn_sums(wide[:, 16:80], seed + 100)
        check(res["layout_copies"] == 2 and not res["contiguous"],
              f"the non-contiguous view cost {res['layout_copies']} counted copies, not 2")
        cases.append(res)
        # a 4-D NHWC activation, through autograd: d/dx of sum(a*s) + sum(b*q)
        x4 = make_activation(seed + 101, 2 * 13 * 13, 64, dtype).reshape(2, 13, 13, 64)
        x4.requires_grad_(True)
        a, b = torch.randn(64, device=DEVICE), torch.randn(64, device=DEVICE)
        s, q = bn_sums(x4)
        (dx,) = torch.autograd.grad((a * s).sum() + (b * q).sum(), x4)
        want = bn_sums_backward_reference(x4.detach(), a, b)
        check(torch.equal(dx, want), "bn_sums through autograd differs from the plain backward")
    for want in ("vector", "scalar"):
        check(any(c["path"] == want for c in cases), f"no case reached the {want} path")
    check(all(c["path"] == "vector" for c in cases if tuple(c["shape"]) in BN_MAIN_SHAPES),
          "a main shape did not take the vector path")
    emit("kernels", name="bn_sums", tolerance_over_sum_abs=SUM_TOL, cases=cases, times=times)
    return {"cases": cases, "times": times}


# ---------------------------------------------------------------------------
# bn_act: the epilogue kernels against their plain versions
# ---------------------------------------------------------------------------

# timed: the bench step's first BN (batch 384, bfloat16 only: the plain
# backward of a float32 one outgrows the card) and the batch-64 cells' 13 x 13
# layers; then shapes with C between V and 8 V (a warp's lanes not all used)
# or C % V != 0 (the scalar path)
BN_ACT_TIMED = {"bfloat16": [(384 * 416 * 416, 32), (64 * 13 * 13, 1024)],
                "float32": [(64 * 13 * 13, 1024)]}
BN_ACT_AWKWARD = [(50000, 48), (777, 24), (1000003, 30), (4099, 3), (7, 1280), (1, 1)]


def bn_act_bound_ms(m: int, c: int, itemsize: int, backward: bool) -> float:
    """Bytes moved once over the memory rate: the forward reads y and writes
    out, the backward reads dout and y and writes dy; both read the pair and
    the backward writes its gradients (2 or 4 x C floats). A few operations
    a value, far below the float32 rate, so bytes bind."""
    nbytes = m * c * itemsize * (3 if backward else 2) + (4 if backward else 2) * c * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3


def make_epilogue_inputs(seed: int, m: int, c: int, dtype):
    """(y, inv, bias, dout) on the card from the seed: y like a conv output,
    the float32 pair as BN gives it, an upstream gradient."""
    y = make_activation(seed, m, c, dtype)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    dout = torch.randn((m, c), generator=g, device=DEVICE).to(dtype)
    inv = torch.rand(c, generator=g, device=DEVICE) + 0.5
    bias = torch.randn(c, generator=g, device=DEVICE)
    return y, inv, bias, dout


def dtype_ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of `dtype` at |x|."""
    e = torch.floor(torch.log2(x.abs().clamp(min=torch.finfo(dtype).tiny)))
    return torch.finfo(dtype).eps * torch.exp2(e)


def epilogue_term_magnitudes(y, inv, bias, dout, activation):
    """Per channel, the sums of |g * y| and |g| that dinv and dbias add up."""
    c = y.shape[-1]
    g = act_mod.grad_at_z(dout, y, inv, bias, activation)
    gy = (g * y).float().abs().reshape(-1, c).sum(0)
    return gy, g.float().abs().reshape(-1, c).sum(0)


def compare_bn_act(y, inv, bias, dout, activation: str) -> dict:
    """Kernel and plain version on one input, each way: out and dy
    bit-equal to the plain version's, dinv and dbias within one unit of y's
    type (or SUM_TOL of their terms' magnitudes where a channel's sum
    cancels: two float32 orders), two launches bit-equal. Raises on any
    failure."""
    shape, dt = tuple(y.shape), str(y.dtype).split(".")[-1]
    code = act_mod.activation_code(activation)
    out = act_mod._launch_forward(y, inv, bias, code)
    fwd_path = bn_act.last_path
    check(torch.equal(out, act_mod._launch_forward(y, inv, bias, code)),
          f"bn_act: two forward launches differ at {shape} {dt}")
    check(torch.equal(out, bn_act_reference(y, inv, bias, activation)),
          f"bn_act forward differs from the plain version at {shape} {dt} {activation}")
    del out
    got = act_mod._launch_backward(dout, y, inv, bias, code)
    bwd_path = bn_act.last_backward_path
    again = act_mod._launch_backward(dout, y, inv, bias, code)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"bn_act: two backward launches differ at {shape} {dt}")
    del again
    want = bn_act_backward_reference(dout, y, inv, bias, activation)
    check(torch.equal(got[0], want[0]),
          f"bn_act backward's dy differs from the plain version at {shape} {dt} {activation}")
    mags = epilogue_term_magnitudes(y, inv, bias, dout, activation)
    res = {"shape": list(shape), "dtype": dt, "activation": activation,
           "paths": [fwd_path, bwd_path], "aligned16": act_mod._address(y, dout) % 16 == 0}
    for name, k, p, mag in (("dinv", got[1], want[1], mags[0]), ("dbias", got[2], want[2], mags[1])):
        ulp = torch.maximum(dtype_ulp(k, y.dtype), dtype_ulp(p, y.dtype))
        err = (k - p).abs()
        check(bool((err <= torch.maximum(ulp, SUM_TOL * mag)).all()),
              f"bn_act {name} off by {float(err.max())} at {shape} {dt} {activation}")
        res[f"{name}_max_err_ulps"] = float((err / ulp).max())
        res[f"{name}_channels_past_one_ulp"] = int((err > ulp).sum())
    return res


def time_bn_act(y, inv, bias, dout) -> dict:
    """Kernels and plain versions, forward and backward (leaky): `*_ms` per
    call made from Python one after the other, `*_card_ms` on the card
    alone, beside the byte bound. No single PyTorch call computes either
    way, so there is no library yardstick."""
    m, c = y.shape
    runs = {
        "fwd": lambda: act_mod._launch_forward(y, inv, bias, 0),
        "fwd_plain": lambda: bn_act_reference(y, inv, bias, "leaky"),
        "bwd": lambda: act_mod._launch_backward(dout, y, inv, bias, 0),
        "bwd_plain": lambda: bn_act_backward_reference(dout, y, inv, bias, "leaky"),
    }
    out = {"fwd_bound_ms": bn_act_bound_ms(m, c, y.element_size(), False),
           "bwd_bound_ms": bn_act_bound_ms(m, c, y.element_size(), True)}
    for name, fn in runs.items():
        repeats = 5 if name.endswith("plain") else 20
        out[f"{name}_ms"] = cuda_ms(fn, repeats)
        out[f"{name}_card_ms"] = card_ms(fn, repeats)
    for way in ("fwd", "bwd"):
        out[f"{way}_share_of_bound"] = out[f"{way}_bound_ms"] / out[f"{way}_card_ms"]
    return out


def check_bn_act_streams(y, inv, bias, dout) -> None:
    """The backward's table of partials and its tickets are reused from call
    to call: launches back to back on one stream, then on a second stream
    while the first is still busy, must give the bits of the first."""
    global SIDE_STREAM
    if SIDE_STREAM is None:
        SIDE_STREAM = torch.cuda.Stream()
    first = act_mod._launch_backward(dout, y, inv, bias, 0)
    outs = [act_mod._launch_backward(dout, y, inv, bias, 0) for _ in range(4)]
    SIDE_STREAM.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(SIDE_STREAM):
        side = [act_mod._launch_backward(dout, y, inv, bias, 0) for _ in range(4)]
    outs += [act_mod._launch_backward(dout, y, inv, bias, 0) for _ in range(4)]
    torch.cuda.synchronize()
    for tag, group in (("back to back", outs), ("on a second stream", side)):
        check(all(all(torch.equal(a, b) for a, b in zip(got, first)) for got in group),
              f"bn_act: backward launches {tag} differ at {tuple(y.shape)} {y.dtype}")


def phase_bn_act_kernels(seed: int) -> dict:
    """Returns the compared cases and the times at the timed shapes."""
    cases, times, calls = [], {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (m, c) in enumerate(BN_ACT_TIMED[name] + BN_ACT_AWKWARD):
            y, inv, bias, dout = make_epilogue_inputs(seed + 200 + i, m, c, dtype)
            timed = (m, c) in BN_ACT_TIMED[name]
            for activation in (("leaky",) if m * c > 1 << 28 else ("leaky", "relu", "linear")):
                cases.append(compare_bn_act(y, inv, bias, dout, activation))
            if timed:
                times.setdefault(name, {})[f"{m}x{c}"] = time_bn_act(y, inv, bias, dout)
            if (m, c) in ((64 * 13 * 13, 1024), (4099, 3)):  # one kernel a call, each way, either path
                for way, fn in (("fwd", lambda: act_mod._launch_forward(y, inv, bias, 0)),
                                ("bwd", lambda: act_mod._launch_backward(dout, y, inv, bias, 0))):
                    names, traces = kernels_of_one_call(fn)
                    check(len(names) == 1 and f"bn_act_elementwise_{way}" in names[0],
                          f"one {way} at {(m, c)} {name} put {names} on the card ({traces} traces)")
                    calls[f"{way}_{m}x{c}_{name}"] = names
            if (m, c) in ((64 * 13 * 13, 1024), (1000003, 30)):
                check_bn_act_streams(y, inv, bias, dout)
            del y, dout
            torch.cuda.empty_cache()
        # C % V == 0 but the base one element past a 16-byte boundary: the scalar path
        y, inv, bias, dout = make_epilogue_inputs(seed + 299, 20000 * 64 + 1, 1, dtype)
        inv, bias = inv.expand(64).contiguous(), bias.expand(64).contiguous()
        res = compare_bn_act(y.reshape(-1)[1:].view(20000, 64), inv, bias,
                             dout.reshape(-1)[1:].view(20000, 64), "leaky")
        check(res["paths"] == ["scalar", "scalar"] and not res["aligned16"],
              f"the misaligned case ran {res}")
        cases.append(res)
        # a view that is not row-major, through the function: copied and counted
        y, inv, bias, _ = make_epilogue_inputs(seed + 298, 3001, 96, dtype)
        copies = bn_act.layout_copies
        out = bn_act(y[:, 16:80], inv[16:80], bias[16:80], "leaky")
        check(bn_act.layout_copies == copies + 1
              and torch.equal(out, bn_act_reference(y[:, 16:80], inv[16:80], bias[16:80], "leaky")),
              "a non-contiguous view through bn_act")
    for want in ("vector", "scalar"):
        check(any(c["paths"] == [want, want] for c in cases), f"no case reached the {want} path")
    emit("kernels", name="bn_act", tolerance_over_sum_abs=SUM_TOL, cases=cases, times=times,
         kernels_of_a_call=calls)
    return {"cases": cases, "times": times}


# ---------------------------------------------------------------------------
# maxpool2x2: the pool kernels against F.max_pool2d and their plain versions
# ---------------------------------------------------------------------------

# timed: the bench step's first pool (bfloat16) and the learnet's last, whose
# odd side drops a row and a column; then both paths in every type (C = 12 is
# no multiple of 8, C = 3 of 4) and a base one element past 16 bytes
POOL_TIMED = [(384, 416, 416, 32), (15, 13, 13, 1024)]
POOL_SHAPES = [(64, 104, 104, 128), (15, 13, 13, 1024), (8, 27, 31, 64), (4, 52, 52, 12),
               (3, 9, 7, 3)]


def pool_bound_ms(shape, itemsize: int) -> float:
    """Least bytes a way over the memory rate: the forward reads x and
    writes y, the backward reads dy and writes dx (T + T/4 each, T the
    input's bytes, floor sides)."""
    b, h, w, c = shape
    return (b * h * w * c + b * (h // 2) * (w // 2) * c) * itemsize / PEAK_BYTES_PER_S * 1e3


def pool_library(x: torch.Tensor):
    """`F.max_pool2d` of the channels-last view with its int64 indices: the
    forward the port ran before, and a closure of its backward's one call."""
    view = x.permute(0, 3, 1, 2)
    y, idx = F.max_pool2d(view, 2, 2, return_indices=True)
    return y, lambda dy: torch.ops.aten.max_pool2d_with_indices_backward(
        dy, view, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)


def compare_pool(x: torch.Tensor, dy: torch.Tensor) -> dict:
    """Kernel against `F.max_pool2d` and the plain version on one input:
    values and gradient bit for bit (NaN where NaN). Raises on a failure."""
    shape, dt = tuple(x.shape), str(x.dtype).split(".")[-1]
    xg = x.detach().requires_grad_(True)  # the same memory: a misaligned view stays so
    y = maxpool2x2(xg)
    (dx,) = torch.autograd.grad(y, xg, dy)
    paths = [maxpool2x2.last_path, maxpool2x2.last_backward_path]
    xl = x.detach().requires_grad_(True)
    yl = F.max_pool2d(xl.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    (dxl,) = torch.autograd.grad(yl, xl, dy)
    ref_y, code = maxpool2x2_reference(x)
    ref_dx = maxpool2x2_backward_reference(dy, code, x.shape[1], x.shape[2])
    bits = torch.int32 if x.dtype == torch.float32 else torch.int16
    for what, got, want in (("values", y, yl), ("gradient", dx, dxl), ("plain values", y, ref_y),
                            ("plain gradient", dx, ref_dx)):
        # NaN where NaN, the same bits elsewhere (+0 and -0 told apart)
        nan, want = torch.isnan(got), want.contiguous()
        same = torch.equal(nan, torch.isnan(want)) and torch.equal(
            got.view(bits).masked_fill(nan, 0), want.view(bits).masked_fill(nan, 0))
        check(same, f"maxpool2x2 {what} differ from F.max_pool2d's at {shape} {dt}")
        del nan, want
    return {"shape": list(shape), "dtype": dt, "paths": paths, "nans": int(torch.isnan(x).sum())}


def time_pool(x: torch.Tensor, dy: torch.Tensor) -> dict:
    """Kernels, plain versions and the library's pair, each way: `*_ms` per
    call made from Python one after the other, `*_card_ms` on the card."""
    _, code = pool_mod._launch_forward(x, True)
    h, w = x.shape[1], x.shape[2]
    _, lib_bwd = pool_library(x)
    dyl = dy.permute(0, 3, 1, 2)
    runs = {
        "fwd": lambda: pool_mod._launch_forward(x, True),
        "fwd_plain": lambda: maxpool2x2_reference(x),
        "fwd_library": lambda: pool_library(x),
        "bwd": lambda: pool_mod._launch_backward(dy, code, h, w),
        "bwd_plain": lambda: maxpool2x2_backward_reference(dy, code, h, w),
        "bwd_library": lambda: lib_bwd(dyl),
    }
    bound = pool_bound_ms(tuple(x.shape), x.element_size())
    out = {"fwd_bound_ms": bound, "bwd_bound_ms": bound}
    for name, fn in runs.items():
        repeats = 5 if name.endswith("plain") else 20
        out[f"{name}_ms"] = cuda_ms(fn, repeats)
        out[f"{name}_card_ms"] = card_ms(fn, repeats)
        torch.cuda.empty_cache()
    for way in ("fwd", "bwd"):
        out[f"{way}_share_of_bound"] = out[f"{way}_bound_ms"] / out[f"{way}_card_ms"]
    return out


def phase_pool_kernels(seed: int) -> dict:
    """Returns the compared cases and the times at the timed shapes."""
    cases, times, calls = [], {}, {}
    g = torch.Generator(device=DEVICE).manual_seed(seed + 400)
    for shape in POOL_TIMED:
        b, h, w, c = shape
        x = torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
        dy = torch.randn((b, h // 2, w // 2, c), generator=g, device=DEVICE).to(torch.bfloat16)
        cases.append(compare_pool(x, dy))
        times["x".join(map(str, shape))] = time_pool(x, dy)
        del x, dy
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for i, shape in enumerate(POOL_SHAPES):
            b, h, w, c = shape
            x = torch.randn(shape, generator=g, device=DEVICE)
            x[torch.rand(shape, generator=g, device=DEVICE) < 0.01] = float("nan")
            x = torch.where(torch.rand(shape, generator=g, device=DEVICE) < 0.2, x.round(), x)
            x, dy = x.to(dtype), torch.randn((b, h // 2, w // 2, c), generator=g,
                                             device=DEVICE).to(dtype)
            cases.append(compare_pool(x, dy))
            if i == 0:  # one kernel a call, each way
                _, code = pool_mod._launch_forward(x, True)
                for way, fn in (("fwd", lambda: pool_mod._launch_forward(x, True)),
                                ("bwd", lambda: pool_mod._launch_backward(dy, code, h, w))):
                    names, traces = kernels_of_one_call(fn)
                    check(len(names) == 1 and f"maxpool2x2_{way}" in names[0],
                          f"one {way} at {shape} put {names} on the card ({traces} traces)")
                    calls[f"{way}_{'x'.join(map(str, shape))}_{dtype}"] = names
        flat = torch.randn(2 * 9 * 11 * 32 + 1, generator=g, device=DEVICE).to(dtype)
        x = flat[1:].view(2, 9, 11, 32)
        res = compare_pool(x, torch.randn((2, 4, 5, 32), generator=g, device=DEVICE).to(dtype))
        check(res["paths"][0] == "scalar", f"the misaligned case ran {res}")
        cases.append(res)
    for want in ("vector", "scalar"):
        check(any(c["paths"] == [want, want] for c in cases), f"no case reached the {want} path")
    emit("kernels", name="maxpool2x2", cases=cases, times=times, kernels_of_a_call=calls)
    return {"cases": cases, "times": times}


def sweep(run, n_images: int, classes, outdir: str, tag: str, top_k: int) -> dict:
    """One sweep of the main path: `run(prefix, stats)` is valid._meta_sweep
    or valid._plain_sweep over n_images. The kernel's launch count is set to
    0 just before and read just after, so it holds the sweep's own launches
    and none of the comparisons'."""
    stats: dict = {}
    torch.cuda.synchronize()
    nms_rows.launches = 0  # the count is read right after the sweep, below
    t0 = time.perf_counter()
    prefix = run(os.path.join(outdir, tag), stats)
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
    check(stats["batches"] == n_images // BATCH, "sweep saw another number of batches")
    # a batch whose rows overflow the candidate buffer goes to the host path
    # by protocol and launches nothing; every other batch is one launch
    check(launches == stats["device_batches"],
          f"{launches} kernel launches for {stats['device_batches']} device batches")
    check((stats["device_batches"] == stats["batches"]) == (stats["max_candidates"] <= top_k),
          f"{stats['device_batches']} of {stats['batches']} batches on the device with "
          f"{stats['max_candidates']} candidates in a row and a buffer of {top_k}")
    check(sum(lines.values()) > 0, "every result file is empty")
    return {"batches": stats["batches"],
            "device_batches": stats["device_batches"], "nms_launches": launches,
            "max_candidates_per_row": stats["max_candidates"], "top_k": top_k,
            "images": n_images, "seconds": seconds,
            "images_per_s": n_images / seconds,
            "result_rows": sum(lines.values()),
            "non_empty_files": sum(1 for v in lines.values() if v)}


def one_batch(forward, pipe, host_boxes, shape: tuple) -> tuple[dict, tuple]:
    """One sweep batch of either head: `pipe.eval_boxes` against the host
    path (`host_boxes(output)`: host decode + nms) box for box, then
    milliseconds per stage. The plain head's boxes hold (cls_conf, cls_id)
    pairs from box[5] on, compared in full; the meta head's box[6] is the
    class copy's position, which the host path does not hold, so its boxes
    are compared up to box[5]. Returns (report, (bsel, dsel) of that batch)."""
    output = forward()
    check(tuple(output.shape) == shape, f"head output {tuple(output.shape)}")
    check(bool(torch.isfinite(output).all()), "head output is not finite")
    dev = pipe.eval_boxes(output)
    check(dev is not None, "the candidate buffer overflowed on the parity batch")
    host = host_boxes(output)
    pairs = pipe.n_cls is None
    n_boxes, n_pairs, worst = 0, 0, 0.0
    for r, (d, h) in enumerate(zip(dev, host)):
        check(len(d) == len(h), f"row {r}: device kept {len(d)} boxes, host {len(h)}")
        for db, hb in zip(d, h):
            if pairs:
                check(len(db) == len(hb) and db[6::2] == [int(v) for v in hb[6::2]],
                      f"row {r}: class pairs {db[6::2]} against {hb[6::2]}")
                n_pairs += (len(db) - 5) // 2
            n = len(db) if pairs else 6
            worst = max(worst, float(np.max(np.abs(np.asarray(db[:n]) - np.asarray(hb[:n], float)))))
            n_boxes += 1
    check(n_boxes > 0, "the parity batch kept no box at all")
    # float32 values taken from the same tensors on both paths
    check(worst <= 1e-6, f"device and host boxes differ by {worst}")

    # the stages as `eval_boxes` composes them
    bsel, dsel, cconf, cid, _, csel = pipe._ranked(output)
    rows, keep = _nms_and_rows(bsel, dsel, cconf, cid, pipe.nms_thresh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        _rows_to_eval_boxes(rows, keep, csel, pipe.conf_thresh)
    tail_ms = (time.perf_counter() - t0) / 3 * 1e3
    stages = {
        "detect_ms": cuda_ms(forward, 5),
        "decode_rank_ms": cuda_ms(lambda: pipe._ranked(output), 10),
        "nms_ms": cuda_ms(lambda: nms_rows(bsel, dsel, pipe.nms_thresh), 50),
        "nms_card_ms": card_ms(lambda: nms_rows(bsel, dsel, pipe.nms_thresh), 50),
        "d2h_and_lists_ms": tail_ms,
    }
    report = {"parity_boxes": n_boxes, "parity_max_abs_diff": worst, **stages}
    if pairs:
        report["parity_class_pairs"] = n_pairs
    return report, (bsel, dsel)


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
            one, rows = one_batch(
                lambda codes=dev_codes: m.detect(images[:BATCH], codes),
                valid._device_pipe(m.region, n_cls),
                functools.partial(valid.meta_host_boxes, m.region, n_cls=n_cls),
                (BATCH * n_cls, 13, 13, 30))
            report["one_batch"].append({"n_cls": n_cls, **one})
            run = (lambda prefix, stats, codes=dev_codes, n_cls=n_cls, classes=classes:
                   valid._meta_sweep(m, detset, prefix, "comp4_det_test_", lambda: codes,
                                     n_cls, classes, BATCH, stats=stats))
            report["sweeps"].append({"n_cls": n_cls, **sweep(
                run, len(detset.lines), classes, outdir, f"{name}_{n_cls}", TOP_K)})
            check(report["sweeps"][-1]["nms_launches"] > 0, "a meta sweep launched no kernel")
            main_launches += report["sweeps"][-1]["nms_launches"]
            if captured is None:
                captured = rows
        emit("serve", **report)
        if dtype == torch.float32:
            phase_traffic(m, codes, np.random.default_rng(seed + 1))
    return {"rows": captured, "launches": main_launches}


# ---------------------------------------------------------------------------
# train: the episodic meta-training step at full width
# ---------------------------------------------------------------------------


def make_episode(seed: int, batch_size: int, n_cls: int, size: int, dtype_name: str,
                 groups: int = 1, neg_ratio=TRAIN_NEG_RATIO) -> dict:
    """One episode painted from the seed, through the CLI's own batch maker:
    `batch_size` detection images whose first rectangle is the object of
    class i % n_cls, split into `groups` replica groups, and one support
    image + box mask per class and group. The
    backgrounds are noisy: on flat ones most channels of the trained
    checkpoint are nearly constant, their variance is the small difference
    of two large numbers, and gradients then follow the last bit of the
    sums rather than the data."""
    rng = np.random.default_rng(seed)
    imgs, first = paint_images(rng, batch_size, size, "noise")
    labels = np.zeros((batch_size, n_cls, 50, 5), np.float32)
    for i, box in enumerate(first):
        labels[i, i % n_cls, 0] = (i % n_cls, *box)
    supports = [make_support_set(rng, range(n_cls), 1, size, "noise") for _ in range(groups)]
    return make_episode_batch(
        imgs, labels.reshape(batch_size, n_cls, 250),
        np.concatenate([sup.metax for sup in supports]),
        np.concatenate([sup.masks for sup in supports]), groups,
        neg_ratio, np.random.RandomState(seed), dtype=dtype_name)


def load_train_state(spec):
    """(parameter tree on the card with gradients required, header)."""
    init = init_meta_params(spec, 0)
    (dp, lp), header = load_weights_bf16_gz(
        WEIGHTS, [spec.darknet, spec.learnet], [init["darknet"], init["learnet"]])
    params = require_grads({"darknet": from_jax_params(spec.darknet, dp, DEVICE),
                            "learnet": from_jax_params(spec.learnet, lp, DEVICE)})
    return params, header


META_PICKS = {"darknet0.w": ("darknet", 0, "w"), "darknet0.gamma": ("darknet", 0, "bn", "gamma"),
              "darknet29.w": ("darknet", 29, "w"), "darknet29.beta": ("darknet", 29, "bn", "beta"),
              "head.w": ("darknet", 31, "w"), "learnet0.w": ("learnet", 0, "w"),
              "learnet12.w": ("learnet", 12, "w")}


def grad_norms(grads, picks: dict) -> dict:
    """L2 norms of a few gradient leaves (`picks`: name -> path) and of the
    whole tree."""
    leaves = dict(tree_leaves_with_path(grads))
    out = {k: float(leaves[p].float().norm()) for k, p in picks.items()}
    out["all"] = float(torch.sqrt(sum(g.float().square().sum() for g in leaves.values())))
    return out


def bn_stats_snapshot(params) -> dict:
    return {p: t.clone() for p, t in tree_leaves_with_path(params) if p[-1] in ("mean", "var")}


class KernelClock:
    """Times every bn_sums launch of a stretch of work with CUDA events, by
    standing in for the wrapper's two launch functions."""

    def __init__(self):
        self.events = []
        self.forward_shapes = []  # (M, C) of every forward launch, in order
        self._fwd, self._bwd = bn_mod._launch_forward, bn_mod._launch_backward

    def _timed(self, fn):
        def run(*args):
            if fn is self._fwd:
                c = args[0].shape[-1]
                self.forward_shapes.append((args[0].numel() // c, c))
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            self.events.append((a, b))
            return out
        return run

    def __enter__(self):
        bn_mod._launch_forward = self._timed(self._fwd)
        bn_mod._launch_backward = self._timed(self._bwd)
        return self

    def __exit__(self, *exc):
        bn_mod._launch_forward, bn_mod._launch_backward = self._fwd, self._bwd

    def total_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


class PathInputs:
    """What the kernels' wrappers are given while a path runs, recorded by
    standing in for the bn_sums and bn_act forward launches and for the NMS
    call of eval/device_pipeline.py, which add no launch of their own: every
    distinct bn_sums (M, C, dtype), every distinct bn_act (M, C, dtype,
    activation code), and a copy of the first (boxes, dsel) of each distinct
    nms_rows (R, K)."""

    def __init__(self):
        self.bn = set()
        self.act = set()
        self.nms = {}
        self._fwd, self._nms = bn_mod._launch_forward, device_pipeline.nms_rows
        self._act = act_mod._launch_forward

    def _record_fwd(self, x):
        c = x.shape[-1]
        self.bn.add((x.numel() // c, c, x.dtype))
        return self._fwd(x)

    def _record_act(self, y, inv, bias, code):
        c = y.shape[-1]
        self.act.add((y.numel() // c, c, y.dtype, code))
        return self._act(y, inv, bias, code)

    def _record_nms(self, boxes, dsel, thresh):
        if tuple(dsel.shape) not in self.nms:
            self.nms[tuple(dsel.shape)] = (boxes.clone(), dsel.clone())
        return self._nms(boxes, dsel, thresh)

    def __enter__(self):
        bn_mod._launch_forward = self._record_fwd
        act_mod._launch_forward = self._record_act
        device_pipeline.nms_rows = self._record_nms
        return self

    def __exit__(self, *exc):
        bn_mod._launch_forward, device_pipeline.nms_rows = self._fwd, self._nms
        act_mod._launch_forward = self._act


# the kernel counts a training path reports: bn_sums' launches each way and
# layout copies, and bn_act's launches each way
BN_KEYS = ("fwd", "bwd", "layout_copies", "act_fwd", "act_bwd", "pool_fwd", "pool_bwd")


def zero_bn_counts() -> None:
    """Set the launch and layout-copy counters of `bn_sums`, `bn_act` and
    `maxpool2x2` to 0."""
    for fn in (bn_sums, bn_act, maxpool2x2):
        fn.launches = fn.backward_launches = fn.layout_copies = 0


def bn_counts() -> dict:
    """The counters `zero_bn_counts` set to 0, under BN_KEYS."""
    return dict(zip(BN_KEYS, (bn_sums.launches, bn_sums.backward_launches,
                              bn_sums.layout_copies, bn_act.launches, bn_act.backward_launches,
                              maxpool2x2.launches, maxpool2x2.backward_launches)))


def add_counts(total: dict, got: dict) -> dict:
    """`total` with each of BN_KEYS that `got` holds added to it."""
    for k in BN_KEYS:
        if k in got:
            total[k] = total.get(k, 0) + got[k]
    return total


def check_bn_counts(what: str, counts: dict, n: int) -> None:
    """`n` launches of each: bn_sums forward and backward, bn_act forward and
    backward (every training BN launches each once a step each way)."""
    got = [counts[k] for k in ("fwd", "bwd", "act_fwd", "act_bwd")]
    check(got == [n] * 4, f"{what} launched {got} bn_sums forward, backward and bn_act "
                          f"forward, backward kernels, not {n} each")


def train_variant(tag: str, make_trainer, load_params, episodes, lr, seen0: int,
                  batch_size: int, bn_layers: int, picks: dict, dtype: torch.dtype) -> dict:
    """One training path (phase `tag`) in one dtype: `make_trainer()` builds its
    trainer, `load_params()` a fresh parameter tree on the card,
    `episodes` are its batches (2 warm-up + timed ones), `lr(i)` the rate of
    step i, `bn_layers` its BatchNorms, `picks` the gradient leaves to
    report. The first step's loss and gradient norms through the kernels,
    the plain versions (sums taken in float64); then the main path."""
    name = str(dtype).split(".")[-1]
    params = load_params()
    trainer = make_trainer()

    # -- the first step's loss and gradients: kernels, plain versions
    seen = seen0 + batch_size
    zero_bn_counts()
    loss_k, grads_k, _, _ = trainer.loss_and_grads(params, episodes[0], seen)
    torch.cuda.synchronize()
    check((bn_sums.launches, bn_sums.backward_launches) == (bn_layers, bn_layers),
          f"one step launched {bn_sums.launches} + {bn_sums.backward_launches} bn_sums kernels")
    check((bn_act.launches, bn_act.backward_launches) == (bn_layers, bn_layers),
          f"one step launched {bn_act.launches} + {bn_act.backward_launches} bn_act kernels")
    norms_k = grad_norms(grads_k, picks)
    del grads_k
    norms, loss = {"kernel": norms_k}, {"kernel": float(loss_k)}
    # the same step through the plain versions, whose sums are taken in
    # float64 and whose epilogue is the plain composition (differentiated by
    # autograd): the yardstick for how far two right float32 answers lie
    # apart at this depth
    layers.bn_sums, layers.bn_act = bn_sums_reference, bn_act_reference
    try:
        loss_v, grads_v, _, _ = trainer.loss_and_grads(params, episodes[0], seen)
    finally:
        layers.bn_sums, layers.bn_act = bn_sums, bn_act
    norms["plain"], loss["plain"] = grad_norms(grads_v, picks), float(loss_v)
    del grads_v
    check(bn_sums.launches == bn_layers and bn_act.launches == bn_layers,
          "a plain step launched a kernel")
    # Kernel and plain version add in another order, so a layer's statistics
    # differ in the last bit; every BN backward below amplifies that, most in
    # the first layers, whose parameter gradients are sums of millions of
    # cancelling terms. In bfloat16 a last-bit change of a statistic can move a
    # whole channel's scale by one rounding step (2^-8). So: the loss against
    # the plain version; each gradient norm of the kernels against the plain
    # version's (float64 sums) within the bound.
    tol = ({"loss": 1e-5, "all": 1e-4, "leaf": 1e-2} if dtype == torch.float32
           else {"loss": 2e-2, "all": 1e-1, "leaf": 2e-1})
    first_step = {"loss": loss, "grad_norms": norms, "rel_tolerance": tol}
    emit(f"{tag}_first_step", dtype=name, **first_step)
    check(np.isfinite(loss["kernel"])
          and abs(loss["kernel"] - loss["plain"]) <= tol["loss"] * abs(loss["plain"]),
          f"first step's loss {loss['kernel']} against {loss['plain']} through the plain version")
    for key, exact in norms["plain"].items():
        room = tol["all" if key == "all" else "leaf"] * exact
        check(abs(norms["kernel"][key] - exact) <= room,
              f"gradient norm {key}: {norms['kernel'][key]} against {exact} (float64 sums)")

    # -- the main path: warm-up and timed steps, counts read right after
    before = bn_stats_snapshot(params)
    mom = init_momentum(params)
    lines, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_bn_counts()
    seen = seen0
    for i, ep in enumerate(episodes):
        if i == TRAIN_WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        seen += batch_size
        params, mom, metrics = trainer.step(params, mom, ep, seen=seen, lr=lr(i))
        lines.append(format_loss_line(seen, metrics))  # the step's one host sync
        losses.append(float(lines[-1].rsplit(" ", 1)[-1]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, act_copies = bn_counts(), bn_act.layout_copies
    peak = torch.cuda.max_memory_allocated()
    steps = len(episodes)
    timed = steps - TRAIN_WARMUP_STEPS
    check_bn_counts(f"{steps} {tag} {name} steps", counts, bn_layers * steps)
    check(all(np.isfinite(losses)), f"losses {losses}")
    after = bn_stats_snapshot(params)
    check(len(before) == 2 * bn_layers, f"{len(before)} running-statistics leaves")
    still = [p for p in before if torch.equal(before[p], after[p])]
    check(not still, f"running statistics did not move: {still}")
    check(all(bool(torch.isfinite(t).all()) for _, t in tree_leaves_with_path(params)),
          "a parameter is not finite after the steps")

    # -- one more step with every bn_sums launch timed (not counted above)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with KernelClock() as clock:
        a.record()
        trainer.step(params, mom, episodes[-1], seen=seen + batch_size, lr=lr(steps))
        b.record()
        torch.cuda.synchronize()
    step_ms, kernels_ms = a.elapsed_time(b), clock.total_ms()
    check(len(clock.events) == 2 * bn_layers, f"{len(clock.events)} timed launches in one step")

    return {"dtype": name, "batch": batch_size, "size": 416, "groups": 1,
            "seen_start": seen0, "lr_first_step": lr(0), "weight_decay": trainer.weight_decay,
            "momentum": trainer.momentum, "first_step": first_step,
            "steps": steps, "timed_steps": timed, "losses": losses,
            "first_line": lines[0], "last_line": lines[-1],
            "bn_counts": counts,
            "launches_per_step": [counts["fwd"] // steps, counts["bwd"] // steps],
            "bn_act_launches_per_step": [counts["act_fwd"] // steps, counts["act_bwd"] // steps],
            "bn_act_layout_copies": act_copies, "bn_stats_moved": len(before),
            "peak_memory_bytes": peak, "seconds_timed": seconds,
            "images_per_s": timed * batch_size / seconds,
            "step_ms_events": step_ms, "bn_kernels_ms_in_step": kernels_ms,
            "bn_kernels_share": kernels_ms / step_ms, "bn_layer_shapes": clock.forward_shapes}


def timed_steps(trainer, load_params, episodes, lr, seen0: int, batch_size: int,
                bn_layers: int) -> dict:
    """TRAIN_WARMUP_STEPS + timed steps from fresh parameters: images/s of
    the timed ones, peak memory, and the bn_sums and bn_act launches, which
    must be `bn_layers` forward and backward a step."""
    params = load_params()
    mom = init_momentum(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_bn_counts()
    seen = seen0
    losses = []
    for i, ep in enumerate(episodes):
        if i == TRAIN_WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        seen += batch_size
        params, mom, metrics = trainer.step(params, mom, ep, seen=seen, lr=lr(i))
        losses.append(float(metrics["loss"]))  # the step's one host sync, as in the main path
        if i == 0:
            first = {k: float(metrics[k]) for k in ("nGT", "loss_cls")}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = len(episodes)
    counts = bn_counts()
    check_bn_counts(f"{steps} timed steps", counts, bn_layers * steps)
    check(all(np.isfinite(losses)), f"losses {losses}")
    return {"images_per_s": (steps - TRAIN_WARMUP_STEPS) * batch_size / seconds,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_step": [counts["fwd"] // steps, counts["bwd"] // steps],
            **counts, "losses": losses, "first_step": first}


# The s2d stem against the plain one in float32 (TF32 off), one step from
# the same parameters and episode, held as the first-step check holds two
# float32 answers (the kernel against the plain version): the loss within
# 1e-5, and the norm of each leaf's update and of the whole tree's within
# twice the first-step bounds (2e-2 and 2e-4). The update VECTORS are
# reported, not held: first-layer gradients are sums of millions of
# cancelling terms, and two right float32 orders move them by percents (on
# the H100 at batch 64: 1.5% in the first BN's beta, 1.1e-3 over the whole
# tree); beside
# them, the same gaps between the plain stem through the kernel and through
# the plain `bn_sums`, two other right float32 answers.
S2D_TOL = {"loss": 1e-5, "all": 1e-4, "leaf": 1e-2}


def s2d_variants(tag: str, make_trainer, load_params, make_episodes, lr, seen0: int,
                 batch_size: int, bn_layers: int) -> dict:
    """The space-to-depth stem (`s2d=True`) of training path `tag` against
    its plain stem: one float32 step each way compared, then images/s and
    peak memory of both stems in both types. `make_trainer(dtype, **kw)`
    builds the trainer, `make_episodes(dtype_name)` the batches. Returns the
    bn_sums and bn_act launches of the s2d runs."""
    report, total = {}, {}
    ep = make_episodes("float32")[0]
    deltas, losses = {}, {}
    for way in ("plain_stem", "s2d", "plain_stem_plain_sums"):
        params = load_params()
        start = {p: t.detach().clone() for p, t in tree_leaves_with_path(params)}
        zero_bn_counts()
        if way == "plain_stem_plain_sums":
            layers.bn_sums = bn_sums_reference
        try:
            _, _, metrics = make_trainer(torch.float32, s2d=way == "s2d").step(
                params, init_momentum(params), ep, seen=seen0 + batch_size, lr=lr(0))
        finally:
            layers.bn_sums = bn_sums
        losses[way] = float(metrics["loss"])
        want = (0, 0) if way == "plain_stem_plain_sums" else (bn_layers, bn_layers)
        check((bn_sums.launches, bn_sums.backward_launches) == want,
              f"a {way} step launched {bn_sums.launches} + {bn_sums.backward_launches}")
        if way == "s2d":
            counts = bn_counts()
            check_bn_counts("an s2d step", counts, bn_layers)
            add_counts(total, counts)
        deltas[way] = {p: (t.detach() - start[p]).double() for p, t in tree_leaves_with_path(params)}
        del params, start
    base = deltas["plain_stem"]
    gaps, norms = {}, {}
    for way in ("s2d", "plain_stem_plain_sums"):
        worst, gap2, norm2 = 0.0, 0.0, 0.0
        for p, d in base.items():
            gap, size = float((deltas[way][p] - d).norm()), float(d.norm())
            gap2, norm2 = gap2 + gap * gap, norm2 + size * size
            worst = max(worst, gap / size if size else 0.0)
        gaps[way] = {"whole_tree": (gap2 / norm2) ** 0.5, "worst_leaf": worst}
    for way in ("plain_stem", "s2d"):
        leaf = {p: float(d.norm()) for p, d in deltas[way].items()}
        norms[way] = {"leaves": leaf, "all": sum(v * v for v in leaf.values()) ** 0.5}
    worst_norm = max(abs(norms["s2d"]["leaves"][p] - v) / v
                     for p, v in norms["plain_stem"]["leaves"].items() if v)
    rel_all = abs(norms["s2d"]["all"] - norms["plain_stem"]["all"]) / norms["plain_stem"]["all"]
    emit(f"{tag}_s2d_float32_step", losses=losses, update_norm_rel_whole_tree=rel_all,
         update_norm_rel_worst_leaf=worst_norm, update_vector_rel_gap=gaps, leaves=len(base),
         rel_tolerance=S2D_TOL)
    check(np.isfinite(losses["s2d"]) and abs(losses["s2d"] - losses["plain_stem"])
          <= S2D_TOL["loss"] * abs(losses["plain_stem"]),
          f"s2d loss {losses['s2d']} against the plain stem's {losses['plain_stem']}")
    check(rel_all <= 2 * S2D_TOL["all"], f"s2d update norm {rel_all} off, whole tree")
    for p, v in norms["plain_stem"]["leaves"].items():
        got = norms["s2d"]["leaves"][p]
        check(abs(got - v) <= 2 * S2D_TOL["leaf"] * v, f"s2d update norm of {p}: {got} against {v}")
    del deltas
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        episodes = make_episodes(name)
        for s2d in (False, True):
            got = timed_steps(make_trainer(dtype, s2d=s2d), load_params, episodes, lr, seen0,
                              batch_size, bn_layers)
            report[f"{name}_{'s2d' if s2d else 'plain_stem'}"] = got
            if s2d:
                add_counts(total, got)
            torch.cuda.empty_cache()
    emit(f"{tag}_s2d", batch=batch_size, size=416, **report)
    return total


def run_train_variants(name: str, variant) -> dict:
    """`variant(dtype)` for float32 and bfloat16, each emitted as phase
    `name`; returns the bn_sums and bn_act launches of their main paths,
    summed, and the BN layers' shapes."""
    total = {}
    for dtype in (torch.float32, torch.bfloat16):
        report = variant(dtype)
        emit(name, **report)
        total["bn_layer_shapes"] = report["bn_layer_shapes"]
        add_counts(total, report["bn_counts"])
        torch.cuda.empty_cache()
    return total


def phase_train(seed: int) -> dict:
    """Returns the bn_sums launches of the main path, summed over variants."""
    dblocks, lblocks = parse_cfg(DARKNET_CFG), parse_cfg(LEARNET_CFG)
    spec = MetaSpec(build_spec(dblocks), build_spec(lblocks))
    sched = schedule_from_cfg(dblocks[0], TRAIN_NEG_RATIO, TRAIN_N_CLS)
    check(sched.batch_size == 64, f"the cfg's batch is {sched.batch_size}")
    processed = SEEN // sched.batch_size

    def load_params():
        params, header = load_train_state(spec)
        check(header.seen == SEEN, f"checkpoint header says seen={header.seen}")
        return params

    def variant(dtype):
        name = str(dtype).split(".")[-1]
        episodes = [make_episode(seed + i, sched.batch_size, TRAIN_N_CLS, 416, name)
                    for i in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS)]
        check(tuple(episodes[0]["x"].shape) == (1, sched.batch_size, 416, 416, 3),
              "episode images shape")
        check(tuple(episodes[0]["metax"].shape) == (1, TRAIN_N_CLS, 416, 416, 3), "support shape")

        def make_trainer(**kw):
            return MetaTrainer(spec, momentum=sched.momentum, weight_decay=sched.weight_decay,
                               metain_type=2, image_dtype=dtype, warmup_seen=12800,
                               device=DEVICE, **kw)

        report = train_variant("train", make_trainer, load_params, episodes,
                               lambda i: sched.lr(processed + i), SEEN, sched.batch_size,
                               BN_LAYERS, META_PICKS, dtype)
        return {"n_cls": TRAIN_N_CLS, **report}

    def make_episodes(name):
        return [make_episode(seed + i, sched.batch_size, TRAIN_N_CLS, 416, name)
                for i in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS)]

    def make_trainer(dtype, **kw):
        return MetaTrainer(spec, momentum=sched.momentum, weight_decay=sched.weight_decay,
                           metain_type=2, image_dtype=dtype, warmup_seen=12800,
                           device=DEVICE, **kw)

    total = run_train_variants("train", variant)
    s2d = s2d_variants("train", make_trainer, load_params, make_episodes,
                       lambda i: sched.lr(processed + i), SEEN, sched.batch_size, BN_LAYERS)
    return add_counts(total, s2d)


# ---------------------------------------------------------------------------
# plain_serve / plain_train: the plain YOLOv2 family at full width
# ---------------------------------------------------------------------------


def plain_params(spec, seed: int) -> list:
    """Seeded numpy tree for cfg/yolo-voc.cfg (the repo has no trained plain
    checkpoint): the port's init with the conv weights scaled by 2.45 (He
    scale for a uniform fan-in init, so activations stay O(1) through the 23
    layers of the folded inference graph) and random BN statistics, as the
    parity tests make them (tests/torch_port_util.py:randomize_bn)."""
    rng = np.random.default_rng(seed)
    params = init_params(spec, rng)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * np.float32(2.45)
        if p and "bn" in p:
            c = p["bn"]["gamma"].shape[0]
            p["bn"] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "beta": rng.uniform(-0.3, 0.3, c).astype(np.float32),
                       "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                       "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return params


def plain_detect_flow(m, image) -> dict:
    """The detect flow of `detect_torch.py` (`detect_pipeline`,
    `detect_boxes`): serving thresholds, conf 0.5 on objectness alone, NMS
    0.4, a buffer cut to the grid's 845 anchors, so nothing is truncated.
    One launch; the keep mask bit-equal to the plain version's on the same
    buffer (the rows' first five columns are the buffer's boxes and
    confidences); the boxes those of the host path (get_region_boxes + nms).
    Returns the kernel launches of the flow with the report."""
    pipe = detect_torch.detect_pipeline(m.region)
    output = m(image)
    counts = pipe._ranked(output)[4]
    torch.cuda.synchronize()
    nms_rows.launches = 0  # read right after the flow's one call
    boxes = detect_torch.detect_boxes(m, pipe, output)
    torch.cuda.synchronize()
    launches = nms_rows.launches
    check(launches == 1, f"the detect flow launched nms_rows {launches} times")
    rows, keep = pipe.device_call(output)
    want = nms_rows_reference(rows[..., :4].contiguous(), rows[..., 4].contiguous(), 0.4)
    check(torch.equal(keep, want), f"detect flow: {int((keep != want).sum())} keep slots differ "
          "from nms_rows_reference")
    check(len(boxes) == int(keep.sum()), "detect flow: box list and keep mask disagree")
    host = nms(get_region_boxes(output, 0.5, m.region.num_classes, m.region.anchor_wh)[0], 0.4)
    check(len(host) == len(boxes) and all(d[6] == h[6] for d, h in zip(boxes, host)),
          f"detect flow: {len(boxes)} boxes on the device, {len(host)} on the host path")
    worst = max((float(np.max(np.abs(np.asarray(d) - np.asarray(h, float))))
                 for d, h in zip(boxes, host)), default=0.0)
    check(worst <= 1e-6, f"detect flow: device and host boxes differ by {worst}")
    return {"candidates_above_0.5": int(counts.max()), "top_k": int(rows.shape[1]),
            "kept": len(boxes), "keep_equal": True, "host_max_abs_diff": worst,
            "nms_launches": launches}


def phase_plain_serve(seed: int, n_batches: int, outdir: str) -> dict:
    """cfg/yolo-voc.cfg at 416x416 from seeded weights written to a
    `.weights` file and read back through PlainDetector; the plain sweep
    (eval/valid.py:_plain_sweep -> DevicePipeline(validation=True) ->
    per-class files) at batch 16 in float32 and bfloat16, with a candidate
    buffer of 845, every anchor of the 13x13x5 grid (FSD_DEVICE_NMS_K, as a
    user sets it); a batch at the default buffer of 256 for the host path;
    the detect flow. Returns the main path's launches and the candidate rows
    of its first batch."""
    spec = build_spec(parse_cfg(PLAIN_CFG))
    check((spec.width, spec.height, spec.region.num_classes) == (416, 416, 20),
          "cfg/yolo-voc.cfg is not at 416x416 with 20 classes")
    rng = np.random.default_rng(seed)
    images, _ = paint_images(rng, n_batches * BATCH, 416)
    detset = MemoryDetectionSet(images)
    captured, main_launches, reports = None, 0, []
    old_k = os.environ.get("FSD_DEVICE_NMS_K")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plain_") as tmp:
        wpath = os.path.join(tmp, "yolo-voc.weights")
        save_weights(wpath, [spec], [plain_params(spec, seed)], seen=PLAIN_SEEN)
        try:
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                t0 = time.perf_counter()
                m = PlainDetector(PLAIN_CFG, wpath, compute_dtype=dtype, device=DEVICE)
                load_s = time.perf_counter() - t0
                check(m.header.seen == PLAIN_SEEN, f"weights header says seen={m.header.seen}")
                os.environ["FSD_DEVICE_NMS_K"] = str(PLAIN_TOP_K)
                one, rows = one_batch(lambda m=m: m(images[:BATCH]),
                                      valid._device_pipe(m.region),
                                      functools.partial(valid.plain_host_boxes, m.region),
                                      (BATCH, 13, 13, 125))
                run = (lambda prefix, stats, m=m: valid._plain_sweep(
                    m, detset, prefix, "comp4_det_test_", VOC_CLASSES, BATCH, stats=stats))
                swept = sweep(run, len(detset.lines), VOC_CLASSES, outdir, f"plain_{name}",
                              PLAIN_TOP_K)
                check(swept["nms_launches"] == swept["batches"],
                      f"{swept['nms_launches']} launches for {swept['batches']} plain batches")
                main_launches += swept["nms_launches"]
                # the default buffer: a row of the random head holds more
                # candidates than 256, so the batch is redone on the host
                # and launches nothing
                os.environ.pop("FSD_DEVICE_NMS_K", None)
                single = MemoryDetectionSet(images[:BATCH])
                run = (lambda prefix, stats, m=m, single=single: valid._plain_sweep(
                    m, single, prefix, "comp4_det_test_", VOC_CLASSES, BATCH, stats=stats))
                default = sweep(run, BATCH, VOC_CLASSES, outdir, f"plain_{name}_k256", 256)
                detect = plain_detect_flow(m, images[:1])
                main_launches += detect["nms_launches"]
                report = {"dtype": name, "load_seconds": load_s, "one_batch": one,
                          "sweep": swept, "default_buffer": default, "detect_flow": detect}
                reports.append(report)
                emit("plain_serve", **report)
                if captured is None:
                    captured = rows
        finally:
            if old_k is None:
                os.environ.pop("FSD_DEVICE_NMS_K", None)
            else:
                os.environ["FSD_DEVICE_NMS_K"] = old_k
    return {"rows": captured, "launches": main_launches}


# ---------------------------------------------------------------------------
# int8_serve: FSD_INT8 serving at full width
# ---------------------------------------------------------------------------

# the workflow's synthetic images (data/synth.py, the style and sizes the
# tracked checkpoint was trained on), two sweep batches
INT8_IMAGES = 2 * BATCH
INT8_IMG_SIZE = (256, 256)
# the JAX package's bounds on int8 against float (tests/test_quant.py), held
# where its tests hold them (seeded weights at 64 px, `int8_jax_test_cases`):
# the head output's largest deviation over its largest value (plain 0.05,
# meta 0.06, with the learnet and the head 0.08), and confident boxes (conf
# 0.5 on objectness, NMS 0.4) within max(2, n // 5) of the float count. On
# the tracked checkpoint the scheme itself deviates far more, in the JAX
# package too (tests/test_torch_int8_eval.py holds the two alike there):
# there the deviation and the confident boxes are reported, not bounded
INT8_PLAIN_REL = 0.05
INT8_META_REL = 0.06
INT8_LEARNET_HEAD_REL = 0.08
CONFIDENT = 0.5
TINY_PLAIN_CFG = os.path.join(REPO, "cfg", "tiny-yolo-voc.cfg")
# published int8 dense rate of one H100 SXM (tensor cores)
PEAK_INT8_OPS = 1979e12


class Int8Products:
    """Every int8 product the paths launch, by standing in for
    `ops/int8_mm.padded_int_mm` (`int8_matmul`'s one call of torch._int_mm),
    which adds no launch of its own: how often each distinct (M, K, N) ran,
    and a copy of the operands of its first call."""

    def __init__(self):
        self.counts, self.operands = {}, {}
        self._fn = int8_mm.padded_int_mm

    def _record(self, a, w):
        key = (a.shape[0], a.shape[1], w.shape[0])
        self.counts[key] = self.counts.get(key, 0) + 1
        if key not in self.operands:
            self.operands[key] = (a.clone(), w.clone())
        return self._fn(a, w)

    def __enter__(self):
        int8_mm.padded_int_mm = self._record
        return self

    def __exit__(self, *exc):
        int8_mm.padded_int_mm = self._fn


class Int8Clock:
    """Times every int8 product of a stretch of work with CUDA events, by
    standing in for `ops/int8_mm.padded_int_mm` (over whatever stands
    there): their summed card time, operations and bound."""

    def __init__(self):
        self.events, self.shapes = [], []
        self._fn = int8_mm.padded_int_mm

    def _timed(self, a, w):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._fn(a, w)
        stop.record()
        self.events.append((start, stop))
        self.shapes.append((a.shape[0], a.shape[1], w.shape[0]))
        return out

    def __enter__(self):
        int8_mm.padded_int_mm = self._timed
        return self

    def __exit__(self, *exc):
        int8_mm.padded_int_mm = self._fn

    def report(self) -> dict:
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        ops = sum(2 * m * k * n for m, k, n in self.shapes)
        return {"products": len(self.shapes), "products_ms": ms,
                "products_bound_ms": sum(int8_bound_ms(*s)["bound_ms"] for s in self.shapes),
                "products_gop": ops / 1e9, "products_tops": ops / ms / 1e9 if ms else None}


def int8_bound_ms(m: int, k: int, n: int) -> dict:
    """The least time of an (M, K, N) int8 product with int32 results on the
    card: each operand read once, the result written once, against 2*M*K*N
    operations at the int8 tensor-core rate."""
    bytes_ms = (m * k + n * k + 4 * m * n) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * m * k * n / PEAK_INT8_OPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms > ops_ms else
            "operations"}


def hold_int8_products(rec: Int8Products) -> dict:
    """Each distinct recorded product again on the card (torch._int_mm,
    padded as the path pads it) against the plain int64 product on the
    CPU: the int32 results must be equal. Times on the card by CUDA events."""
    cases, t_cpu = [], 0.0
    for (m, k, n), (a, w) in sorted(rec.operands.items(), key=lambda kv: -np.prod(kv[0])):
        card = rec._fn(a, w)
        t0 = time.perf_counter()
        want = int8_matmul_reference(a.cpu(), w.cpu())
        t_cpu += time.perf_counter() - t0
        differ = int((card.cpu() != want).sum())
        check(differ == 0, f"int8 product ({m}, {k}, {n}): {differ} int32 results differ from "
              "the plain product")
        ms = cuda_ms(lambda a=a, w=w: rec._fn(a, w), 10)
        cases.append({"m": m, "k": k, "n": n, "calls": rec.counts[(m, k, n)], "differ": differ,
                      "ms": ms, "tops": 2 * m * k * n / ms / 1e9, **int8_bound_ms(m, k, n)})
    return {"cases": cases, "cpu_seconds": t_cpu}


def int8_layers(fspec) -> int:
    return sum(quant._is_quantizable(fspec, l) for l in fspec.layers)


def codes_on_card_and_cpu(x: torch.Tensor, sx: float) -> tuple[int, int]:
    """(codes, codes that differ) of quantize_act on the card and on the CPU
    for the same float input."""
    inv = quant.act_scale_inverse(sx)
    card = quant.quantize_act(x, torch.tensor(inv, dtype=torch.float32, device=x.device))
    cpu = quant.quantize_act(x.cpu(), torch.tensor(inv, dtype=torch.float32))
    return card.numel(), int((card.cpu() != cpu).sum())


def meta_codes_check(m, images, dev_codes) -> dict:
    """The int8 detect path once more, with an observe hook that holds every
    quantized input's codes (and the fused head's effective-weight codes and
    scales) on the card against the CPU's for the same float tensor."""
    total = {"codes": 0, "differ": 0, "head_weight_codes": 0, "head_weight_differ": 0}
    layers = m.qspec.darknet.layers
    dyn = next(l for l in layers if l.kind == "conv" and l.dynamic)
    head_w = m.qparams[layers[dyn.index + 1].index]["w"]
    dw = dev_codes[0].to(m.compute_dtype)

    def observe(idx, x):
        if idx not in m.act_scales:
            return
        n, d = codes_on_card_and_cpu(x, m.act_scales[idx])
        total["codes"] += n
        total["differ"] += d
        if idx == dyn.index:
            card = meta_mod.head_int8_operands(x, dw, head_w, m.act_scales[idx])
            cpu = meta_mod.head_int8_operands(x.cpu(), dw.cpu(), head_w.cpu(), m.act_scales[idx])
            total["head_weight_codes"] += card[1].numel()
            total["head_weight_differ"] += int((card[1].cpu() != cpu[1]).sum())
            check(torch.equal(card[2].cpu(), cpu[2]), "the head's scales differ card against CPU")

    with torch.no_grad():
        meta_mod.detect_forward(
            m.qspec, {"darknet": m.qparams, "learnet": None},
            torch.as_tensor(images, device=m.device).to(m.compute_dtype),
            [d.to(m.compute_dtype) for d in dev_codes], fuse=True, act_scales=m.act_scales,
            observe=observe)
    check(total["differ"] == 0 and total["head_weight_differ"] == 0,
          f"int8 codes differ between the card and the CPU: {total}")
    return total


def confident_boxes(output: torch.Tensor, n_cls: int | None, region) -> int:
    """Boxes over CONFIDENT on objectness after NMS 0.4, as the JAX tests
    count them; `n_cls` None for the plain head."""
    if n_cls is None:
        rows = get_region_boxes(output, CONFIDENT, region.num_classes, region.anchor_wh)
    else:
        rows = get_region_boxes_v2(output, n_cls, CONFIDENT, region.num_classes,
                                   region.anchor_wh)
    return sum(len(nms(b, 0.4)) for b in rows)


def boxes_close(n_fp: int, n_q: int) -> bool:
    return n_fp > 0 and abs(n_fp - n_q) <= max(2, n_fp // 5)


def max_rel_dev(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def seeded_weights(path: str, specs: list, seed: int) -> str:
    """The JAX tests' weights: the init of `seed` with every conv weight
    x 2.45, BN at its init, written as a .weights file."""
    rng = np.random.default_rng(seed)
    trees = []
    for spec in specs:
        trees.append([dict(p, w=p["w"] * np.float32(2.45)) if p and "w" in p else p
                      for p in init_params(spec, rng)])
    save_weights(path, specs, trees)
    return path


def int8_jax_test_cases() -> list:
    """The JAX package's int8 closeness tests (tests/test_quant.py) on the
    card in float32, with their recipe and bounds: seeded weights, inputs
    drawn from np.random.RandomState as the tests draw them, 64 px; the
    plain tiny-yolo-voc (0.05 and the confident boxes), the meta detector's
    backbone (0.06), and with the learnet and the head (codes and head 0.08)."""
    out = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_tests_") as tmp:
        spec = build_spec(parse_cfg(TINY_PLAIN_CFG))
        m = PlainDetector(TINY_PLAIN_CFG, seeded_weights(os.path.join(tmp, "t.weights"), [spec], 0),
                          device=DEVICE)
        rng = np.random.RandomState(1)
        calib = rng.rand(8, 64, 64, 3).astype(np.float32)
        x = rng.rand(2, 64, 64, 3).astype(np.float32)
        y_fp = m(x)
        m.quantize_int8(calib)
        y_q = m(x)
        n_fp, n_q = (confident_boxes(y, None, m.region) for y in (y_fp, y_q))
        out.append({"case": "plain tiny-yolo-voc", "max_rel_dev": max_rel_dev(y_q, y_fp),
                    "bound": INT8_PLAIN_REL, "confident_boxes_float": n_fp,
                    "confident_boxes_int8": n_q, "boxes_close": boxes_close(n_fp, n_q)})
        specs = [build_spec(parse_cfg(c)) for c in (DARKNET_CFG, LEARNET_CFG)]
        for case, seed, rs, kw, bound in (
                ("meta backbone", 7, 0, {}, INT8_META_REL),
                ("meta learnet and head", 3, 1, {"quant_head": True}, INT8_LEARNET_HEAD_REL)):
            wpath = seeded_weights(os.path.join(tmp, f"m{seed}.weights"), specs, seed)
            m = MetaDetector(DARKNET_CFG, LEARNET_CFG, wpath, device=DEVICE)
            rng = np.random.RandomState(rs)
            metax = rng.rand(4, 64, 64, 3).astype(np.float32)
            mask = (rng.rand(4, 64, 64, 1) > 0.5).astype(np.float32)
            codes = m.class_codes(metax, mask)
            x = rng.rand(2, 64, 64, 3).astype(np.float32)
            y_fp = m.detect(x, codes)
            if kw:
                kw = dict(kw, calib_support=(metax, mask))
            m.quantize_int8(x, codes, **kw)
            got = {"case": case, "max_rel_dev": max_rel_dev(m.detect(x, codes), y_fp),
                   "bound": bound}
            if kw:
                got["codes_max_rel_dev"] = max(
                    float(np.abs(q - f).max() / (np.abs(f).max() + 1e-9))
                    for q, f in zip(m.class_codes(metax, mask), codes))
            out.append(got)
    emit("int8_serve", jax_test_cases=out)
    for c in out:
        check(c["max_rel_dev"] < c["bound"] and c.get("codes_max_rel_dev", 0) < c["bound"]
              and c.get("boxes_close", True),
              f"int8 against float outside the JAX tests' bound: {c}")
    return out


def int8_sweep_files(data_options, settings, root: str, head: bool, n_quant: int) -> dict:
    """run_valid_ensemble under FSD_INT8=1 (FSD_INT8_HEAD as `head`) in
    float32 over the painted list, as valid_ensemble_torch.py runs it, with
    both launch counts set to 0 just before and read just after."""
    env = {"FSD_INT8": "1", "FSD_INT8_HEAD": "1" if head else "0", "FSD_NATIVE": "1",
           "FSD_EVAL_BATCH": str(BATCH), "FSD_DEVICE_NMS_K": str(PLAIN_TOP_K)}
    torch.cuda.synchronize()
    nms_rows.launches = int8_matmul.launches = 0  # read right after the sweep
    t0 = time.perf_counter()
    printed = run_cli(lambda: valid.run_valid_ensemble(
        data_options, DARKNET_CFG, LEARNET_CFG, WEIGHTS, settings, device=DEVICE), env)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"nms_rows": nms_rows.launches, "int8_products": int8_matmul.launches}
    check("===> int8 serving calibrated for the sweep" in printed, "the sweep did not quantize")
    prefix = printed.split("saving to: ", 1)[1].split()[0]
    rows = 0
    for name in VOC_CLASSES:
        with open(os.path.join(root, prefix, f"comp4_det_test_{name}.txt")) as f:
            lines = f.read().splitlines()
        check(all(len(r.split()) == 6 and np.isfinite([float(v) for v in r.split()[1:]]).all()
                  for r in lines), f"malformed result row for {name}")
        rows += len(lines)
    batches = INT8_IMAGES // BATCH
    check(rows > 0, "the int8 sweep wrote no result row")
    check(launches["nms_rows"] == batches, f"{launches} for {batches} batches")
    check(launches["int8_products"] == batches * (n_quant + head),
          f"{launches['int8_products']} int8 products for {batches} batches of "
          f"{n_quant + head} quantized layers")
    return {"head_int8": head, "seconds": seconds, "images_per_s": INT8_IMAGES / seconds,
            "result_rows": rows, "launches": launches}


def phase_int8_serve(seed: int, n_batches: int, outdir: str) -> dict:
    """FSD_INT8 serving of the ensemble sweep at full width on the tracked
    checkpoint, over images of the workflow's synthetic style: through
    run_valid_ensemble in float32 (TF32 off) with the int8 head and with
    FSD_INT8_HEAD=0; then in float32 and bfloat16 the same steps in memory
    (class codes over every support image, valid.quantize_sweep, the sweep)
    at 20 and 15 classes (the head's N = 450 padded to 456), each against
    the same detector's non-int8 output on the first batch; then
    PlainDetector.quantize_int8 on cfg/yolo-voc.cfg from seeded weights;
    then the JAX package's int8 closeness tests with their bounds
    (`int8_jax_test_cases`). Every int8 product launched is recorded and held on the card against
    the plain CPU product; the card's int8 codes against the CPU's. Returns
    the NMS launches and the held products."""
    root = os.path.join(outdir, "int8")
    os.makedirs(root)
    cwd = os.getcwd()
    main_launches, reports = 0, {"runs": [], "sweeps": [], "plain": []}
    with Int8Products() as rec:
        try:
            os.chdir(root)
            d = make_voc_like(os.path.join(root, "voc"), n_images=INT8_IMAGES, size=INT8_IMG_SIZE,
                              seed=seed, style="huebin", box_range=(0.15, 0.45))
            datacfg = os.path.join(root, "int8.data")
            with open(datacfg, "w") as f:
                f.write("metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
                        f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                        f"meta={d['traindict']}\ntrain={d['train_list']}\n"
                        f"valid={d['train_list']}\nbackup={root}/backup\ngpus=0\n")
            data_options, darknet, _, settings = resolve_configs(datacfg, DARKNET_CFG, LEARNET_CFG)
            dspec = build_spec(darknet)
            n_quant = int8_layers(folded_spec(dspec))
            for head in (True, False):
                run = int8_sweep_files(data_options, settings, root, head, n_quant)
                main_launches += run["launches"]["nms_rows"]
                reports["runs"].append(run)

            old = {k: os.environ.get(k) for k in ("FSD_NATIVE", "FSD_INT8", "FSD_DEVICE_NMS_K")}
            os.environ.update(FSD_NATIVE="1", FSD_INT8="1", FSD_DEVICE_NMS_K=str(PLAIN_TOP_K))
            try:
                images = np.concatenate([b for b, _ in DetectionDataset(
                    data_options["valid"], settings, shape=(dspec.width, dspec.height),
                    shuffle=False, train=False, filter_valid=False).batches(BATCH, drop_last=False)])
                support = MetaDataset(data_options["meta"], settings, train=False,
                                      ensemble=True, with_ids=True)
                detset = MemoryDetectionSet(images)
                for dtype in (torch.float32, torch.bfloat16):
                    got = int8_meta_sweeps(dtype, images, detset, support, outdir, n_quant)
                    main_launches += sum(s["sweep"]["nms_launches"] for s in got["by_classes"])
                    reports["sweeps"].append(got)
                    emit("int8_serve", **got)
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            reports["plain"] = int8_plain(seed)
            reports["jax_test_cases"] = int8_jax_test_cases()
        finally:
            os.chdir(cwd)
    held = hold_int8_products(rec)
    emit("int8_products", distinct=len(held["cases"]), cpu_seconds=held["cpu_seconds"],
         case_fields=list(held["cases"][0]), cases=[list(c.values()) for c in held["cases"]])
    emit("int8_serve", runs=reports["runs"], plain=reports["plain"],
         products_equal=all(c["differ"] == 0 for c in held["cases"]),
         products_held=len(held["cases"]), nms_launches=main_launches)
    return {"launches": main_launches, "products": held}


def int8_meta_sweeps(dtype, images, detset, support, outdir: str, n_quant: int) -> dict:
    """One compute dtype of `phase_int8_serve`'s in-memory part."""
    name = str(dtype).split(".")[-1]
    m = MetaDetector(DARKNET_CFG, LEARNET_CFG, WEIGHTS, metain_type=2, compute_dtype=dtype,
                     device=DEVICE)
    codes, _ = valid.ensemble_class_codes(m, support)
    first = images[:BATCH]
    dev = {n: m.commit_codes([c[:n] for c in codes]) for n in (20, 15)}
    float_out = {n: m.detect(first, dev[n]) for n in dev}
    float_ms = cuda_ms(lambda: m.detect(first, dev[20]), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(valid.quantize_sweep(m, detset, codes, BATCH), "FSD_INT8=1 did not quantize")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    int8_ms = cuda_ms(lambda: m.detect(first, dev[20]), 5)
    with Int8Clock() as clock:  # the products of one int8 detect of the first batch
        m.detect(first, dev[20])
    report = {"dtype": name, "calibration_seconds": calib_s, "detect_ms_float": float_ms,
              "detect_ms_int8": int8_ms, "one_detect": clock.report(), "batch": BATCH,
              "quantized_layers": n_quant + 1,
              "codes": meta_codes_check(m, first, dev[20]), "by_classes": []}
    accuracy = []
    for n_cls in (20, 15):
        out, ref = m.detect(first, dev[n_cls]), float_out[n_cls]
        accuracy.append({"n_cls": n_cls, "max_rel_dev": max_rel_dev(out, ref),
                         "mean_rel_dev": float((out - ref).abs().mean() / ref.abs().mean()),
                         "confident_boxes_float": confident_boxes(ref, n_cls, m.region),
                         "confident_boxes_int8": confident_boxes(out, n_cls, m.region)})
    for n_cls, acc in zip((20, 15), accuracy):
        classes = VOC_CLASSES[:n_cls]
        run = (lambda prefix, stats, codes=dev[n_cls], n_cls=n_cls, classes=classes:
               valid._meta_sweep(m, detset, prefix, "comp4_det_test_", lambda: codes,
                                 n_cls, classes, BATCH, stats=stats))
        int8_matmul.launches = 0  # read right after the sweep, with nms_rows's
        swept = sweep(run, len(detset.lines), classes, outdir, f"int8_{name}_{n_cls}", PLAIN_TOP_K)
        products = int8_matmul.launches
        check(products == swept["batches"] * (n_quant + 1),
              f"{products} int8 products for {swept['batches']} batches")
        swept["int8_products"] = products
        report["by_classes"].append({**acc, "sweep": swept})
    return report


def int8_plain(seed: int) -> list:
    """PlainDetector.quantize_int8 on cfg/yolo-voc.cfg at 416 px from the
    plain_serve phase's seeded weights, calibrated on 16 painted images, in
    float32 and bfloat16: the int8 head output's deviation from the float one
    (reported), the codes on the card against the CPU's, the int8 products
    of a forward."""
    spec = build_spec(parse_cfg(PLAIN_CFG))
    rng = np.random.default_rng(seed + 7)
    calib, _ = paint_images(rng, BATCH, 416)
    images, _ = paint_images(rng, BATCH, 416)
    out = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_plain_") as tmp:
        wpath = os.path.join(tmp, "yolo-voc.weights")
        save_weights(wpath, [spec], [plain_params(spec, seed)], seen=PLAIN_SEEN)
        for dtype in (torch.float32, torch.bfloat16):
            m = PlainDetector(PLAIN_CFG, wpath, compute_dtype=dtype, device=DEVICE)
            y_fp = m(images)
            float_ms = cuda_ms(lambda: m(images), 5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.quantize_int8(calib)
            torch.cuda.synchronize()
            calib_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            int8_matmul.launches = 0  # one forward's products, read right after
            y_q = m(images)
            torch.cuda.synchronize()
            products = int8_matmul.launches
            n_quant = int8_layers(m.fspec)
            check(products == n_quant, f"plain int8 forward: {products} products, {n_quant} layers")
            rel = max_rel_dev(y_q, y_fp)
            check(bool(torch.isfinite(y_q).all()), "plain int8 output is not finite")
            codes = {"codes": 0, "differ": 0}

            def observe(idx, x, m=m, codes=codes):
                if idx in m.act_scales:
                    n, d = codes_on_card_and_cpu(x, m.act_scales[idx])
                    codes["codes"] += n
                    codes["differ"] += d

            with torch.no_grad():
                apply_network(m.fspec, m.qparams, torch.as_tensor(images, device=m.device)
                              .to(dtype), act_scales=m.act_scales, observe=observe)
            check(codes["differ"] == 0, f"plain int8 codes differ card against CPU: {codes}")
            out.append({"dtype": str(dtype).split(".")[-1], "calibration_seconds": calib_s,
                        "detect_ms_float": float_ms,
                        "detect_ms_int8": cuda_ms(lambda: m(images), 5),
                        "batch": BATCH, "quantized_layers": n_quant, "int8_products": products,
                        "max_rel_dev": rel, "codes": codes})
    return out


def make_plain_episode(seed: int, batch_size: int, dtype_name: str, groups: int = 1) -> dict:
    """One batch for PlainTrainer painted from the seed through the CLI's own
    batch maker: noisy backgrounds (see make_episode), the first rectangle of
    image i labelled as class i % 20, every image kept (cfg/voc.data has no
    neg ratio)."""
    imgs, first = paint_images(np.random.default_rng(seed), batch_size, 416, "noise")
    labels = np.zeros((batch_size, 50, 5), np.float32)
    labels[:, 0, 0] = np.arange(batch_size) % 20
    labels[:, 0, 1:] = first
    return make_plain_batch(imgs, labels.reshape(batch_size, 250), groups, "full", None,
                            dtype=dtype_name)


class PlainTrainSetup:
    """The plain training step for cfg/yolo-voc.cfg: the spec, the schedule
    train_plain_cli derives (`plain_schedule_from_cfg`) and the parameters
    from `plain_params`."""

    def __init__(self, seed: int):
        blocks = parse_cfg(PLAIN_CFG)
        self.spec = build_spec(blocks)
        self.sched = plain_schedule_from_cfg(blocks[0])
        self.base = plain_params(self.spec, seed)

    def load_params(self):
        return require_grads(from_jax_params(self.spec, self.base, DEVICE))

    def make_trainer(self, dtype, **kw):
        return PlainTrainer(self.spec, momentum=self.sched.momentum,
                            weight_decay=self.sched.weight_decay,
                            image_dtype=dtype, device=DEVICE, **kw)


def phase_plain_train(seed: int) -> dict:
    """PlainTrainer on cfg/yolo-voc.cfg at the cfg's batch 64 and 416 px, one
    replica group, from seeded weights at seen 0 (a run from a backbone),
    with lr and weight decay as train_plain_cli derives them
    (`PlainTrainSetup`), on batches from `make_plain_episode`. Returns the
    bn_sums launches of the main path, summed over variants."""
    setup = PlainTrainSetup(seed)
    sched = setup.sched
    check(sched.batch_size == 64, f"the cfg's batch is {sched.batch_size}")

    def variant(dtype):
        name = str(dtype).split(".")[-1]
        episodes = [make_plain_episode(seed + 100 + i, sched.batch_size, name)
                    for i in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS)]
        check(tuple(episodes[0]["x"].shape) == (1, sched.batch_size, 416, 416, 3), "batch shape")
        return train_variant("plain_train", lambda **kw: setup.make_trainer(dtype, **kw),
                             setup.load_params, episodes, sched.lr, 0, sched.batch_size,
                             PLAIN_BN_LAYERS, PLAIN_PICKS, dtype)

    def make_episodes(name):
        return [make_plain_episode(seed + 100 + i, sched.batch_size, name)
                for i in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS)]

    total = run_train_variants("plain_train", variant)
    s2d = s2d_variants("plain_train", setup.make_trainer, setup.load_params, make_episodes,
                       sched.lr, 0, sched.batch_size, PLAIN_BN_LAYERS)
    return add_counts(total, s2d)


def phase_bn_step(path: str, shapes: list, n_layers: int, seed: int) -> None:
    """The `bn_sums` kernels over the BN layers of one step of training
    path `path` (train, plain_train), one
    launch at a time outside the step: for each type the sum over the layers
    of kernel time on the card and of the byte bound, forward and backward.
    The gap between the two sums is what the kernels leave on the table each
    step.
    Each distinct shape is timed once (inputs of up to 50 MB sit in the L2
    cache, as they do behind the convolution that wrote them)."""
    check(len(shapes) == n_layers, f"{len(shapes)} BN layers in a {path} step, not {n_layers}")
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        itemsize = torch.empty((), dtype=dtype).element_size()
        per_shape = {}
        for m, c in sorted(set(map(tuple, shapes))):
            x = make_activation(seed, m, c, dtype)
            dsum, dsq = torch.randn(c, device=DEVICE), torch.randn(c, device=DEVICE)
            per_shape[(m, c)] = {
                "shape": [m, c], "layers": sum(1 for sh in shapes if tuple(sh) == (m, c)),
                "fwd_card_ms": card_ms(lambda: bn_mod._launch_forward(x), 20),
                "bwd_card_ms": card_ms(lambda: bn_mod._launch_backward(x, dsum, dsq), 20),
                "fwd_bound_ms": bn_bound_ms(m, c, itemsize, False),
                "bwd_bound_ms": bn_bound_ms(m, c, itemsize, True)}
            del x
        total = {k: sum(v[k] * v["layers"] for v in per_shape.values())
                 for k in ("fwd_card_ms", "fwd_bound_ms", "bwd_card_ms", "bwd_bound_ms")}
        total["fwd_share_of_bound"] = total["fwd_bound_ms"] / total["fwd_card_ms"]
        total["bwd_share_of_bound"] = total["bwd_bound_ms"] / total["bwd_card_ms"]
        report[name] = {**total, "values": sum(m * c for m, c in shapes),
                        "shapes": list(per_shape.values())}
    emit("bn_sums_step", path=path, layers=len(shapes), **report)


def phase_debug(seed: int) -> dict:
    """debug_torch.py's main on cfg/yolo-voc.cfg from the seeded weights of
    `plain_params` (written as a .weights file) and a painted VOC-sized PNG
    with its label file, read through the native pipeline (FSD_NATIVE=1: the
    card's host has no PIL): one training forward and autograd backward on
    the card, 22 + 22 bn_sums launches, the loss and each conv's largest
    weight gradient finite, nGT the label's objects."""
    spec = build_spec(parse_cfg(PLAIN_CFG))
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_debug_") as d:
        weights = os.path.join(d, "yolo-voc.weights")
        save_weights(weights, [spec], [plain_params(spec, seed)])
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(d, sub))
        img, objs = paint_voc_image(rng, 7)
        h, w = img.shape[:2]
        path = os.path.join(d, "images", "scene.png")
        png.write_png(path, img)
        with open(os.path.join(d, "labels", "scene.txt"), "w") as f:
            for cls, x1, y1, x2, y2 in objs:
                f.write(f"{cls} {(x1 + x2) / 2 / w} {(y1 + y2) / 2 / h} "
                        f"{(x2 - x1) / w} {(y2 - y1) / h}\n")
        old = os.environ.get("FSD_NATIVE")
        os.environ["FSD_NATIVE"] = "1"
        out = io.StringIO()
        try:
            zero_bn_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                loss, grad_max = debug_torch.main(PLAIN_CFG, weights, path)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = bn_counts()
        finally:
            if old is None:
                os.environ.pop("FSD_NATIVE")
            else:
                os.environ["FSD_NATIVE"] = old
    lines = out.getvalue().splitlines()
    n_convs = sum(1 for layer in spec.layers if layer.kind == "conv")
    check_bn_counts("debug_torch.py", counts, PLAIN_BN_LAYERS)
    check(np.isfinite(loss) and len(grad_max) == n_convs and np.isfinite(grad_max).all()
          and min(grad_max) > 0, f"loss {loss}, gradient maxima {grad_max}")
    check(any(f"nGT={len(objs)}" in line for line in lines), f"nGT of {len(objs)} objects")
    emit("debug", cfg=os.path.relpath(PLAIN_CFG, REPO), image=[w, h], objects=len(objs),
         seconds=seconds, loss=loss, grad_max=grad_max, large=sum(g > 10 for g in grad_max),
         printed_lines=len(lines), loss_line=next(l for l in lines if l.startswith("loss")),
         bn_launches=[counts["fwd"], counts["bwd"]])
    return counts


# ---------------------------------------------------------------------------
# native / ckpt / files: few-shot tuning and eval on image files
# ---------------------------------------------------------------------------

# VOC image sizes (width, height): the common shapes of VOC2007's JPEGImages
VOC_SIZES = ((500, 375), (375, 500), (500, 333), (333, 500), (500, 366), (486, 500))
# the files phase: the devkit's size and the tuning run's shape
FILES_TRAIN_IMAGES = 200
FILES_TEST_IMAGES = 32
FILES_SHOT = 10
FILES_EPOCHS = (2, 3)  # the first run, then the resumed one


def paint_voc_image(rng: np.random.Generator, first_cls: int):
    """A VOC-sized image: dark noise (the BN statistics of the checkpoint
    need texture, see make_episode) with one to three bright rectangles;
    the first is of class `first_cls`. Returns (array, [(cls, x1, y1, x2,
    y2)] in VOC's 1-based pixel corners)."""
    w, h = VOC_SIZES[int(rng.integers(len(VOC_SIZES)))]
    img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    objs = []
    for j in range(int(rng.integers(1, 4))):
        cls = first_cls if j == 0 else int(rng.integers(20))
        bw, bh = int(rng.uniform(0.2, 0.5) * w), int(rng.uniform(0.2, 0.5) * h)
        x1, y1 = int(rng.integers(1, w - bw)), int(rng.integers(1, h - bh))
        img[y1 - 1:y1 + bh - 1, x1 - 1:x1 + bw - 1] = rng.integers(120, 256, 3)
        objs.append((cls, x1, y1, x1 + bw - 1, y1 + bh - 1))
    return img, objs


def paint_devkit(root: str, seed: int) -> str:
    """VOCdevkit/VOC2007 painted from the seed: `FILES_TRAIN_IMAGES` train
    and `FILES_TEST_IMAGES` test images at VOC sizes (PNG data; the files
    carry VOC's .jpg names, and the native decoder reads the format from the
    file's first bytes), XML annotations over the 20 VOC classes, and the
    ImageSets lists. Returns the devkit path."""
    rng = np.random.default_rng(seed)
    voc = os.path.join(root, "VOCdevkit", "VOC2007")
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, d), exist_ok=True)
    sets = {"train": [], "test": []}
    present = {s: {c: [] for c in VOC_CLASSES} for s in sets}
    for i in range(FILES_TRAIN_IMAGES + FILES_TEST_IMAGES):
        split = "train" if i < FILES_TRAIN_IMAGES else "test"
        imgid = f"{i:06d}"
        img, objs = paint_voc_image(rng, i % 20)
        png.write_png(os.path.join(voc, "JPEGImages", imgid + ".jpg"), img, level=1)
        xml = "".join(
            f"<object><name>{VOC_CLASSES[c]}</name><pose>Unspecified</pose>"
            f"<truncated>0</truncated><difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
            f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for c, x1, y1, x2, y2 in objs)
        with open(os.path.join(voc, "Annotations", imgid + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{imgid}.jpg</filename><size><width>{img.shape[1]}"
                    f"</width><height>{img.shape[0]}</height><depth>3</depth></size>{xml}"
                    "</annotation>")
        sets[split].append(imgid)
        classes = {c for c, *_ in objs}
        for c in range(20):
            present[split][VOC_CLASSES[c]].append(f"{imgid} {1 if c in classes else -1}")
    main_dir = os.path.join(voc, "ImageSets", "Main")
    for split, ids in sets.items():
        with open(os.path.join(main_dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        for cls, rows in present[split].items():
            with open(os.path.join(main_dir, f"{cls}_{split}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    return os.path.join(root, "VOCdevkit")


def host_toolchain() -> dict:
    """What the native library builds with on this host: g++'s version,
    whether zlib.h compiles, and which zlib the dynamic linker knows. A
    report only: the build itself raises with the compiler's output when it
    fails."""
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    known = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60).stdout
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zlib_") as d:
        src = os.path.join(d, "zlib_header.cpp")
        with open(src, "w") as f:
            f.write("#include <zlib.h>\n")
        zlib_h = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", src],
                                capture_output=True, timeout=120).returncode == 0
    return {"gxx": gxx, "zlib.h": zlib_h, "runtime_zlib": sorted(
        {line.split()[0] for line in known.splitlines() if re.search(r"libz\.so", line)})}


JPEG_FIXTURES = os.path.join(REPO, "tests", "data_torch", "jpeg")


def sha256_rgb(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()).hexdigest()


def check_jpeg_fixtures(pipe) -> dict:
    """Every file of tests/data_torch/jpeg/manifest.json (and predictions.jpg):
    its size, and its decode's digest (the JAX package's libjpeg-turbo
    decode: progressive and arithmetic coding included) or, where that
    library fails too, the refusal its error must name."""
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    outcome = {"decoded": 0, "refused": 0, "fails": 0}
    for name, entry in sorted(manifest.items()):
        path = os.path.join(REPO, entry["path"])
        if entry["size"] is None:
            with contextlib.suppress(IOError):
                pipe.image_size(path)
                check(False, f"{name}: image_size read a size libjpeg refuses")
        else:
            check(list(pipe.image_size(path)) == entry["size"], f"{name}: image_size")
        check(entry["port"] in ("refused", "fails") if entry["jax"] == "fails"
              else entry["port"] == entry["jax"], f"{name}: the manifest's port entry")
        if entry["port"] in ("refused", "fails"):
            try:
                pipe.decode(path)
            except IOError as e:
                check(path in str(e) and entry.get("reason", "") in str(e), f"{name}: {e}")
                outcome[entry["port"]] += 1
                continue
            check(False, f"{name} decoded, but the port must refuse it")
        check(sha256_rgb(pipe.decode(path)) == entry["port"], f"{name}: decode digest")
        outcome["decoded"] += 1
    return outcome


RESIZE_DIGESTS = os.path.join(REPO, "tests", "data_torch", "resize_digests.json")


def check_pil_resize() -> dict:
    """load_image_resized under FSD_NATIVE=1 (the port's decoder, then its
    copy of PIL's default bicubic resize, native/src/resize.cpp) against the
    committed SHA-256 of the JAX package's output (PIL's decode and resize)
    on the same file."""
    with open(RESIZE_DIGESTS) as f:
        digests = json.load(f)
    old = os.environ.get("FSD_NATIVE")
    os.environ["FSD_NATIVE"] = "1"
    try:
        for name, entry in digests.items():
            img = load_image_resized(os.path.join(REPO, name), *entry["size"])
            got = hashlib.sha256(np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()
            check(got == entry["float32_sha256"],
                  f"load_image_resized({name}, {entry['size']}) is not the JAX package's")
    finally:
        if old is None:
            os.environ.pop("FSD_NATIVE")
        else:
            os.environ["FSD_NATIVE"] = old
    return {"files": sorted(digests), "equal_to_jax_digest": len(digests)}


def decode_rates(pipe, paths: list, params: np.ndarray) -> dict:
    """Decode on one thread (RGB MB/s and images/s, the best of 3 passes)
    and the batch assembler's images/s (decode + augment + resize to 416 on
    the pipe's threads, best of 3)."""
    one, batch = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        nbytes = sum(pipe.decode(p).nbytes for p in paths)
        one.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out, fails = pipe.load_batch(paths, 416, 416, params)
        batch.append(time.perf_counter() - t0)
        check(fails == 0 and np.isfinite(out).all(), "the batch assembler failed an image")
    return {"images": len(paths), "rgb_bytes": nbytes,
            "decode_1thread_mb_per_s": nbytes / min(one) / 1e6,
            "decode_1thread_images_per_s": len(paths) / min(one),
            "assembler_images_per_s": len(paths) / min(batch), "decode_s": one,
            "assembler_s": batch}


def phase_native(seed: int, smi: str) -> dict:
    """The host toolchain and the port's native library: its build, PNGs
    written here decoding bit-equal to what libpng would give, the JPEG
    fixtures to their committed digests, and the decode and batch-assembler
    rates for PNG, baseline JPEG, and progressive and arithmetic transcodes
    of predictions.jpg."""
    report = {"card": smi, **host_toolchain()}
    t0 = time.perf_counter()
    build_native_library()
    report["build_s"] = time.perf_counter() - t0
    report["library"] = os.path.relpath(native_library_path(), REPO)
    pipe = NativeImagePipe()
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as d:
        cases = [rng.integers(0, 256, (375, 500, 3), dtype=np.uint8),
                 rng.integers(0, 256, (333, 500, 3), dtype=np.uint8),
                 rng.integers(0, 256, (7, 13, 3), dtype=np.uint8),
                 rng.integers(0, 256, (61, 40), dtype=np.uint8)]
        for i, arr in enumerate(cases):
            path = os.path.join(d, f"case{i}.png")
            png.write_png(path, arr)
            want = arr if arr.ndim == 3 else np.repeat(arr[..., None], 3, axis=2)
            check(pipe.image_size(path) == (arr.shape[1], arr.shape[0]), f"size of case {i}")
            check(np.array_equal(pipe.decode(path), want),
                  f"PNG case {i} {arr.shape} does not decode to the array written")
        matrix = 0
        for ctype, depth in png.KINDS:
            for interlace in (False, True):
                for filters in ("cycle", 4):
                    h, w = (int(v) for v in rng.integers(1, 40, 2))
                    hi = min(1 << depth, 200) if ctype == 3 else 1 << depth
                    samples = rng.integers(0, hi, (h, w, png.CHANNELS[ctype]))
                    palette = rng.integers(0, 256, (hi, 3)) if ctype == 3 else None
                    path = os.path.join(d, f"m{ctype}_{depth}_{int(interlace)}_{filters}.png")
                    png.write_png(path, samples, ctype, depth, filters=filters,
                                  interlace=interlace, palette=palette)
                    check(pipe.image_size(path) == (w, h), f"size of {path}")
                    check(np.array_equal(pipe.decode(path),
                                         png.libpng_rgb(samples, ctype, depth, palette)),
                          f"PNG colour type {ctype}, {depth} bits, interlace {interlace}, "
                          f"filters {filters}: not libpng's pixels")
                    matrix += 1
        report.update(png_cases_bit_equal=len(cases), png_matrix_bit_equal=matrix,
                      jpeg_fixtures=check_jpeg_fixtures(pipe), pil_resize=check_pil_resize())
        # rates: 64 VOC-sized painted PNGs, 64 copies of predictions.jpg and
        # of each of its two transcodes
        pngs, raws = [], []
        for i in range(64):
            img, _ = paint_voc_image(rng, i % 20)
            pngs.append(os.path.join(d, f"batch{i:02d}.png"))
            png.write_png(pngs[-1], img, level=1)
            raws.append(img)
        copies = {}
        for kind, src in (("jpeg", os.path.join(REPO, "predictions.jpg")),
                          ("progressive_jpeg", os.path.join(JPEG_FIXTURES,
                                                            "predictions_progressive.jpg")),
                          ("arithmetic_jpeg", os.path.join(JPEG_FIXTURES,
                                                           "predictions_arithmetic.jpg"))):
            copies[kind] = [os.path.join(d, f"{kind}{i:02d}.jpg") for i in range(64)]
            for path in copies[kind]:
                shutil.copyfile(src, path)
        draw = random.Random(seed)

        def params_for(sizes):
            return np.asarray([
                [p.pleft, p.pright, p.ptop, p.pbot, p.flip, p.dhue, p.dsat, p.dexp]
                for p in (sample_augment_params(w, h, draw) for w, h in sizes)], np.float32)

        png_params = params_for([(r.shape[1], r.shape[0]) for r in raws])
        report["png_rates"] = decode_rates(pipe, pngs, png_params)
        for kind, paths in copies.items():
            report[f"{kind}_rates"] = decode_rates(pipe, paths, params_for([(400, 300)] * 64))
        batch, fails = pipe.load_batch(pngs, 416, 416, png_params)
        from_raw, raw_fails = pipe.load_batch_raw(raws, 416, 416, png_params)
        check(fails == raw_fails == 0, "the batch assembler failed an image")
        check(np.array_equal(batch, from_raw), "decode+augment differs from augment of the decode")
    report["host_threads"] = pipe.n_threads
    emit("native", **report)
    return report


def host_copy(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def assert_state_equal(got: dict, params_cpu, mom_cpu, counters: dict, where: str) -> None:
    """Restored params and momentum on the card, bit-equal to the host copy
    taken at the save; counters equal."""
    check(got["counters"] == counters, f"{where}: counters {got['counters']} != {counters}")
    for key, want in (("params", params_cpu), ("momentum", mom_cpu)):
        have = dict(tree_leaves_with_path(got[key]))
        for path, w in tree_leaves_with_path(want):
            t = have[path]
            check(t.device.type == torch.device(DEVICE).type and t.dtype == w.dtype,
                  f"{where}: {key} {path} on {t.device} as {t.dtype}")
            check(torch.equal(t.cpu(), w), f"{where}: {key} {path} differs from the saved copy")


def bn_launch_counts(s: dict) -> tuple[int, int]:
    """bn_sums forward and backward kernels in a trace summary."""
    fwd = sum(n for k, n in s["counts"].items()
              if "bn_sums_vec_kernel" in k or "bn_sums_scalar_kernel" in k)
    bwd = sum(n for k, n in s["counts"].items() if "bn_sums_bwd_kernel" in k)
    return fwd, bwd


def phase_ckpt(seed: int, smi: str) -> dict:
    """Full-state checkpoints of the meta-training step at full width: 2
    steps, a synchronous save, an async save (FSD_ASYNC_CKPT=1) with a step
    launched while it writes, both restored into a fresh parameter tree on
    the card bit-equal to the host copies taken at the saves; then a
    torch.profiler trace of 3 steps whose summary must name the bn_sums
    kernels, 29 + 29 a step. Returns the bn_sums launches of its steps."""
    dblocks, lblocks = parse_cfg(DARKNET_CFG), parse_cfg(LEARNET_CFG)
    spec = MetaSpec(build_spec(dblocks), build_spec(lblocks))
    sched = schedule_from_cfg(dblocks[0], TRAIN_NEG_RATIO, TRAIN_N_CLS)
    trainer = MetaTrainer(spec, momentum=sched.momentum, weight_decay=sched.weight_decay,
                          metain_type=2, image_dtype=torch.bfloat16, warmup_seen=12800,
                          device=DEVICE)
    params, _ = load_train_state(spec)
    mom = init_momentum(params)
    episodes = [make_episode(seed + 300 + i, sched.batch_size, TRAIN_N_CLS, 416, "bfloat16")
                for i in range(2)]
    seen, processed = SEEN, SEEN // sched.batch_size
    report = {"card": smi, "dtype": "bfloat16", "batch": sched.batch_size, "n_cls": TRAIN_N_CLS}
    torch.cuda.synchronize()
    zero_bn_counts()
    steps = 0

    def step(i):
        nonlocal params, mom, seen, processed, steps
        seen += sched.batch_size
        params, mom, metrics = trainer.step(params, mom, episodes[i % 2], seen=seen,
                                            lr=sched.lr(processed))
        processed += 1
        steps += 1
        return metrics

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        ckdir = os.path.join(d, "ckpt")
        losses = [float(format_loss_line(seen, step(i)).rsplit(" ", 1)[-1]) for i in range(2)]
        check(all(np.isfinite(losses)), f"losses {losses}")
        try:
            # synchronous save
            want_sync = (host_copy(params), host_copy(mom),
                         {"seen": seen, "processed_batches": processed, "step": 2})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            os.environ["FSD_ASYNC_CKPT"] = "0"
            path_sync = save_train_state(ckdir, 2, params, mom, seen, processed)
            report["sync_save_s"] = time.perf_counter() - t0
            # asynchronous save, one step launched while it writes
            want_async = (host_copy(params), host_copy(mom),
                          {"seen": seen, "processed_batches": processed, "step": 3})
            os.environ["FSD_ASYNC_CKPT"] = "1"
            t0 = time.perf_counter()
            path_async = save_train_state(ckdir, 3, params, mom, seen, processed)
            report["async_save_return_s"] = time.perf_counter() - t0
            step(0)
            torch.cuda.synchronize()
            report["step_during_write_s"] = time.perf_counter() - t0
            wait_for_saves()
            report["async_save_done_s"] = time.perf_counter() - t0
        finally:
            os.environ.pop("FSD_ASYNC_CKPT", None)
        report["state_bytes"] = os.path.getsize(os.path.join(path_async, "state.pt"))
        check(latest_checkpoint(ckdir) == path_async, "latest_checkpoint is not the async save")
        # restore both into a fresh tree on the card
        for path, (p_cpu, m_cpu, counters) in ((path_sync, want_sync), (path_async, want_async)):
            fresh, _ = load_train_state(spec)
            t0 = time.perf_counter()
            got = restore_train_state(path, {"params": fresh, "momentum": init_momentum(fresh)})
            torch.cuda.synchronize()
            report[f"restore_s_step{counters['step']}"] = time.perf_counter() - t0
            assert_state_equal(got, p_cpu, m_cpu, counters, os.path.basename(path))
            del got, fresh
        report["restored_bit_equal"] = 2
        # a torch.profiler trace of 3 steps (utils/profiling.trace opens it
        # with spin kernels), taken again if it lost every device event (see
        # TRACE_ATTEMPTS)
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            with trace(os.path.join(d, f"trace{attempt}"), device=DEVICE) as trace_path:
                for i in range(3):
                    step(i)
                torch.cuda.synchronize()
            events = load_events(trace_path)
            summary = summarize(events)
            if "no GPU events" not in summary["device"]:
                break
        fwd, bwd = bn_launch_counts(summary)
        device_events = sorted((e["ts"], e["name"]) for e in events
                               if e.get("ph") == "X" and e.get("cat") == "kernel")
        report.update(trace_device=summary["device"], traces_taken=attempt,
                      trace_first_kernels=[n[:60] for _, n in device_events[:2]],
                      trace_total_ms=summary["total_us"] / 1e3,
                      trace_bn_fwd=fwd, trace_bn_bwd=bwd,
                      trace_top=sorted(summary["categories"].items(), key=lambda kv: -kv[1])[:6])
        check((fwd, bwd) == (3 * BN_LAYERS, 3 * BN_LAYERS),
              f"the trace of 3 steps names {fwd} + {bwd} bn_sums kernels")
    launches = bn_counts()
    check_bn_counts(f"{steps} ckpt steps", launches, steps * BN_LAYERS)
    emit("ckpt", steps=steps, launches=launches, **report)
    return launches


def run_cli(fn, env: dict) -> str:
    """fn() with the environment `env` set (restored after); returns what it
    printed."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return buf.getvalue()


LOSS_RE = re.compile(r"^(\d+): nGT \d+, .* total (\S+)$", re.M)
TIMER_RE = re.compile(r"^\S+ \S+ (data .* images/s)$", re.M)


def phase_files(seed: int, smi: str) -> dict:
    """The slice's path on image files: a painted VOC devkit, the port's
    data/prep.py, few-shot tuning through train_meta_cli.main from the
    tracked checkpoint on the native loader in worker processes with
    full-state checkpoints and traces, a resumed run, then the ensemble
    sweep over the test list and voc_eval. Returns the kernels' launches."""
    report = {"card": smi}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as root:
        os.chdir(root)  # the sweep writes results/ under the working directory
        try:
            t0 = time.perf_counter()
            devkit = paint_devkit(root, seed)
            report["paint_s"] = time.perf_counter() - t0
            # -- data preparation through the port's data/prep.py
            lists_dir, voclist = os.path.join(root, "lists"), os.path.join(root, "voclist")
            os.makedirs(lists_dir)
            sets = [("2007", "train"), ("2007", "test")]
            train_list, test_list = prep.write_voc_labels(devkit, lists_dir, sets=sets)
            prep.write_voc_labels_1c(devkit, voclist, sets=sets)
            prep.gen_bbox_fewlist(train_list, voclist, few_nums=[FILES_SHOT])
            prep.gen_image_fewlist(voclist, few_nums=[FILES_SHOT])
            prep.gen_traindict(voclist, os.path.join(root, "data"), os.path.join(root, "cfg"),
                               few_nums=[FILES_SHOT], gpus="0")
            traindict = os.path.join(root, "data", f"voc_traindict_few5c_{FILES_SHOT}shot.txt")
            box_counts = {}
            for cls in VOC_CLASSES:
                with open(os.path.join(voclist, f"box_{FILES_SHOT}shot_{cls}_train.txt")) as f:
                    box_counts[cls] = len(f.read().split())
            report["box_fewlist_images"] = box_counts

            def datacfg(epochs: int) -> str:
                path = os.path.join(root, f"tune_{epochs}.data")
                with open(path, "w") as f:
                    f.write(f"metayolo=1\nmetain_type=2\ndata=voc\ntuning=1\nneg=1\nrand=0\n"
                            f"scale=0\nmax_epoch={epochs}\nrepeat=1\ndynamic=0\n"
                            f"novel=data/voc_novels.txt\nnovelid=0\nmeta={traindict}\n"
                            f"train={train_list}\nvalid={test_list}\n"
                            f"backup={root}/backup/tune\ngpus=0\n")
                return path

            # -- few-shot tuning from the tracked checkpoint, on files
            init_w = os.path.join(root, "base.weights")
            with open(init_w, "wb") as f:
                f.write(read_bf16_gz(WEIGHTS))
            env = {"FSD_NATIVE": "1", "FSD_NATIVE_BATCH": "1", "FSD_WORKERS": "2",
                   "FSD_ORBAX_DIR": os.path.join(root, "ckpt"), "FSD_ASYNC_CKPT": "1",
                   "FSD_PROFILE_DIR": os.path.join(root, "trace"), "FSD_DTYPE": "bfloat16"}
            bn_total = {}
            runs = []
            for run, epochs in enumerate(FILES_EPOCHS):
                cfg = datacfg(epochs)
                torch.cuda.synchronize()
                zero_bn_counts()
                t0 = time.perf_counter()
                out = run_cli(lambda: train_meta_cli.main(cfg, DARKNET_CFG, LEARNET_CFG, init_w),
                              env)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = bn_counts()
                fwd, bwd = counts["fwd"], counts["bwd"]
                losses = [(int(s), float(v)) for s, v in LOSS_RE.findall(out)]
                timers = TIMER_RE.findall(out)
                check(losses and all(np.isfinite(v) for _, v in losses),
                      f"tuning run {run}: loss lines {losses}")
                check_bn_counts(f"tuning run {run}'s {len(losses)} steps", counts,
                                BN_LAYERS * len(losses))
                add_counts(bn_total, counts)
                # the CLI's "repeat nsamples max_batches batch" line
                nsamples, batch = map(int, re.search(r"^\S+ \S+ 1 (\d+) \d+ (\d+)$", out,
                                                     re.M).groups())
                saved = re.findall(r"save weights to (\S+)$", out, re.M)
                runs.append({"epochs": epochs, "weights": saved[-1], "nsamples": nsamples,
                             "batch": batch, "steps": len(losses),
                             "seconds": seconds, "first_loss_line_seen": losses[0][0],
                             "last_loss_line_seen": losses[-1][0],
                             "losses": [v for _, v in losses], "step_timer": timers,
                             "bn_launches_per_step": [fwd // len(losses), bwd // len(losses)],
                             "resumed": "resuming train state from" in out})
            first, second = runs
            check(not first["resumed"] and second["resumed"], "the second run did not resume")
            check(len(first["step_timer"]) == FILES_EPOCHS[0] and len(second["step_timer"]) == 1,
                  "one StepTimer line an epoch")
            ck = restore_train_state(latest_checkpoint(env["FSD_ORBAX_DIR"]))["counters"]
            per_epoch = first["nsamples"] // first["batch"]
            check(ck == {"seen": second["last_loss_line_seen"],
                         "processed_batches": 3 * per_epoch, "step": 3},
                  f"counters after the resumed run: {ck}")
            check(second["first_loss_line_seen"] == first["last_loss_line_seen"] + first["batch"],
                  "the resumed run did not start from the first run's counters")
            traces = find_trace_files(env["FSD_PROFILE_DIR"])
            check(len(traces) == FILES_EPOCHS[1], f"{len(traces)} traces for {FILES_EPOCHS[1]} epochs")
            fwd_t, bwd_t = bn_launch_counts(summarize(load_events(traces[-1])))
            check((fwd_t, bwd_t) == (BN_LAYERS * per_epoch,) * 2,
                  f"the resumed epoch's trace names {fwd_t} + {bwd_t} bn_sums kernels")
            report["tuning"] = runs
            report["checkpoints"] = sorted(os.listdir(env["FSD_ORBAX_DIR"]))
            # -- the ensemble sweep on the tuned weights, over the test list
            tuned = second["weights"]
            check(tuned.endswith(f"{FILES_EPOCHS[1]:06d}.weights"), f"tuned weights {tuned}")
            data_options, _, _, settings = resolve_configs(datacfg(FILES_EPOCHS[1]), DARKNET_CFG,
                                                           LEARNET_CFG)
            torch.cuda.synchronize()
            nms_rows.launches = 0
            t0 = time.perf_counter()
            printed = run_cli(lambda: valid.run_valid_ensemble(
                data_options, DARKNET_CFG, LEARNET_CFG, tuned, settings, batch_size=BATCH),
                {"FSD_NATIVE": "1"})
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
            nms_launches = nms_rows.launches
            prefix = printed.split("saving to: ", 1)[1].split()[0]
            files = sorted(n for n in os.listdir(prefix) if n.startswith("comp4_det_test_"))
            check(len(files) == 20, f"{len(files)} result files")
            # a batch whose rows overflow the buffer goes to the host path
            check(1 <= nms_launches <= FILES_TEST_IMAGES // BATCH,
                  f"{nms_launches} NMS launches for {FILES_TEST_IMAGES // BATCH} sweep batches")
            ev = run_cli(lambda: do_python_eval(
                os.path.join(prefix, "comp4_det_test_"), devkit_path=devkit,
                output_dir=os.path.join(root, "output")), {})
            result = [l for l in ev.splitlines() if l.startswith("Mean AP")]
            m_ap = float(result[0].split("=")[1])
            check(np.isfinite(m_ap), f"mAP {m_ap}")
            report.update(sweep_s=sweep_s, sweep_images=FILES_TEST_IMAGES,
                          nms_launches=nms_launches, result_files=len(files), map_painted=m_ap)
        finally:
            os.chdir(cwd)
    emit("files", **report)
    return {"bn": bn_total, "nms": {"launches": nms_launches}}


# the workflow phase's cuts, against the flagship mode's defaults (512 + 128
# images, 1600 plain and 3500 base batches, tuning 200 epochs / repeat 20):
# the fewest images that fill every class's 10-shot box budget at seed 7,
# and the fewest batches that reach the plain and base stages' first
# checkpoint (written every 10 epochs)
WORKFLOW_ARGS = ("--n-train", "220", "--n-test", "32", "--plain-batches", "70",
                 "--base-batches", "70", "--tune-max-epoch", "1", "--tune-repeat", "1")
WORKFLOW_LOGS = {"plain": "plain", "base": "base", "tune": "tune", "evalb": "eval_base",
                 "evalt": "eval_tune"}
WORKFLOW_BN_LAYERS = {"plain": PLAIN_BN_LAYERS, "base": BN_LAYERS, "tune": BN_LAYERS}
# a barely trained head passes most of a row's 845 anchors at the sweep's
# threshold: a buffer of every anchor keeps each batch on the device path (a
# batch whose rows overflow the default 256 is rightly redone on the host,
# with the same rows, and launches no kernel)
WORKFLOW_EVAL_ENV = {"FSD_DEVICE_NMS_K": str(PLAIN_TOP_K)}


def workflow_stage(name: str, run, root: str, env: dict) -> tuple[dict, dict]:
    """One stage of a workflow (`cli/workflow.py`, `cli/workflow_coco.py`) on
    the card: `run()` runs it with `env` set. Its seconds and kernel launches
    are read right after it; a training stage's loss lines (its log under
    `root`) must be finite with one bn_sums launch a BN layer a step each
    way (and one of bn_act), a sweep must launch the NMS kernel. Returns
    (the stage's report, the workflow's WORKFLOW summary)."""
    torch.cuda.synchronize()
    zero_bn_counts()
    nms_rows.launches = 0
    t0 = time.perf_counter()
    out = run_cli(run, env)
    torch.cuda.synchronize()
    stage = {"seconds": time.perf_counter() - t0, "bn": bn_counts(), "nms_rows": nms_rows.launches}
    summary = json.loads(out.rsplit("WORKFLOW ", 1)[1].splitlines()[0])
    check(name in summary, f"workflow stage {name} did not finish")
    if name in WORKFLOW_LOGS:
        with open(os.path.join(root, "logs", f"{WORKFLOW_LOGS[name]}.log")) as f:
            text = f.read()
        losses = [float(v) for _, v in LOSS_RE.findall(text)]
        stage["steps"] = len(losses)
        if name in WORKFLOW_BN_LAYERS:
            check(losses and all(np.isfinite(v) for v in losses),
                  f"workflow {name}: loss lines {losses[:5]}")
            check_bn_counts(f"workflow {name}'s {len(losses)} steps", stage["bn"],
                            WORKFLOW_BN_LAYERS[name] * len(losses))
            stage.update(first_loss=losses[0], last_loss=losses[-1],
                         step_timer=TIMER_RE.findall(text))
        else:
            check(nms_rows.launches >= 1, f"workflow {name}: no NMS launch")
    return stage, summary


def stage_launches(stages: dict, other: dict | None = None) -> dict:
    """The kernel launches of a workflow's stages (and the bn counts `other`
    of other work of the phase), summed."""
    bn = add_counts({}, other or {})
    for st in stages.values():
        add_counts(bn, st["bn"])
    return {"bn": bn, "nms": {"launches": sum(st["nms_rows"] for st in stages.values())}}


def phase_workflow(smi: str, workdir: str) -> dict:
    """The paper's whole workflow in the flagship mode, stage by stage
    through cli/workflow.main on the card, its root under `workdir` (the
    `analysis` phase reads it again). No base artifact is read or written
    (both of the workflow's artifact directories point under `workdir`)."""
    from fewshot_detection_tpu_torch.cli import workflow

    report = {"card": smi, "reduced": dict(zip(WORKFLOW_ARGS[::2], WORKFLOW_ARGS[1::2])),
              "stages": {}}
    artifacts = workflow.ARTIFACTS, workflow.SEED_ARTIFACTS
    d = os.path.join(workdir, "workflow")
    workflow.ARTIFACTS = workflow.SEED_ARTIFACTS = os.path.join(d, "artifacts")
    root = os.path.join(d, "root")
    try:
        for name, _ in workflow.STAGES:
            report["stages"][name], summary = workflow_stage(
                name, lambda: workflow.main(
                    ["--root", root, "--device", "cuda", "--stage", name, *WORKFLOW_ARGS]),
                root, WORKFLOW_EVAL_ENV if name.startswith("eval") else {})
    finally:
        workflow.ARTIFACTS, workflow.SEED_ARTIFACTS = artifacts
    for name in ("evalb", "evalt"):
        m_ap = summary[name]["mean_ap"]
        check(np.isfinite(m_ap), f"workflow {name}: mAP {m_ap}")
        report[f"{name}_map"] = {k: summary[name][k] for k in ("mean_ap", "base_mean", "novel_mean")}
    report["workflow"] = {k: {kk: v for kk, v in summary[k].items() if kk != "aps"}
                          for k in summary}
    report["seconds"] = sum(st["seconds"] for st in report["stages"].values())
    emit("workflow", **report)
    return stage_launches(report["stages"])


# ---------------------------------------------------------------------------
# coco: the paper's COCO protocol (60 base / 20 novel classes) at full width
# ---------------------------------------------------------------------------

# The COCO workflow's batch (cli/workflow_coco.py) and its two episodic
# steps: the 60-way base step (base.data: neg=1) and the 80-way tuning step
# (tune.data: neg=0), both from the seeded initial weights, with the global
# norm clipped as the workflow's stages clip it from random weights
COCO_BATCH = 32
COCO_STEPS = {"base": (60, 1), "tune": (80, 0)}
COCO_TIMED_STEPS = 3
# the first step's class loss per object against ln(n_cls), the value of
# uniform class scores, which the seeded weights give
COCO_CLS_TOL = 0.25
# cli/workflow_coco.py's depth, cut: the fewest train images whose pools fill
# every class's 10-shot box budget at the workflow's seed 11 (720 of 1200),
# the fewest plain and base batches that reach the first checkpoint (COCO
# saves every 2 epochs; both lists keep the 601 images with a base class,
# and 19 * 32 >= 601 makes 2 epochs), and 32 test images (2 sweep batches;
# the sweeps' host tail and the scoring grow with 80 classes of nearly 845
# candidates a row). The tuning keeps its 2 epochs, each over the fewset once
# (max_epoch 2 / repeat 1, where the recipe has 4 / 2: half the steps, so the
# whole smoke stays near 800 s with the bench phase); class counts, widths,
# shots and cfgs are not cut.
COCO_REDUCED = {"N_TRAIN": 720, "N_TEST": 32, "PLAIN_BATCHES": 19, "BASE_BATCHES": 19,
                "TUNE_MAX_EPOCH": 2, "TUNE_REPEAT": 1}
COCO_EVAL_CLASSES = {"evalb": 60, "evalt": 80}


class SweepClock:
    """Where an ensemble sweep's time goes, by standing in for the sweep
    (`valid._meta_sweep`, which also fills its stats), its class codes
    (`valid._ensemble_codes`), the host tail's copy and box lists
    (`device_pipeline._rows_to_eval_boxes`), the result-file writer
    (`valid._write_meta_batch`) and the scorer (`voc_eval.do_python_eval`)."""

    TARGETS = {"sweep": (valid, "_meta_sweep"), "codes": (valid, "_ensemble_codes"),
               "d2h_and_lists": (device_pipeline, "_rows_to_eval_boxes"),
               "write": (valid, "_write_meta_batch"),
               # the package exports the function voc_eval under the module's name
               "score": (importlib.import_module("fewshot_detection_tpu_torch.eval.voc_eval"),
                         "do_python_eval")}

    def __init__(self):
        self.seconds = {k: 0.0 for k in self.TARGETS}
        self.calls = {k: 0 for k in self.TARGETS}
        self.stats: dict = {}
        self._orig = {k: getattr(mod, attr) for k, (mod, attr) in self.TARGETS.items()}

    def _timed(self, key):
        fn = self._orig[key]

        def run(*args, **kw):
            if key == "sweep":
                kw["stats"] = self.stats
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                if key in ("sweep", "codes"):
                    torch.cuda.synchronize()
                self.seconds[key] += time.perf_counter() - t0
                self.calls[key] += 1
        return run

    def __enter__(self):
        for key, (mod, attr) in self.TARGETS.items():
            setattr(mod, attr, self._timed(key))
        return self

    def __exit__(self, *exc):
        for key, (mod, attr) in self.TARGETS.items():
            setattr(mod, attr, self._orig[key])

    def report(self, n_images: int) -> dict:
        batches = max(self.stats.get("batches", 0), 1)
        return {"sweep_images": n_images, "sweep_seconds": self.seconds["sweep"],
                "sweep_images_per_s": n_images / self.seconds["sweep"],
                "class_codes_seconds": self.seconds["codes"],
                "d2h_and_lists_ms": self.seconds["d2h_and_lists"] / batches * 1e3,
                "write_ms": self.seconds["write"] / batches * 1e3,
                "score_seconds": self.seconds["score"], **self.stats}


def coco_step_runs(seed: int) -> dict:
    """The 60-way base step and the 80-way tuning step at full width
    (cfg/darknet_dynamic.cfg + cfg/reweighting_net.cfg, 416 px, batch 32,
    painted noisy episodes) from the seeded initial weights, float32 (TF32
    off) and bfloat16, TRAIN_WARMUP_STEPS + COCO_TIMED_STEPS each: images/s,
    peak memory, 29 + 29 launches a step, finite losses, the first step's
    class loss per object beside ln(n_cls). Returns the launches."""
    from fewshot_detection_tpu_torch.cli import workflow

    dblocks, lblocks = parse_cfg(DARKNET_CFG), parse_cfg(LEARNET_CFG)
    spec = MetaSpec(build_spec(dblocks), build_spec(lblocks))
    init = init_meta_params(spec, seed)
    total = {}

    def load_params():
        return require_grads({k: from_jax_params(getattr(spec, k), init[k], DEVICE)
                              for k in ("darknet", "learnet")})

    for step, (n_cls, neg) in COCO_STEPS.items():
        sched = schedule_from_cfg({**dblocks[0], "batch": str(COCO_BATCH)}, neg, n_cls)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            episodes = [make_episode(seed + i, COCO_BATCH, n_cls, 416, name, neg_ratio=neg)
                        for i in range(TRAIN_WARMUP_STEPS + COCO_TIMED_STEPS)]
            check(tuple(episodes[0]["metax"].shape) == (1, n_cls, 416, 416, 3), "support shape")
            trainer = MetaTrainer(spec, momentum=sched.momentum,
                                  weight_decay=sched.weight_decay, metain_type=2,
                                  clip_norm=float(workflow.STAGE_ENV["FSD_CLIP_NORM"]),
                                  image_dtype=dtype, warmup_seen=12800, device=DEVICE)
            got = timed_steps(trainer, load_params, episodes, sched.lr, 0, COCO_BATCH, BN_LAYERS)
            cls_per_gt = got["first_step"]["loss_cls"] / max(got["first_step"]["nGT"], 1.0)
            emit("coco_step", step=step, n_cls=n_cls, neg=neg, dtype=name, batch=COCO_BATCH,
                 size=416, timed_steps=COCO_TIMED_STEPS, **got, cls_per_gt=cls_per_gt,
                 ln_n_cls=float(np.log(n_cls)))
            check(abs(cls_per_gt / np.log(n_cls) - 1) <= COCO_CLS_TOL,
                  f"coco {step} {name}: first class loss {cls_per_gt} per object, "
                  f"against ln {n_cls}")
            add_counts(total, got)
            del episodes, trainer
            torch.cuda.empty_cache()
    return total


def phase_coco(seed: int, smi: str) -> dict:
    """The COCO protocol at full width: the two episodic steps timed
    (`coco_step_runs`), then cli/workflow_coco.py stage by stage on the card
    at COCO_REDUCED's depth (`workflow_stage`), the sweeps with a buffer of
    every anchor and their time broken down (`SweepClock`), scored over 60
    and over 80 classes. Returns the launches."""
    from fewshot_detection_tpu_torch.cli import workflow_coco

    t_phase = time.perf_counter()
    steps = coco_step_runs(seed)
    report = {"card": smi, "reduced": dict(COCO_REDUCED), "stages": {}}
    saved = {k: getattr(workflow_coco, k) for k in COCO_REDUCED}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coco_") as d:
        root = os.path.join(d, "root")
        try:
            for k, v in COCO_REDUCED.items():
                setattr(workflow_coco, k, v)
            for name, _ in workflow_coco.STAGES:
                with SweepClock() as clock:
                    stage, summary = workflow_stage(
                        name, lambda: workflow_coco.main(
                            ["--root", root, "--device", "cuda", "--stage", name]),
                        root, WORKFLOW_EVAL_ENV if name.startswith("eval") else {})
                if name in ("base", "tune"):
                    stage["cls"] = summary[name]["cls"]
                if name in COCO_EVAL_CLASSES:
                    res = summary[name]
                    check(res["n_classes"] == len(res["aps"]) == COCO_EVAL_CLASSES[name],
                          f"coco workflow {name}: {res['n_classes']} classes scored")
                    check(all(np.isfinite(v) for v in [res["mean_ap"], *res["aps"].values()]),
                          f"coco workflow {name}: APs {res['mean_ap']}")
                    sweep = clock.report(COCO_REDUCED["N_TEST"])
                    check(sweep["device_batches"] == sweep["batches"] == stage["nms_rows"],
                          f"coco workflow {name}: {stage['nms_rows']} NMS launches for "
                          f"{sweep['device_batches']} of {sweep['batches']} batches on the device")
                    stage.update(sweep=sweep, **{k: res[k] for k in (
                        "n_classes", "mean_ap", "base_mean", "novel_mean")})
                report["stages"][name] = stage
        finally:
            for k, v in saved.items():
                setattr(workflow_coco, k, v)
    report["workflow_seconds"] = sum(st["seconds"] for st in report["stages"].values())
    report["seconds"] = time.perf_counter() - t_phase
    emit("coco", **report)
    return stage_launches(report["stages"], steps)


def phase_coco_kernels(rec: PathInputs, seed: int) -> dict:
    """Both kernels timed at the COCO path's largest inputs, after the path
    ran: bn_sums forward and backward (and their plain versions and library
    calls) at its largest (M, C), float32 and bfloat16; nms_rows on its
    sweeps' largest rows (R = 16 images x 80 classes)."""
    m, c = max(((m, c) for m, c, _ in rec.bn), key=lambda t: t[0] * t[1])
    times = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        x = make_activation(seed + 200 + i, m, c, dtype)
        times[str(dtype).split(".")[-1]] = time_bn_sums(x)
        del x
        torch.cuda.empty_cache()
    (r, k), (boxes, dsel) = max(rec.nms.items(), key=lambda kv: kv[0][0] * kv[0][1])
    nms = compare_kernel(boxes, dsel, timed=True)
    check(nms["max_mismatch"] == 0, "nms_rows disagrees on the COCO sweep's rows")
    emit("coco_kernels", bn_shape=[m, c], bn_times=times, nms=nms)
    return {"bn_shape": [m, c], "bn_times": times, "nms": nms}


# ---------------------------------------------------------------------------
# dp: data parallelism over torch.distributed (parallel/mesh.py)
# ---------------------------------------------------------------------------

# The card's host has one H100, so the worlds run on it: a world of one under
# NCCL (its own process), and a world of two under gloo with both ranks on
# cuda:0 (NCCL refuses two ranks on one device; gloo's collectives are staged
# through host copies). Each world is a set of spawned processes joined with
# DP_WORLD_SECONDS; a rank that fails or runs past it fails the phase.
DP_WORLD_SECONDS = 300
# world: (ranks, backend, the device every rank computes on)
DP_WORLDS = {"nccl1": (1, "nccl", "cuda"), "gloo2": (2, "gloo", "cuda:0")}
DP_GROUPS = 2
DP_TIMED_STEPS = 3
DP_SWEEP_IMAGES = 16
DP_SUPPORT_IMAGES = 40
DP_SWEEP_BATCH = 5  # 16 = 5 + 5 + 5 + 1: every batch padded to a multiple of 2 ranks
# result files of the sharded sweep against one process's: the same rows,
# each probability within DP_FILES_TOL of its value (relative: the bound the
# repo holds result files to, tests/test_torch_plain_valid.py) and each
# corner within DP_FILES_PX pixels plus DP_FILES_TOL of its value. A rank
# runs a block of 3 or 1 images where one process runs 5, and cuDNN rounds
# another batch size otherwise: a float32 step (about 1e-6 of a box's
# normalised coordinate) is a few 1e-4 px on a corner of a few hundred px,
# which may lie near 0 (on the H100, 2.1e-4 px at -0.76 px)
DP_FILES_TOL = 1e-4
DP_FILES_PX = 1e-3


def dp_meta(seed: int):
    """The `train` phase's meta step at the cfg's batch 64 in float32 (TF32
    off), split into DP_GROUPS replica groups of 32: (batch, seen, lr,
    make_trainer(mesh), load_params)."""
    dblocks, lblocks = parse_cfg(DARKNET_CFG), parse_cfg(LEARNET_CFG)
    spec = MetaSpec(build_spec(dblocks), build_spec(lblocks))
    sched = schedule_from_cfg(dblocks[0], TRAIN_NEG_RATIO, TRAIN_N_CLS)
    batch = make_episode(seed, sched.batch_size, TRAIN_N_CLS, 416, "float32", DP_GROUPS)

    def make_trainer(mesh):
        return MetaTrainer(spec, momentum=sched.momentum, weight_decay=sched.weight_decay,
                           metain_type=2, image_dtype=torch.float32, warmup_seen=12800,
                           device=mesh.device if mesh else DEVICE, mesh=mesh)

    return (batch, SEEN + sched.batch_size, sched.lr(SEEN // sched.batch_size), make_trainer,
            lambda: load_train_state(spec)[0])


def dp_plain(seed: int):
    """PlainTrainer on cfg/yolo-voc.cfg from the seeded weights, batch 64 in
    DP_GROUPS groups, float32: as `dp_meta`."""
    setup = PlainTrainSetup(seed)
    batch = make_plain_episode(seed + 100, setup.sched.batch_size, "float32", DP_GROUPS)

    def make_trainer(mesh):
        return PlainTrainer(setup.spec, momentum=setup.sched.momentum,
                            weight_decay=setup.sched.weight_decay, image_dtype=torch.float32,
                            device=mesh.device if mesh else DEVICE, mesh=mesh)

    return batch, setup.sched.batch_size, setup.sched.lr(0), make_trainer, setup.load_params


def dp_step(setup, mesh=None, timed: int = 0) -> dict:
    """One step of `setup` (dp_meta / dp_plain) from fresh parameters, with
    this rank's groups when there is a mesh: its loss, the norm of each
    leaf's update and of the whole tree's, a digest of the parameters and
    momentum after it, the bn_sums launches and collectives of the step
    (counts set to 0 just before, read just after), peak memory; then
    `timed` more steps after one warm-up, for images/s."""
    batch, seen, lr, make_trainer, load_params = setup
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    params = load_params()
    start = {p: t.detach().clone() for p, t in tree_leaves_with_path(params)}
    mom = init_momentum(params)
    trainer = make_trainer(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives = mesh.collectives if mesh else 0
    zero_bn_counts()
    params, mom, metrics = trainer.step(params, mom, batch, seen=seen, lr=lr)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    launches = bn_counts()
    collectives = (mesh.collectives if mesh else 0) - collectives
    norms = {p: float((t.detach() - start[p]).double().norm())
             for p, t in tree_leaves_with_path(params)}
    digest = hashlib.sha256()
    for tree in (params, mom):
        for _, t in tree_leaves_with_path(tree):
            digest.update(t.detach().cpu().numpy().tobytes())
    report = {"loss": loss, "norms": norms, "all": sum(v * v for v in norms.values()) ** 0.5,
              "digest": digest.hexdigest(), "launches": launches, "collectives": collectives,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "groups": int(batch["x"].shape[0]), "images": int(np.prod(batch["x"].shape[:2]))}
    if timed:
        trainer.step(params, mom, batch, seen=seen, lr=lr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            _, _, metrics = trainer.step(params, mom, batch, seen=seen, lr=lr)
            float(metrics["loss"])  # the step's one host sync, as in the main path
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        world = mesh.size if mesh else 1
        report["images_per_s"] = timed * report["images"] * world / seconds
    del params, mom, start, trainer
    torch.cuda.empty_cache()
    return report


def dp_sweep_files(root: str, data_options, settings, tag: str, env: dict) -> tuple:
    """run_valid_ensemble on the serve phase's cfgs and checkpoint over the
    painted list at DP_SWEEP_BATCH, as valid_ensemble_torch.py runs it (under
    `env`), the NMS count set to 0 just before and read just after: (the
    result files' lines, on the rank that writes them, else None; launches)."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        nms_rows.launches = 0
        printed = run_cli(lambda: valid.run_valid_ensemble(
            data_options, DARKNET_CFG, LEARNET_CFG, WEIGHTS, settings, outfile=tag,
            batch_size=DP_SWEEP_BATCH, device=DEVICE), env)
        torch.cuda.synchronize()
        launches = nms_rows.launches
        if "saving to: " not in printed:
            return None, launches
        prefix = os.path.join(root, printed.split("saving to: ", 1)[1].split()[0])
        files = {}
        for name in VOC_CLASSES:
            with open(os.path.join(prefix, f"{tag}{name}.txt")) as f:
                files[name] = f.read().splitlines()
        return files, launches
    finally:
        os.chdir(cwd)


def dp_sweep_inputs(root: str, seed: int | None = None):
    """(data options, settings) of DP_SWEEP_IMAGES images of the workflow's
    synthetic style as PNG files, with the support list of DP_SUPPORT_IMAGES
    (data/synth.py), read through the native decoders; painted under `root`
    when a seed is given, else those painted there before."""
    datacfg = os.path.join(root, "dp.data")
    if seed is None:
        data_options, _, _, settings = resolve_configs(datacfg, DARKNET_CFG, LEARNET_CFG)
        return data_options, settings
    # the support list needs every class: paint more, sweep the first 16
    d = make_voc_like(os.path.join(root, "voc"), n_images=DP_SUPPORT_IMAGES,
                      size=INT8_IMG_SIZE, seed=seed, style="huebin", box_range=(0.15, 0.45))
    valid_list = os.path.join(root, "dp_valid.txt")
    with open(d["train_list"]) as src, open(valid_list, "w") as dst:
        dst.writelines(src.readlines()[:DP_SWEEP_IMAGES])
    with open(datacfg, "w") as f:
        f.write("metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={d['traindict']}\ntrain={d['train_list']}\n"
                f"valid={valid_list}\nbackup={root}/backup\ngpus=0\n")
    data_options, _, _, settings = resolve_configs(datacfg, DARKNET_CFG, LEARNET_CFG)
    return data_options, settings


DP_SWEEP_ENV = {"FSD_NATIVE": "1", "FSD_DEVICE_NMS_K": str(PLAIN_TOP_K)}


def dp_rank(world: str, env: dict, seed: int, root: str) -> None:
    """One rank of world `world` ("nccl1": a world of one under NCCL, R = 2
    groups on the rank, timed; "gloo2": a world of two under gloo on cuda:0,
    one group a rank, the meta and plain steps and the sharded sweep). Runs
    in a spawned process; writes its report, or its traceback, under `root`."""
    import pickle
    import traceback

    rank = int(env["RANK"])
    out = os.path.join(root, f"{world}_{rank}")
    try:
        os.environ.update(env)
        valid.set_float32_precision(tf32=False)
        from fewshot_detection_tpu_torch.parallel import make_mesh

        n, backend, device = DP_WORLDS[world]
        mesh = make_mesh(n, device=device, backend=backend)
        report = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
                  "device": str(mesh.device)}
        with PathInputs() as rec:
            report["meta"] = dp_step(dp_meta(seed), mesh, DP_TIMED_STEPS if world == "nccl1" else 0)
            if world == "gloo2":
                report["plain"] = dp_step(dp_plain(seed), mesh)
                data_options, settings = dp_sweep_inputs(root)  # the parent painted them
                files, launches = dp_sweep_files(root, data_options, settings, "dp_",
                                                 {**DP_SWEEP_ENV, "FSD_EVAL_MESH": "2"})
                report["sweep"] = {"files": files, "nms_launches": launches}
        report["inputs"] = {"bn": sorted(rec.bn, key=str),
                            "nms": {k: (b.cpu().numpy(), d.cpu().numpy())
                                    for k, (b, d) in rec.nms.items()}}
        report["collectives"] = mesh.collectives
        import torch.distributed as dist

        dist.destroy_process_group()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(report, f)
        os.replace(out + ".tmp", out + ".pkl")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_dp_world(world: str, seed: int, root: str) -> list:
    """Spawn the ranks of `world`, join them within DP_WORLD_SECONDS,
    kill the ones still running then, and return their reports; a rank that
    failed, or did not finish, raises with its traceback."""
    import multiprocessing
    import pickle
    import socket

    n = DP_WORLDS[world][0]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(world, {
        "RANK": str(r), "WORLD_SIZE": str(n), "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port)}, seed, root)) for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, DP_WORLD_SECONDS - (time.perf_counter() - t0)))
    finally:
        late = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = []
    for r in range(n):
        err = os.path.join(root, f"{world}_{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    check(not errors, f"the {world} world failed:\n" + "\n".join(errors))
    check(not late, f"ranks {late} of the {world} world ran past {DP_WORLD_SECONDS} s")
    check(all(p.exitcode == 0 for p in procs),
          f"the {world} world's ranks exited with {[p.exitcode for p in procs]}")
    reports = []
    for r in range(n):
        with open(os.path.join(root, f"{world}_{r}.pkl"), "rb") as f:
            reports.append(pickle.load(f))
    reports[0]["seconds"] = time.perf_counter() - t0
    return reports


def dp_hold(tag: str, got: dict, want: dict) -> dict:
    """A rank's step against the one-process step of the same R groups, as
    two float32 answers are held elsewhere (S2D_TOL: the loss within 1e-5,
    each leaf's update norm within 2e-2, the whole tree's within 2e-4)."""
    loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    whole = abs(got["all"] - want["all"]) / want["all"]
    leaf = max(abs(got["norms"][p] - v) / v for p, v in want["norms"].items() if v)
    check(np.isfinite(got["loss"]) and loss <= S2D_TOL["loss"],
          f"{tag}: loss {got['loss']} against {want['loss']} in one process")
    check(whole <= 2 * S2D_TOL["all"], f"{tag}: whole update norm {whole} off")
    for p, v in want["norms"].items():
        check(abs(got["norms"][p] - v) <= 2 * S2D_TOL["leaf"] * v,
              f"{tag}: update norm of {p}: {got['norms'][p]} against {v}")
    return {"loss_rel": loss, "update_norm_rel_whole_tree": whole,
            "update_norm_rel_worst_leaf": leaf, "bit_equal": got["digest"] == want["digest"]}


def _by_image(lines: list) -> dict:
    """{image id: (k, 5) float64 array of its rows' numbers}, in file order."""
    groups: dict = {}
    for line in lines:
        parts = line.split()
        groups.setdefault(parts[0], []).append([float(v) for v in parts[1:]])
    return {k: np.asarray(v, np.float64).reshape(-1, 5) for k, v in groups.items()}


def dp_files_compared(got: dict, want: dict) -> dict:
    """The sharded sweep's result files against one process's. Line-equal:
    the same classes, and in each class file the same image ids in the same
    order with as many rows each (`same_lines`), and each row within the
    bounds of a row of the same (class, image): DP_FILES_TOL * |p| and one
    printed step (1e-6) for the probability, DP_FILES_PX + DP_FILES_TOL *
    |v| for a corner
    (`worst_over_tolerance` at most 1). Rows are matched greedily to the
    nearest: two boxes of one image whose confidences tie to a few float32
    steps may swap their order when the two runs round otherwise
    (`reordered_groups` counts the (class, image) groups where they did)."""
    same = sorted(got) == sorted(want)
    lines = identical = reordered = 0
    worst, worst_rows = 0.0, None
    for name in want if same else ():
        identical += sum(g == w for g, w in zip(got[name], want[name]))
        g_by, w_by = _by_image(got[name]), _by_image(want[name])
        same &= list(g_by) == list(w_by)
        for img, w in w_by.items():
            g = g_by.get(img, np.zeros((0, 5)))
            if len(g) != len(w):
                same = False
                continue
            lines += len(w)
            # gap[i, j]: row i of `got` against row j of `want`, in tolerances
            room = DP_FILES_TOL * np.abs(w) + np.asarray([1e-6] + [DP_FILES_PX] * 4)
            gap = (np.abs(g[:, None, :] - w[None, :, :]) / room[None]).max(axis=2)
            free, order = np.ones(len(g), bool), []
            for j in range(len(w)):
                i = int(np.argmin(np.where(free, gap[:, j], np.inf)))
                free[i] = False
                order.append(i)
                if gap[i, j] > worst:
                    worst, worst_rows = float(gap[i, j]), [name, img, g[i].tolist(),
                                                          w[j].tolist()]
            reordered += order != list(range(len(w)))
    return {"same_lines": bool(same), "lines": lines, "identical_lines": identical,
            "reordered_groups": reordered, "tolerance": DP_FILES_TOL, "pixels": DP_FILES_PX,
            "worst_over_tolerance": worst, "worst_rows": worst_rows}


def phase_dp(seed: int, smi: str, recorded: PathInputs) -> dict:
    """Data parallelism on the card: the one-process steps and sweep first
    (here, no mesh), then a world of one under NCCL and a world of two under
    gloo (spawned ranks), each rank's inputs added to this path's record.
    Returns the ranks' bn_sums and nms_rows launches."""
    t0 = time.perf_counter()
    meta_one = dp_step(dp_meta(seed), None, DP_TIMED_STEPS)
    plain_one = dp_step(dp_plain(seed), None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        data_options, settings = dp_sweep_inputs(root, seed)
        one_files, one_launches = dp_sweep_files(root, data_options, settings, "one_",
                                                 DP_SWEEP_ENV)
        check(one_launches == -(-DP_SWEEP_IMAGES // DP_SWEEP_BATCH),
              f"the one-process sweep launched nms_rows {one_launches} times")
        torch.cuda.empty_cache()
        nccl = run_dp_world("nccl1", seed, root)
        gloo = run_dp_world("gloo2", seed, root)
    for rep in nccl + gloo:
        recorded.bn |= set(rep["inputs"]["bn"])
        for shape, (b, d) in rep["inputs"]["nms"].items():
            recorded.nms.setdefault(shape, (torch.from_numpy(b).to(DEVICE),
                                            torch.from_numpy(d).to(DEVICE)))
    (n1,), (g0, g1) = nccl, gloo
    report = {"card": smi, "groups": DP_GROUPS, "batch": meta_one["images"], "size": 416,
              "dtype": "float32"}
    # the world of one under NCCL: both groups on the rank, through the mesh
    check(n1["backend"] == DP_WORLDS["nccl1"][1] and n1["size"] == 1,
          f"world of one: {n1['backend']}")
    check(g0["backend"] == DP_WORLDS["gloo2"][1] and g0["size"] == 2,
          f"world of two: {g0['backend']}")
    check(n1["meta"]["groups"] == DP_GROUPS, "the rank of a world of one got every group")
    check_bn_counts("the world of one's step", n1["meta"]["launches"], DP_GROUPS * BN_LAYERS)
    report["nccl_world_of_one"] = {
        "against_one_process": dp_hold("nccl world of one", n1["meta"], meta_one),
        "collectives_per_step": n1["meta"]["collectives"],
        "bn_launches_per_step": n1["meta"]["launches"],
        "images_per_s_mesh": n1["meta"]["images_per_s"],
        "images_per_s_no_mesh": meta_one["images_per_s"],
        "peak_memory_bytes": n1["meta"]["peak_memory_bytes"],
        "peak_memory_bytes_no_mesh": meta_one["peak_memory_bytes"],
        "world_seconds": n1["seconds"]}
    # the world of two under gloo on cuda:0: one group a rank
    for key, one, layers_ in (("meta", meta_one, BN_LAYERS), ("plain", plain_one,
                                                               PLAIN_BN_LAYERS)):
        for rep in (g0, g1):
            check(rep[key]["groups"] == 1, f"a rank of two got {rep[key]['groups']} groups")
            check_bn_counts(f"rank {rep['rank']}'s {key} step", rep[key]["launches"], layers_)
        check(g0[key]["digest"] == g1[key]["digest"],
              f"the two ranks' {key} trees differ after the step")
        report[f"gloo_world_of_two_{key}"] = {
            "ranks_bit_equal": True,
            "against_one_process": dp_hold(f"gloo {key}", g0[key], one),
            "collectives_per_step": g0[key]["collectives"],
            "bn_launches_per_rank": g0[key]["launches"],
            "peak_memory_bytes_by_rank": [g0[key]["peak_memory_bytes"],
                                          g1[key]["peak_memory_bytes"]],
            "peak_memory_bytes_one_process": one["peak_memory_bytes"]}
    report["gloo_world_seconds"] = g0["seconds"]
    # the sharded sweep: rank 0 writes, both ranks launch the NMS kernel
    check(g1["sweep"]["files"] is None, "rank 1 of the sweep wrote files")
    launches = [g0["sweep"]["nms_launches"], g1["sweep"]["nms_launches"]]
    check(all(n > 0 for n in launches), f"nms_rows launches by rank: {launches}")
    report["sharded_sweep"] = {
        "images": DP_SWEEP_IMAGES, "batch": DP_SWEEP_BATCH, "nms_launches_by_rank": launches,
        "nms_launches_one_process": one_launches,
        **dp_files_compared(g0["sweep"]["files"], one_files)}
    report["seconds"] = time.perf_counter() - t0
    emit("dp", **report)
    files = report["sharded_sweep"]
    check(files["same_lines"] and files["lines"] > 0 and files["worst_over_tolerance"] <= 1,
          f"the sharded sweep's files are not line-equal to one process's: {files}")
    bn = {}
    for r in (n1, g0, g1):
        for k in ("meta", "plain"):
            if k in r:
                add_counts(bn, r[k]["launches"])
    return {"bn": bn,
            "nms": {"launches": sum(launches)}}


# ---------------------------------------------------------------------------
# analysis: the eight analysis tools (scripts/*_torch.py) on the card
# ---------------------------------------------------------------------------

# the phase's cuts of the tools' depth, listed as `reduced`
# multiscale_epoch's phase B (30 batches by default): 7 blocks of 64 samples,
# whose sizes on the tool's seeds are 384, 576, 384, 384, 576, 448, 544
MS_EPOCH_BATCHES = 14
# learning_check --full (512 images, 800 batches by default): 218 images of
# base classes, 3 batches of 64 an epoch for 12 epochs (the CLI drops a
# short batch and saves every 10 epochs)
LEARN_ARGS = ("--full", "--images", "256", "--max-batches", "40")
LEARN_ENV = {"FSD_CLIP_NORM": "10"}
# the tiny root at the counts of tests/test_torch_workflow.py's CPU run (and
# its base batch of 16, so that 100 batches reach base training's first
# checkpoint)
TINY_ARGS = ("--tiny", "--seed", "2", "--n-train", "200", "--n-test", "8", "--base-batches",
             "100", "--tune-max-epoch", "1", "--tune-repeat", "1")
TINY_DK_BATCH = 16
SWEEP_SHOTS = "1,2"
SWEEP_TUNING = {"TUNE_MAX_EPOCH": 1, "TUNE_REPEAT": 1}  # the tool's tiny overrides: 10, 20
SNR_DRAWS = 6
# the first draw's codes on the card against the CPU's, over the largest
# absolute code: cuDNN's float32 convolutions (TF32 off) sum in another order
# than the CPU's, and training-mode BatchNorm divides by batch statistics
SNR_CODE_TOL = 1e-3
# the painted WIDER tree: (sub-directory, file, (height, width)). An image
# under the kernel's shared-memory limit, portrait ones over it (1024 x 1376:
# 32 * 43 * 5 = 6,880 candidates; 1024 x 2560, the largest the tool admits:
# 12,800), and one over the omit limit
WIDER_TREE = (("0--Parade", "0_Parade_1.png", (480, 640)),
              ("0--Parade", "0_Parade_2.png", (1376, 1024)),
              ("1--Handshaking", "1_Handshaking_1.png", (2560, 1024)),
              ("1--Handshaking", "1_Handshaking_2.png", (2600, 1040)))
WIDER_OMITTED = ("1_Handshaking_2.png",)
ANALYSIS_ENV = {"FSD_NATIVE": "1", "FSD_DEVICE_NMS_K": str(PLAIN_TOP_K)}


def load_tool(name: str) -> dict:
    """scripts/<name>_torch.py's globals (its work sits under the __main__
    check)."""
    return load_script(os.path.join("scripts", f"{name}_torch.py"), name)


def load_script(relpath: str, run_name: str = "smoke_script") -> dict:
    """A script's globals (its work sits under the __main__ check)."""
    import runpy

    return runpy.run_path(os.path.join(REPO, relpath), run_name=run_name)


def counted(fn, env: dict):
    """fn() under `env` with every kernel count set to 0 just before and
    read just after: (its result, what it printed, the counts, seconds)."""
    torch.cuda.synchronize()
    zero_bn_counts()
    nms_rows.launches = nms_rows.long_launches = 0
    box = {}
    t0 = time.perf_counter()
    out = run_cli(lambda: box.setdefault("result", fn()), env)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"bn": bn_counts(), "nms_rows": nms_rows.launches,
              "nms_rows_long": nms_rows.long_launches}
    return box.get("result"), out, counts, seconds


def analysis_multiscale(root: str) -> dict:
    """multiscale_epoch at flagship width, batch 32, every bucket, phase B
    cut to MS_EPOCH_BATCHES: each bucket's steps finite with 29 + 29 bn_sums
    launches, and at least 3 sizes crossed."""
    tool = load_tool("multiscale_epoch")
    result, out, counts, seconds = counted(lambda: tool["main"](
        ["--batch", "32", "--batches", str(MS_EPOCH_BATCHES), "--root", root,
         "--device", DEVICE]), ANALYSIS_ENV)
    steps = 4 * len(result["buckets"]) + MS_EPOCH_BATCHES
    check_bn_counts(f"multiscale's {steps} steps", counts["bn"], BN_LAYERS * steps)
    check(list(result["buckets"]) == tool["SIZES"], f"buckets {list(result['buckets'])}")
    check(all(np.isfinite(b["img_per_s"]) and b["peak_hbm_gib"] for b in
              result["buckets"].values()), "multiscale bucket numbers")
    check(len(result["epoch"]["sizes_crossed"]) >= 3, f"the epoch crossed too few sizes: {result}")
    check(out.splitlines()[0].startswith(f"device: {DEVICE} "), out.splitlines()[0])
    return {"msjson": result, "seconds": seconds, **counts}


def analysis_support_snr(root: str, workdir: str) -> dict:
    """support_snr on the tracked checkpoint (decoded into a .weights file)
    with the flagship cfgs over the multiscale tree's supports, 15-way,
    SNR_DRAWS draws on the card; the first draw again on the CPU."""
    tool = load_tool("support_snr")
    wpath = os.path.join(workdir, "base_latest.weights")
    with open(wpath, "wb") as f:
        f.write(read_bf16_gz(WEIGHTS))
    datacfg = os.path.join(root, "m.data")
    args = (datacfg, DARKNET_CFG, LEARNET_CFG, wpath)
    codes, out, counts, seconds = counted(
        lambda: tool["draw_codes"](*args, n_draws=SNR_DRAWS, device=DEVICE), ANALYSIS_ENV)
    summary = tool["summarize"](codes)
    check(summary["n_cls"] == TRAIN_N_CLS and summary["n_draws"] == SNR_DRAWS,
          f"support_snr summary {summary}")
    check(counts["bn"]["fwd"] == counts["bn"]["act_fwd"] > 0,
          f"support_snr launched {counts['bn']}")
    t0 = time.perf_counter()
    cpu, _, _, _ = counted(lambda: tool["draw_codes"](*args, n_draws=1, device="cpu"),
                           ANALYSIS_ENV)
    cpu_seconds = time.perf_counter() - t0
    scale = float(np.abs(cpu).max())
    dev = float(np.abs(codes[0] - cpu[0]).max()) / scale
    check(np.isfinite(codes).all() and dev <= SNR_CODE_TOL,
          f"support_snr: the first draw's codes {dev} of the largest code from the CPU's")
    printed = run_cli(lambda: tool["main"](["support_snr_torch.py", *args, "--device", DEVICE]),
                      ANALYSIS_ENV)
    check(json.loads(printed.strip().splitlines()[-1]) == summary,
          "support_snr's line differs from the draws it was held to")
    return {"summary": summary, "codes_shape": list(codes.shape),
            "first_draw_dev_over_max_abs": dev, "tolerance": SNR_CODE_TOL,
            "cpu_seconds": cpu_seconds, "seconds": seconds, **counts}


def analysis_learning_check(root: str) -> tuple[dict, str]:
    """learning_check --full, cut to LEARN_ARGS, with the gradient's global
    norm clipped at 10 as the workflow clips it from random weights
    (unclipped, the float32 loss of random flagship weights runs off to
    inf within a few dozen steps): finite losses and mAP, each part's
    seconds. Returns the report and its training log."""
    tool = load_tool("learning_check")
    result, out, counts, seconds = counted(lambda: tool["main"](
        [*LEARN_ARGS, "--root", root, "--device", DEVICE]), {**ANALYSIS_ENV, **LEARN_ENV})
    log = os.path.join(root, "learning_check.log")
    with open(log, "w") as f:
        f.write(out)
    line = json.loads(out.strip().splitlines()[-1])
    check(np.isfinite(line["mean_ap"]) and line["full_scale"], f"learning_check {line}")
    losses = [float(v) for _, v in LOSS_RE.findall(out)]
    n_steps = len(losses)
    check(all(np.isfinite(losses)), f"learning_check: losses {losses}")
    check(n_steps > 0 and counts["nms_rows"] > 0, f"learning_check: {n_steps} steps, {counts}")
    check_bn_counts(f"learning_check's {n_steps} steps", counts["bn"], BN_LAYERS * n_steps)
    return {"line": line, "steps": n_steps, "first_loss": losses[0], "last_loss": losses[-1],
            "part_seconds": result["seconds"],
            "seconds": seconds, **counts}, log


def analysis_tiny_root(root: str) -> dict:
    """cli/workflow.py --tiny on the card at TINY_ARGS, every stage."""
    from fewshot_detection_tpu_torch.cli import workflow

    configure = workflow.configure

    def at_batch(args):
        configure(args)
        workflow.DK_BATCH = TINY_DK_BATCH

    workflow.configure = at_batch
    try:
        summary, _, counts, seconds = counted(
            lambda: workflow.main(["--root", root, "--device", DEVICE, *TINY_ARGS]), {})
    finally:
        workflow.configure = configure
        workflow.configure(workflow.parse_args([]))  # the module's defaults
    check(list(summary) == ["data", "base", "few", "tune", "evalb", "evalt"],
          f"tiny root stages {list(summary)}")
    check(all(np.isfinite(summary[s]["mean_ap"]) for s in ("evalb", "evalt")), "tiny mAPs")
    check(counts["nms_rows"] > 0 and counts["bn"]["fwd"] > 0, f"tiny root: {counts}")
    return {"maps": {s: summary[s]["mean_ap"] for s in ("evalb", "evalt")},
            "seconds": seconds, **counts}


def analysis_shot_sweep(root: str) -> dict:
    """shot_sweep on the tiny root at SWEEP_SHOTS, its tuning cut."""
    from fewshot_detection_tpu_torch.cli import workflow

    tool = load_tool("shot_sweep")
    tool["TINY_OVERRIDES"].update(SWEEP_TUNING)
    defaults = {k: getattr(workflow, k) for k in workflow.DEFAULTS}
    table, out, counts, seconds = counted(lambda: tool["main"](
        ["--root", root, "--shots", SWEEP_SHOTS, "--device", DEVICE]), {})
    check({k: getattr(workflow, k) for k in workflow.DEFAULTS} == defaults,
          "shot_sweep left the workflow's settings changed")
    line = json.loads(out.rsplit("SHOTSWEEP ", 1)[1].splitlines()[0])
    check(line == json.loads(json.dumps(table)), "SHOTSWEEP line")
    check([r["shot"] for r in table["per_shot"]] == [int(s) for s in SWEEP_SHOTS.split(",")]
          and all(np.isfinite(r["mean"]) for r in table["per_shot"]), f"shot sweep {table}")
    check(counts["nms_rows"] > 0 and counts["bn"]["fwd"] > 0, f"shot_sweep: {counts}")
    return {"shotsweep": table, "seconds": seconds, **counts}


def paint_wider(valdir: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for sub, name, (h, w) in WIDER_TREE:
        os.makedirs(os.path.join(valdir, sub), exist_ok=True)
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        for _ in range(6):  # bright rectangles on dark noise
            y, x = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 40))
            img[y:y + int(rng.integers(20, 200)), x:x + int(rng.integers(20, 200))] = \
                rng.integers(120, 256, 3)
        png.write_png(os.path.join(valdir, sub, name), img)


class RecordedPipelines:
    """Stands in for DevicePipeline.eval_boxes while the WIDER tool runs:
    each image's raw output and the boxes the device gave for it."""

    def __init__(self):
        self.images = []
        self._eval = device_pipeline.DevicePipeline.eval_boxes

    def __enter__(self):
        rec, ev = self, self._eval

        def eval_boxes(pipe, output):
            boxes = ev(pipe, output)
            rec.images.append((output, pipe.top_k, boxes[0]))
            return boxes

        device_pipeline.DevicePipeline.eval_boxes = eval_boxes
        return self

    def __exit__(self, *exc):
        device_pipeline.DevicePipeline.eval_boxes = self._eval


def analysis_widerface(workdir: str, seed: int) -> dict:
    """eval_widerface on cfg/yolo-voc.cfg from the seeded weights over the
    painted WIDER tree: one nms_rows launch an admitted image (on the
    workspace path past MAX_K), every image's boxes those of the host path
    (get_region_boxes + nms on the same output), a box file and an
    annotated PNG an admitted image."""
    tool = load_tool("eval_widerface")
    valdir, savedir = os.path.join(workdir, "wider_val"), os.path.join(workdir, "wider_out")
    paint_wider(valdir, seed)
    spec = build_spec(parse_cfg(PLAIN_CFG))
    wpath = os.path.join(workdir, "yolo-voc.weights")
    save_weights(wpath, [spec], [plain_params(spec, seed)], seen=PLAIN_SEEN)
    with RecordedPipelines() as rec:
        _, out, counts, seconds = counted(lambda: tool["main"](
            ["eval_widerface_torch.py", PLAIN_CFG, wpath, valdir, savedir, "--device", DEVICE]),
            ANALYSIS_ENV)
    # the images in the order the tool walked them: each admitted one ends
    # with its annotated image's path
    saved = [ln.split("save plot results to ", 1)[1] for ln in out.splitlines()
             if ln.startswith("save plot results to ")]
    admitted = [n for _, n, _ in WIDER_TREE if n not in WIDER_OMITTED]
    check(sorted(map(os.path.basename, saved)) == sorted(admitted), f"WIDER saved {saved}")
    ks = [k for _, k, _ in rec.images]
    n_long = sum(k > nms_device.MAX_K for k in ks)
    check(len(rec.images) == len(admitted) and counts["nms_rows"] == len(admitted)
          and counts["nms_rows_long"] == n_long >= 2 and max(ks) == 12800,
          f"WIDER: buffers {ks}, launches {counts}")
    for name in WIDER_OMITTED:
        check(f"omit {name}" in out, f"{name} was not omitted")
    images = []
    for (output, k, boxes), path in zip(rec.images, saved):
        name, region = os.path.basename(path), spec.region
        host = nms(get_region_boxes(output, 0.05, region.num_classes, region.anchor_wh)[0], 0.4)
        worst = max((float(np.max(np.abs(np.asarray(d) - np.asarray(h, float))))
                     for d, h in zip(boxes, host)), default=0.0)
        check(len(host) == len(boxes) and all(d[6] == h[6] for d, h in zip(boxes, host))
              and worst <= 1e-6,
              f"WIDER {name}: {len(boxes)} boxes on the device, {len(host)} on the host path, "
              f"{worst} apart")
        with open(os.path.splitext(path)[0] + ".txt") as f:
            check(int(f.readline()) == len(boxes), f"WIDER {name}: box file count")
        check(os.path.getsize(path) > 0, f"WIDER {name}: image")
        images.append({"image": name, "candidates": k, "kept": len(boxes),
                       "host_equal_exact": all(list(map(float, d)) == list(map(float, h))
                                               for d, h in zip(boxes, host)),
                       "host_max_abs_diff": worst})
        del output
    return {"images": images, "nms_launches_shared": counts["nms_rows"] - n_long,
            "nms_launches_long": n_long, "seconds": seconds, **counts}


def run_tool_text(name: str, argv: list) -> tuple[str, object]:
    """(stdout, exit code or None) of scripts/<name>_torch.py as __main__."""
    import runpy

    old = sys.argv
    sys.argv = [f"{name}_torch.py", *argv]
    buf, code = io.StringIO(), None
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "scripts", f"{name}_torch.py"), run_name="__main__")
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = old
    return buf.getvalue(), code


def analysis_readers(roots: list, logs: list) -> dict:
    """tuning_delta over each root, seed_stats over all of them, cls_curve
    over every training log: their outputs parse, and cls_curve's table
    counts every loss line of each log."""
    t0 = time.perf_counter()
    out = {"tuning_delta": {}, "cls_curve": {}}
    for root in roots:
        text, code = run_tool_text("tuning_delta", ["--root", root])
        rows = [ln for ln in text.splitlines() if ln.startswith("| ")]
        check(code is None and len(rows) == 1 + 20 + 2 and "| mean novel |" in text,
              f"tuning_delta on {root}: {text[:300]}")
        out["tuning_delta"][os.path.basename(root)] = rows[-2:]
    text, code = run_tool_text("seed_stats", ["--roots", ",".join(roots)])
    stats = json.loads(text.split("SEEDSTATS ", 1)[1])
    check(code is None and stats["n_seeds"] == len(roots), f"seed_stats: {text[:300]}")
    out["seed_stats"] = {k: stats[k] for k in ("n_seeds", "novel_delta", "mean_after")}
    for log in logs:
        with open(log) as f:
            loss_lines = [m.group(0) for m in LOSS_RE.finditer(f.read())]
        n_loss = len(loss_lines)
        text, code = run_tool_text("cls_curve", [log, "--bucket", "640"])
        rows = text.splitlines()[2:]
        counted_lines = sum(int(r.split()[2]) for r in rows)
        check(code is None and n_loss > 0 and counted_lines == n_loss,
              f"cls_curve on {log}: {counted_lines} of {n_loss} loss lines, e.g. "
              f"{loss_lines[-3:]}")
        out["cls_curve"][os.path.relpath(log, os.path.dirname(os.path.dirname(log)))] = {
            "loss_lines": n_loss, "buckets": len(rows)}
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_analysis(seed: int, smi: str, workdir: str) -> dict:
    """The eight analysis tools on the card, under FSD_NATIVE=1 on painted
    PNGs; the readers also over the `workflow` phase's root when that phase
    ran (`workdir`). Returns the kernels' launches of the phase and the
    long-row launches."""
    t0 = time.perf_counter()
    d = os.path.join(workdir, "analysis")
    os.makedirs(d)
    report = {"card": smi, "reduced": {
        "multiscale_epoch": {"--batches": MS_EPOCH_BATCHES},
        "learning_check": {**dict(zip(LEARN_ARGS[1::2], LEARN_ARGS[2::2])), **LEARN_ENV},
        "tiny_root": {**dict(zip(TINY_ARGS[1::2], TINY_ARGS[2::2])), "batch": TINY_DK_BATCH},
        "shot_sweep": {"--shots": SWEEP_SHOTS, **SWEEP_TUNING}}}
    parts = {}

    def part(name, got):  # each tool's report as soon as it is done
        parts[name] = got
        emit("analysis", part=name, **got)
        torch.cuda.empty_cache()

    ms_root = os.path.join(d, "multiscale")
    part("multiscale_epoch", analysis_multiscale(ms_root))
    part("support_snr", analysis_support_snr(ms_root, d))
    learn, learn_log = analysis_learning_check(os.path.join(d, "learn"))
    part("learning_check", learn)
    tiny = os.path.join(d, "tiny")
    part("tiny_root", analysis_tiny_root(tiny))
    part("shot_sweep", analysis_shot_sweep(tiny))
    part("eval_widerface", analysis_widerface(d, seed))
    roots = [r for r in (os.path.join(workdir, "workflow", "root"), tiny)
             if os.path.exists(os.path.join(r, "state", "evalt.done"))]
    logs = [os.path.join(r, "logs", f"{n}.log") for r in roots
            for n in ("plain", "base", "tune", "tune_shot1", "tune_shot2")
            if os.path.exists(os.path.join(r, "logs", f"{n}.log"))] + [learn_log]
    part("readers", analysis_readers(roots, logs))
    report["seconds"] = time.perf_counter() - t0
    report["part_seconds"] = {k: v["seconds"] for k, v in parts.items()}
    emit("analysis", **report)
    tools = [p for p in parts.values() if "bn" in p]
    bn = {}
    for p in tools:
        add_counts(bn, p["bn"])
    return {"bn": bn,
            "nms": {"launches": sum(p["nms_rows"] for p in tools)},
            "long": {"launches": sum(p["nms_rows_long"] for p in tools)}}


# ---------------------------------------------------------------------------
# bench: the JAX tree's five measurement scripts, ported (*_torch.py)
# ---------------------------------------------------------------------------

BENCH_INPUT_ARGS = ("--train", "--train-batches", "10")
BENCH_INPUT_ENV = {"FSD_NATIVE": "1"}
BENCH_STEPS = 13  # bench_torch: WARMUP 3 + ITERS 10
ROOFLINE_STEPS = 8  # the counted step, 2 warm-up and 5 timed
PEAK_RE = re.compile(r"^batch (\d+): peak device memory (\d+) bytes$", re.M)


def bench_train_step(smi: str) -> dict:
    """bench_torch.py at its defaults: batch 384 (or the batch it fell back
    to, with the OOM message it printed), 29 + 29 bn_sums and bn_act launches
    a step."""
    script = load_script("bench_torch.py")
    result, out, counts, seconds = counted(lambda: script["main"](["--device", DEVICE]), {})
    lines = out.strip().splitlines()
    check(lines[0] == f"card: {smi}", f"bench_torch's card line {lines[0]!r}")
    check(json.loads(lines[-1]) == result and result["value"] > 0, f"bench_torch {result}")
    batch = int(re.search(r"batch (\d+)\)$", result["unit"]).group(1))
    peaks = {int(b): int(n) for b, n in PEAK_RE.findall(out)}
    fell_back = [l for l in lines if "out of memory" in l]
    check(batch == script["BATCH"] or fell_back, "bench_torch fell back without an OOM")
    runs = 1 + len(fell_back)  # a failed batch launches some kernels too
    check(counts["bn"]["fwd"] >= BN_LAYERS * BENCH_STEPS, f"bench_torch launched {counts}")
    if runs == 1:
        check_bn_counts("bench_torch", counts["bn"], BN_LAYERS * BENCH_STEPS)
    return {"line": result, "batch": batch, "fell_back": fell_back,
            "peak_memory_bytes": peaks, "lines": lines[:-1], "seconds": seconds, **counts}


def bench_roofline(smi: str) -> dict:
    """roofline_b384_torch.py: the counted FLOPs equal the spec's, the
    shares of the card's peaks positive and at most 100."""
    script = load_script("scripts/roofline_b384_torch.py")
    result, out, counts, seconds = counted(lambda: script["main"](["--device", DEVICE]), {})
    lines = out.strip().splitlines()
    check(lines[0] == f"card: {smi}" and lines[-1].startswith("ROOFLINE "),
          f"roofline's lines {lines[0]!r} {lines[-1][:40]!r}")
    spec = MetaSpec(build_spec(parse_cfg(DARKNET_CFG)), build_spec(parse_cfg(LEARNET_CFG)))
    want = script["spec_flops"](spec, script["BATCH"], script["N_CLS"], script["SIZE"])
    check(result["cost_flops_per_step"] == want
          and result["gflop_per_image"] == round(want / script["BATCH"] / 1e9, 1),
          f"roofline FLOPs {result['cost_flops_per_step']} against the spec's {want}")
    for k in ("mfu_pct", "hbm_util_pct"):
        check(result[k] is not None and 0 < result[k] <= 100, f"roofline {k} = {result[k]}")
    check(result["bn_sums_launches_per_step"] == 2 * BN_LAYERS,
          f"roofline counted {result['bn_sums_launches_per_step']} bn_sums launches a step")
    check_bn_counts("roofline", counts["bn"], BN_LAYERS * ROOFLINE_STEPS)
    check(result["bn_act_launches_per_step"] == 2 * BN_LAYERS,
          f"roofline counted {result['bn_act_launches_per_step']} bn_act launches a step")
    return {"line": result, "lines": lines[:-1], "seconds": seconds, **counts}


def bench_meta_pipeline(smi: str) -> dict:
    """bench_meta_pipeline_torch.py at its defaults (16 images x 15 classes,
    conf 0.25, a buffer of 128): the host path's counts in every row, one
    nms_rows launch a pipeline call (one untimed, 10 timed)."""
    script = load_script("scripts/bench_meta_pipeline_torch.py")
    result, out, counts, seconds = counted(lambda: script["main"](["--device", DEVICE]), {})
    check(out.splitlines()[0] == f"card: {smi}", out.splitlines()[0])
    check(result["mismatch"] == 0 and result["kept"] == result["host_kept"] > 0,
          f"bench_meta_pipeline {result}")
    check(counts["nms_rows"] == 11, f"bench_meta_pipeline launched {counts}")
    return {"line": result, "lines": out.strip().splitlines()[1:], "seconds": seconds,
            **counts}


def bench_int8(smi: str) -> dict:
    """bench_int8_meta_torch.py on the tracked checkpoint: every rate
    positive, every deviation finite."""
    script = load_script("scripts/bench_int8_meta_torch.py")
    result, out, counts, seconds = counted(
        lambda: script["main"](["--weights", WEIGHTS, "--device", DEVICE]), {})
    check(out.splitlines()[0] == f"card: {smi}", out.splitlines()[0])
    devs = {k: v for k, v in result.items() if k.endswith("_dev_pct")}
    check(len(devs) == 4 and all(np.isfinite(v) for v in devs.values()),
          f"bench_int8 deviations {devs}")
    check(all(v > 0 for k, v in result.items() if k.endswith("_img_s")), f"bench_int8 {result}")
    return {"line": result, "seconds": seconds, **counts}


def bench_input(smi: str) -> dict:
    """bench_input_pipeline_torch.py under FSD_NATIVE=1 on painted PNGs with
    real train steps on the card: every mode positive, `pil` too unless the
    host lacks PIL (then null beside `pil_error`)."""
    script = load_script("scripts/bench_input_pipeline_torch.py")
    result, out, counts, seconds = counted(
        lambda: script["main"]([*BENCH_INPUT_ARGS, "--device", DEVICE]), BENCH_INPUT_ENV)
    check(out.splitlines()[0] == f"card: {smi}", out.splitlines()[0])
    check(result["pil"] is not None or result.get("pil_error"), f"bench_input {result}")
    check(all(v > 0 for k, v in result.items() if k not in ("metric", "pil", "pil_error")),
          f"bench_input {result}")
    steps = script["TRAIN_WARMUP"] + int(
        BENCH_INPUT_ARGS[BENCH_INPUT_ARGS.index("--train-batches") + 1])
    check_bn_counts(f"bench_input's {steps} steps", counts["bn"], BN_LAYERS * steps)
    return {"line": result, "seconds": seconds, **counts}


def phase_bench(smi: str) -> dict:
    """The five ported measurement scripts on the card, one after another,
    the allocator's cache emptied between them. Returns the kernels'
    launches of the phase."""
    t0 = time.perf_counter()
    parts = {}
    for name, fn in (("bench", bench_train_step), ("roofline", bench_roofline),
                     ("meta_pipeline", bench_meta_pipeline), ("int8", bench_int8),
                     ("input_pipeline", bench_input)):
        parts[name] = fn(smi)
        emit("bench", part=name, card=smi, **parts[name])
        torch.cuda.empty_cache()
    b, r = parts["bench"], parts["roofline"]["line"]
    emit("bench", card=smi, seconds=time.perf_counter() - t0,
         part_seconds={k: v["seconds"] for k, v in parts.items()},
         batch=b["batch"], img_per_s=b["line"]["value"], fell_back=b["fell_back"],
         peak_memory_bytes=b["peak_memory_bytes"], mfu_pct=r["mfu_pct"],
         hbm_util_pct=r["hbm_util_pct"], roofline_step_ms=r["step_ms"],
         gflop_per_image=r["gflop_per_image"])
    bn = {}
    for p in parts.values():
        add_counts(bn, p["bn"])
    return {"bn": bn,
            "nms": {"launches": sum(p["nms_rows"] for p in parts.values())}}


def phase_bench_kernels(rec: PathInputs, seed: int) -> dict:
    """Both kernels timed at the bench path's largest inputs, after it ran:
    bn_sums forward and backward (plain versions and library calls beside
    them) at its largest (M, C) in bfloat16, the bench's type, and nms_rows
    on the meta pipeline's rows."""
    m, c, dtype = max(rec.bn, key=lambda t: t[0] * t[1])
    x = make_activation(seed + 300, m, c, dtype)
    times = time_bn_sums(x)
    del x
    torch.cuda.empty_cache()
    (r, k), (boxes, dsel) = max(rec.nms.items(), key=lambda kv: kv[0][0] * kv[0][1])
    nms = compare_kernel(boxes, dsel, timed=True)
    check(nms["max_mismatch"] == 0, "nms_rows disagrees on the meta pipeline's rows")
    dt = str(dtype).split(".")[-1]
    emit("bench_kernels", bn_shape=[m, c], dtype=dt, bn_times=times, nms=nms)
    return {"bn_shape": [m, c], "dtype": dt, "bn_times": times, "nms": nms}


# the multi-scale schedule's sizes run from 320 to 608 px; the workflow's
# cut run stays at 416, so its layers are also held at the top of the range
MULTISCALE_TOP = 608


def phase_path_inputs(recorded: dict, seed: int) -> dict:
    """Each kernel against its plain version at the inputs every path gave
    it (`PathInputs`): bn_sums on activations made at each distinct (M, C,
    dtype), with the workflow's 416 px shapes also taken to
    MULTISCALE_TOP (M * 19^2 / 13^2); bn_act at each distinct (M, C, dtype,
    activation), as `compare_bn_act`; nms_rows on the rows the path's
    sweeps ranked. Returns the compared bn_sums cases and the worst NMS
    mismatch."""
    report, cases, worst = {}, [], 0
    done = set()
    t0 = time.perf_counter()
    for path, rec in recorded.items():
        shapes = set(rec.bn)
        if path == "workflow":
            top = (MULTISCALE_TOP // 32) ** 2
            shapes |= {(m // 169 * top, c, dt) for m, c, dt in rec.bn if m % 169 == 0}
        bn_cases = []
        for i, (m, c, dtype) in enumerate(sorted(shapes, key=lambda t: (str(t[2]), t[1], t[0]))):
            if (m, c, dtype) not in done:
                res = compare_bn_sums(make_activation(seed + i, m, c, dtype), seed + i)
                check(res["layout_copies"] == 0, "a contiguous input was copied")
                done.add((m, c, dtype))
                cases.append(res)
                bn_cases.append([m, c, res["dtype"], res["path"], res["kernel_err_over_sum_abs"],
                                 res["backward_max_abs_err"]])
                torch.cuda.empty_cache()
        act_cases = []
        names = {v: k for k, v in act_mod._CODES.items()}
        for i, (m, c, dtype, code) in enumerate(sorted(rec.act, key=lambda t: (str(t[2]), t[1], t[0]))):
            if ("act", m, c, dtype, code) not in done:
                y, inv, bias, dout = make_epilogue_inputs(seed + 500 + i, m, c, dtype)
                res = compare_bn_act(y, inv, bias, dout, names.get(code, "linear"))
                del y, dout
                done.add(("act", m, c, dtype, code))
                act_cases.append([m, c, res["dtype"], res["activation"], res["paths"],
                                  res["dinv_max_err_ulps"], res["dbias_max_err_ulps"]])
                torch.cuda.empty_cache()
        nms_cases = []
        for (r, k), (boxes, dsel) in sorted(rec.nms.items()):
            res = compare_kernel(boxes, dsel, timed=False)
            worst = max(worst, res["max_mismatch"])
            nms_cases.append({k2: res[k2] for k2 in ("shape", "valid", "kept", "max_mismatch")})
        report[path] = {"bn_shapes": len(shapes), "bn_compared": bn_cases,
                        "act_shapes": len(rec.act), "act_compared": act_cases, "nms": nms_cases}
    emit("path_inputs", seconds=time.perf_counter() - t0, bn_compared=len(cases),
         tolerance_over_sum_abs=SUM_TOL,
         bn_case_fields=["m", "c", "dtype", "path", "err_over_sum_abs", "backward_max_abs_err"],
         act_case_fields=["m", "c", "dtype", "activation", "paths", "dinv_max_err_ulps",
                          "dbias_max_err_ulps"],
         **report)
    check(worst == 0, f"nms_rows disagrees with nms_rows_reference on a path's rows: {worst}")
    return {"cases": cases, "nms_worst": worst}


def kernels_line(served: dict, worst: int, bn: dict, trained: dict, coco: dict,
                 long: dict, bench: dict, act: dict, pool: dict) -> dict:
    """The summary of every kernel of the port. `served` and `trained` map
    each serving and training path to what it returned: its launches (read
    right after the path ran), and for the serving paths the candidate rows
    of its first batch (float32; the ensemble sweep's at 20 classes). The
    NMS kernel is timed on the ensemble sweep's rows, as in the earlier
    slices, on the plain sweep's and on the COCO sweep's (`coco`, from
    `phase_coco_kernels`); the rows are in L2 when the kernel starts, as
    they are behind `_decode_rank`; and on the bench meta pipeline's rows
    (`bench`, from `phase_bench_kernels`)."""
    res = compare_kernel(*served["serve"]["rows"], timed=True)
    plain = compare_kernel(*served["plain_serve"]["rows"], timed=True)
    check(res["max_mismatch"] == 0 and plain["max_mismatch"] == 0,
          "nms_rows disagrees on the main path's rows")
    plain_keys = ("shape", "valid", "kept", "kernel_ms", "card_ms", "plain_ms", "bound_ms",
                  "bound_by", "bound_term", "share_of_bound")
    return {"kernels": [{
        "name": "nms_rows",
        "route": "cuda",
        "source": "fewshot_detection_tpu_torch/csrc/nms.cu",
        "replaces": "fewshot_detection_tpu/ops/nms_device.py:57",
        "launches": sum(v["launches"] for v in served.values()),
        "launches_by_path": {k: v["launches"] for k, v in served.items()},
        "max_abs_err": float(max(worst, res["max_mismatch"])),
        "ms": res["kernel_ms"],
        "card_ms": res["card_ms"],
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
        "share_of_bound": res["share_of_bound"],
        "plain_sweep_rows": {k: plain[k] for k in plain_keys},
        "coco_sweep_rows": {k: coco["nms"][k] for k in plain_keys},
        "bench_pipeline_rows": {k: bench["nms"][k] for k in plain_keys},
    }, long_row_entry(long, worst), *bn_kernel_entries(bn, trained, coco, bench),
        *bn_act_entries(act, trained), *pool_entries(pool, trained)]}


def long_row_entry(long: dict, worst: int) -> dict:
    """`nms_rows` on a row longer than MAX_K: the same kernel with the row's
    arrays in a workspace in device memory. Timed on the WIDER sweep's
    longest row (`long["wider"]`, the analysis path's input), and on the
    kernels phase's synthetic (1, LONG_ROW)."""
    res, synth = long["wider"], long["synthetic"]
    keys = ("shape", "valid", "kept", "kernel_ms", "card_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_term", "share_of_bound")
    return {
        "name": "nms_rows_long",
        "route": "cuda",
        "source": "fewshot_detection_tpu_torch/csrc/nms.cu",
        "replaces": "fewshot_detection_tpu/ops/nms_device.py:57",
        "launches": long["launches"],
        "launches_by_path": {"analysis": long["launches"]},
        "max_abs_err": float(max(worst, res["max_mismatch"])),
        "ms": res["kernel_ms"],
        "card_ms": res["card_ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,
        **{k: res[k] for k in ("shape", "valid", "kept", "iou_pairs", "longest_row",
                               "chain_steps", "bound_term", "bytes_bound_ms", "flops_bound_ms",
                               "chain_bound_ms", "share_of_bound")},
        "synthetic_rows": {k: synth[k] for k in keys},
    }


def bn_kernel_entries(bn: dict, trained: dict, coco: dict, bench: dict) -> list:
    """`bn_sums_fwd` and `bn_sums_bwd`, timed at the main path's largest
    shape in float32 (the bfloat16 times ride along, both types at the
    COCO path's largest shape, and bfloat16 at the bench step's, the
    largest of any path), with the worst error over every compared case."""
    shape = list(BN_MAIN_SHAPES[0])
    key = f"{shape[0]}x{shape[1]}"
    f32, b16 = bn["times"]["float32"][key], bn["times"]["bfloat16"][key]
    entries = []
    for way, name, line, err_key, lib in (
            ("fwd", "bn_sums_fwd", 36, "sum_abs_err", "torch.var_mean(x, dim=0, correction=0)"),
            ("bwd", "bn_sums_bwd", 144, "backward_max_abs_err", "torch.addcmul(dsum, x, 2*dsq)")):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "fewshot_detection_tpu_torch/csrc/bn_sums.cu",
            "replaces": f"fewshot_detection_tpu/ops/bn_pallas.py:{line}",
            "launches": sum(v[way] for v in trained.values()),
            "launches_by_path": {k: v[way] for k, v in trained.items()},
            "max_abs_err": max(c[err_key] for c in bn["cases"]),
            "ms": f32[f"{way}_ms"],
            "card_ms": f32[f"{way}_card_ms"],
            "plain_ms": f32[f"{way}_plain_ms"],
            "bound_ms": f32[f"{way}_bound_ms"],
            "bound_by": "bytes",
            "library_ms": f32[f"{way}_library_ms"],
            "library_card_ms": f32[f"{way}_library_card_ms"],
            "library_call": lib,
            "shape": shape,
            "dtype": "float32",
            "bfloat16": {k.split("_", 1)[1]: v for k, v in b16.items() if k.startswith(way)},
            "max_err_over_sum_abs": max(c["kernel_err_over_sum_abs"] for c in bn["cases"]),
            "layout_copies": sum(v["layout_copies"] for v in trained.values()),
            "coco_top": {"shape": coco["bn_shape"], **{
                dt: {k.split("_", 1)[1]: v for k, v in t.items() if k.startswith(way)}
                for dt, t in coco["bn_times"].items()}},
            "bench_top": {"shape": bench["bn_shape"], bench["dtype"]: {
                k.split("_", 1)[1]: v for k, v in bench["bn_times"].items()
                if k.startswith(way)}},
        })
    return entries


def bn_act_entries(act: dict, trained: dict) -> list:
    """`bn_act_fwd` and `bn_act_bwd`, timed at the bench step's first BN
    (66,453,504, 32) in bfloat16, with the batch-64 cells' 13 x 13 layers
    beside it, and the worst sums' error over every compared case; the
    launches are each training path's own (`trained`, counted from 0 where
    the path starts), as `bn_sums`' are. They replace no TPU kernel: XLA
    fused the epilogue on the TPU."""
    top, small = BN_ACT_TIMED["bfloat16"]
    times = act["times"]["bfloat16"]
    t, t13 = times[f"{top[0]}x{top[1]}"], times[f"{small[0]}x{small[1]}"]
    entries = []
    for way in ("fwd", "bwd"):
        by_path = {k: v[f"act_{way}"] for k, v in trained.items()}
        entries.append({
            "name": f"bn_act_{way}",
            "route": "cuda",
            "source": "fewshot_detection_tpu_torch/csrc/bn_act.cu",
            "replaces": None,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_err_ulps": max(max(c["dinv_max_err_ulps"], c["dbias_max_err_ulps"])
                                for c in act["cases"]),
            "ms": t[f"{way}_ms"],
            "card_ms": t[f"{way}_card_ms"],
            "plain_ms": t[f"{way}_plain_ms"],
            "plain_card_ms": t[f"{way}_plain_card_ms"],
            "bound_ms": t[f"{way}_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": list(top),
            "dtype": "bfloat16",
            "batch64_13x13": {"shape": list(small), **{
                k.split("_", 1)[1]: v for k, v in t13.items() if k.startswith(way)}},
        })
    return entries


def pool_entries(pool: dict, trained: dict) -> list:
    """`maxpool2x2_fwd` and `maxpool2x2_bwd`, timed at the bench step's
    first pool (384, 416, 416, 32) in bfloat16, with the learnet's odd
    (15, 13, 13, 1024) beside it; the launches are each training path's own.
    They replace no TPU kernel: XLA lowered the pool to `reduce_window`."""
    top, small = ("x".join(map(str, s)) for s in POOL_TIMED)
    t, t13 = pool["times"][top], pool["times"][small]
    entries = []
    for way in ("fwd", "bwd"):
        by_path = {k: v.get(f"pool_{way}", 0) for k, v in trained.items()}
        entries.append({
            "name": f"maxpool2x2_{way}",
            "route": "cuda",
            "source": "fewshot_detection_tpu_torch/csrc/maxpool.cu",
            "replaces": None,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": 0.0,
            "ms": t[f"{way}_ms"],
            "card_ms": t[f"{way}_card_ms"],
            "plain_ms": t[f"{way}_plain_ms"],
            "plain_card_ms": t[f"{way}_plain_card_ms"],
            "bound_ms": t[f"{way}_bound_ms"],
            "bound_by": "bytes",
            "library_ms": t[f"{way}_library_ms"],
            "library_card_ms": t[f"{way}_library_card_ms"],
            "library_call": "F.max_pool2d(x, 2, 2, return_indices=True)" if way == "fwd"
            else "aten.max_pool2d_with_indices_backward",
            "shape": list(POOL_TIMED[0]),
            "dtype": "bfloat16",
            "learnet_13x13": {"shape": list(POOL_TIMED[1]), **{
                k.split("_", 1)[1]: v for k, v in t13.items() if k.startswith(way)}},
        })
    return entries


PHASES = ("device", "build", "kernels", "serve", "train", "plain_serve", "plain_train",
          "debug", "int8_serve", "native", "ckpt", "files", "workflow", "coco", "dp",
          "analysis", "bench")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=2, help="detection batches of 16 per sweep")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of phases; no result line unless all run")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phase in {phases}")

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    # float32 runs are full float32: no TF32 in convolutions or matrix products
    valid.set_float32_precision(tf32=False)

    smi = phase_device()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        worst, long_synthetic = phase_kernels(args.seed)
        bn = phase_bn_kernels(args.seed)
        act = phase_bn_act_kernels(args.seed)
        pool = phase_pool_kernels(args.seed)
    served, trained, recorded = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as outdir:
        for path, fn in (("serve", phase_serve), ("plain_serve", phase_plain_serve),
                         ("int8_serve", phase_int8_serve)):
            if path in phases:
                with PathInputs() as recorded[path]:
                    served[path] = fn(args.seed, args.batches, outdir)
    for path, fn, n_layers in (("train", phase_train, BN_LAYERS),
                               ("plain_train", phase_plain_train, PLAIN_BN_LAYERS)):
        if path in phases:
            with PathInputs() as recorded[path]:
                trained[path] = fn(args.seed)
            phase_bn_step(path, trained[path]["bn_layer_shapes"], n_layers, args.seed)
    if "debug" in phases:
        with PathInputs() as recorded["debug"]:
            trained["debug"] = phase_debug(args.seed)
    if "native" in phases:
        phase_native(args.seed, smi)
    if "ckpt" in phases:
        with PathInputs() as recorded["ckpt"]:
            trained["ckpt"] = phase_ckpt(args.seed, smi)
    # the workflow phase's root stays until the analysis phase has read it
    workdir = tempfile.mkdtemp(prefix="chip_smoke_work_")
    try:
        for path, fn in (("files", phase_files),
                         ("workflow", lambda seed, smi: phase_workflow(smi, workdir)),
                         ("coco", phase_coco)):
            if path in phases:
                with PathInputs() as recorded[path]:
                    got = fn(args.seed, smi)
                trained[path], served[path] = got["bn"], got["nms"]
        if "dp" in phases:
            with PathInputs() as recorded["dp"]:
                got = phase_dp(args.seed, smi, recorded["dp"])
            trained["dp"], served["dp"] = got["bn"], got["nms"]
        if "analysis" in phases:
            with PathInputs() as recorded["analysis"]:
                got = phase_analysis(args.seed, smi, workdir)
            trained["analysis"], served["analysis"] = got["bn"], got["nms"]
            long_rows = got["long"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "bench" in phases:
        with PathInputs() as recorded["bench"]:
            got = phase_bench(smi)
        trained["bench"], served["bench"] = got["bn"], got["nms"]
    held = phase_path_inputs(recorded, args.seed)
    if "coco" in phases:
        coco = phase_coco_kernels(recorded["coco"], args.seed)
    if "bench" in phases:
        bench = phase_bench_kernels(recorded["bench"], args.seed)
    for path, got in served.items():
        check(got["launches"] > 0, f"the {path} path never launched the NMS kernel")
    for path, got in trained.items():
        check(got["fwd"] > 0 and got["bwd"] > 0,
              f"the {path} path never launched the bn_sums kernels")
        # every training BN launches each pair once each way
        check((got["act_fwd"], got["act_bwd"]) == (got["fwd"], got["bwd"]),
              f"the {path} path launched {got['act_fwd']} + {got['act_bwd']} bn_act kernels "
              f"against {got['fwd']} + {got['bwd']} bn_sums kernels")
    if set(phases) != set(PHASES):
        print(f"ran only {phases}: no result line", file=sys.stderr)
        return 2

    bn["cases"] += held["cases"]
    # the long-row path timed on the WIDER sweep's longest row
    wider = max(recorded["analysis"].nms.items(), key=lambda kv: kv[0][1])[1]
    long_rows.update(wider=compare_kernel(*wider, timed=True), synthetic=long_synthetic)
    check(long_rows["wider"]["shape"] == [1, LONG_ROW] and long_rows["launches"] > 0,
          f"the longest WIDER row {long_rows['wider']['shape']}")
    line = kernels_line(served, max(worst, held["nms_worst"]), bn, trained, coco, long_rows,
                        bench, act, pool)
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
