"""Ensemble validation sweep producing comp4_det_test_<class>.txt files.

Flow reproduced (reference valid_ensemble.py:76-178): the learnet runs over
EVERY support image, the codes are running-mean'd per class, optionally the
base-class codes are spliced in from a pickle, then a fixed-code detection
sweep decodes, ranks and NMS's every (image, class) row on the device.

Output rows are `imgid prob x1 y1 x2 y2` in original-image pixels, prob =
det_conf * cls_conf, one file per class — the contract eval/voc_eval.py
consumes."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config.settings import Settings
from ..data.datasets import DetectionDataset, MetaDataset
from ..ops.boxes import get_region_boxes_v2, nms
from .detector import MetaDetector
from .device_pipeline import MetaDevicePipeline

CONF_THRESH = 0.005
NMS_THRESH = 0.45


def set_float32_precision(tf32: bool = False) -> None:
    """State both float32 precision switches of PyTorch explicitly. By
    default a float32 convolution would run in TF32 (about three decimal
    digits) while a float32 matrix product would not; the sweep and the smoke
    script run both in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _device_pipe(region, n_cls: int):
    """The sweep routes decode + per-(image, class) NMS through the
    fixed-buffer device pipeline — the replacement for the
    reference's host hot loop (valid_ensemble.py:137-178 ->
    utils.py:195-290). A batch that the fixed candidate buffer
    (FSD_DEVICE_NMS_K, default 256) would truncate is redone on the host
    path, so result files are identical in every regime."""
    top_k = int(os.environ.get("FSD_DEVICE_NMS_K", "256"))
    return MetaDevicePipeline(region, n_cls, conf_thresh=CONF_THRESH,
                              nms_thresh=NMS_THRESH, top_k=top_k)


def eval_batch_size(default: int = 2) -> int:
    """The reference swept validation at batch 2 (valid.py:37); raise it
    with FSD_EVAL_BATCH."""
    return int(os.environ.get("FSD_EVAL_BATCH", default))


def results_prefix(weightfile: str, kind: str = "e") -> str:
    """results/<backup-dir>/<kind><ckpt> (reference valid.py:16-18)."""
    ckpt = os.path.basename(weightfile).split(".")[0]
    backup = weightfile.split("/")[-2] if "/" in weightfile else "model"
    return f"results/{backup}/{kind}{ckpt}"


def _write_boxes(fp, imgid: str, boxes, width: int, height: int):
    for box in boxes:
        x1 = (box[0] - box[2] / 2.0) * width
        y1 = (box[1] - box[3] / 2.0) * height
        x2 = (box[0] + box[2] / 2.0) * width
        y2 = (box[1] + box[3] / 2.0) * height
        det_conf = box[4]
        for j in range((len(box) - 5) // 2):
            cls_conf = box[5 + 2 * j]
            prob = det_conf * cls_conf
            fp.write(f"{imgid} {prob:f} {x1:f} {y1:f} {x2:f} {y2:f}\n")


def ensemble_class_codes(m: MetaDetector, metaset, batch_size: int = 64):
    """Running-mean learnet codes over every support image per class
    (valid_ensemble.py:88-100). `metaset` yields (metax, mask, clsids)
    batches and names its `classes`."""
    n_cls = len(metaset.classes)
    sums = None
    cnt = np.zeros(n_cls)
    for metax, mask, clsids in metaset.batches(batch_size):
        dws = m.class_codes(metax, mask)
        if sums is None:
            sums = [np.zeros((n_cls,) + d.shape[1:], np.float32) for d in dws]
        for di, d in enumerate(dws):
            np.add.at(sums[di], clsids, d)
        np.add.at(cnt, clsids, 1)
    codes = [s / np.maximum(cnt.reshape((-1,) + (1,) * (s.ndim - 1)), 1) for s in sums]
    return codes, cnt


def run_valid_ensemble(
    data_options: dict,
    darknetcfg,
    learnetcfg,
    weightfile: str,
    settings: Settings,
    outfile: str = "comp4_det_test_",
    use_baserw: bool = False,
    batch_size: int | None = None,
    device="cuda",
) -> str:
    """The whole ensemble sweep in full float32 on `device`; returns the
    results prefix."""
    set_float32_precision(tf32=False)
    batch_size = batch_size or eval_batch_size()
    m = MetaDetector(darknetcfg, learnetcfg, weightfile,
                     metain_type=settings.metain_type, device=device)
    kind = "ene_" if use_baserw else "ene"
    prefix = results_prefix(weightfile, kind)
    print("saving to: " + prefix)

    metaset = MetaDataset(
        data_options["meta"], settings, train=False, ensemble=True,
        with_ids=True,
    )
    n_cls = len(metaset.classes)
    print("===> Generating dynamic weights...")
    codes, _ = ensemble_class_codes(m, metaset)

    save_rw = os.environ.get("FSD_SAVE_RW")
    if save_rw:
        # persist ensemble class codes for later use_baserw splicing (the
        # reference generated these pickles from a commented-out block,
        # valid_ensemble.py:102-106); stored NHWC (n, 1, 1, C) — the loader
        # below also accepts the reference's torch NCHW layout
        import pickle

        os.makedirs(os.path.dirname(save_rw) or ".", exist_ok=True)
        with open(save_rw, "wb") as fh:
            pickle.dump([np.asarray(c, np.float32) for c in codes], fh)
        print(f"===> Saved class codes to {save_rw}")

    if use_baserw:
        import pickle

        f = "data/rws/voc_novel{}_.pkl".format(0)
        print(f"===> Loading from {f}...")
        with open(f, "rb") as fh:
            rws = pickle.load(fh)
        tki = list(settings.real_base_ids)
        for i in range(len(rws)):
            # stored reference codes are torch NCHW (n, C, 1, 1); ours are
            # NHWC (n, 1, 1, C) — transpose whenever the layouts differ
            rw = np.asarray(rws[i], np.float32)
            if rw.ndim == 4 and rw.shape != codes[i].shape:
                rw = rw.transpose(0, 2, 3, 1)
            codes[i][tki] = rw[tki]

    ds = DetectionDataset(
        data_options["valid"], settings, shape=(m.width, m.height),
        shuffle=False, train=False, filter_valid=False,
    )
    # the fixed codes go to the device once; per-batch conversion would
    # cost n_cls transfers on every sweep batch
    return _meta_sweep(m, ds, prefix, outfile, m.commit_codes(codes), n_cls,
                       metaset.classes, batch_size)


def _write_meta_batch(fps, batch_boxes, ds, bs, n_cls, line_id,
                      apply_nms=True):
    for b in range(bs):
        line_id += 1
        imgid = os.path.basename(ds.lines[line_id]).split(".")[0]
        width, height = ds.image_size(line_id)
        for i in range(n_cls):
            boxes = batch_boxes[b * n_cls + i]
            if apply_nms:  # host path; device-pipeline rows arrive already NMS'd
                boxes = nms(boxes, NMS_THRESH)
            _write_boxes(fps[i], imgid, boxes, width, height)
    return line_id


def _meta_batch_boxes(m, output, pipe, n_cls):
    """(box_lists, already_nms'd) for one meta sweep batch — the device
    pipeline when its buffer suffices, else the host decode (the same boxes
    either way; see _device_pipe)."""
    final = pipe.eval_boxes(output)
    if final is not None:
        return final, True
    return get_region_boxes_v2(
        output, n_cls, CONF_THRESH, m.region.num_classes,
        m.region.anchor_wh, only_objectness=False, validation=True,
    ), False


def _meta_sweep(m, ds, prefix, outfile, codes, n_cls, class_names, batch_size,
                stats: dict | None = None):
    """Fixed-code detection sweep over `ds`, which yields (images, labels)
    from `batches(batch_size, drop_last=False)` and answers `lines[i]` (a
    name whose basename is the image id) and `image_size(i)`. Returns the
    results prefix. A `stats` dict, when given, receives the number of
    `batches`, of `device_batches` (those the device pipeline finished
    without handing the batch to the host path) and `max_candidates` (the
    most candidates above the threshold in any (image, class) row, to hold
    against the buffer size)."""
    os.makedirs(prefix, exist_ok=True)
    fps = [open(f"{prefix}/{outfile}{n}.txt", "w") for n in class_names]
    try:
        pipe = _device_pipe(m.region, n_cls)
        line_id = -1
        n_batches = n_device = 0
        for imgs, _ in ds.batches(batch_size, drop_last=False):
            output = m.detect(imgs, codes)
            batch_boxes, done = _meta_batch_boxes(m, output, pipe, n_cls)
            n_batches += 1
            n_device += int(done)
            line_id = _write_meta_batch(
                fps, batch_boxes, ds, imgs.shape[0], n_cls, line_id,
                apply_nms=not done,
            )
        if stats is not None:
            stats.update(batches=n_batches, device_batches=n_device,
                         max_candidates=pipe.max_candidates)
    finally:
        for fp in fps:
            fp.close()
    return prefix
