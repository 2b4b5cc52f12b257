"""Validation sweeps producing comp4_det_test_<class>.txt result files.

Flows reproduced (file:line in the reference):
  * run_valid          — plain sweep, per-class files keyed by predicted
                         class id (valid.py:12-85)
  * run_valid_meta     — meta model with fresh per-batch support codes
                         (valid_meta.py:13-120)
  * run_valid_ensemble — learnet over EVERY support image, running-mean the
                         codes per class, optional base-code splice from a
                         pickle, then a fixed-code detection sweep
                         (valid_ensemble.py:76-178)

Each sweep decodes, ranks and NMS's every row of a batch on the device.
Under FSD_EVAL_MESH=N (`eval_mesh`) the sweep is data-parallel over a world
of N ranks (torchrun): each rank runs its contiguous block of every batch,
and rank 0 gathers the box lists and writes the files, line-equal to one
process's.

Output rows are `imgid prob x1 y1 x2 y2` in original-image pixels, prob =
det_conf * cls_conf, one file per class — the contract eval/voc_eval.py
consumes."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..config.settings import Settings
from ..data.datasets import DetectionDataset, MetaDataset
from ..ops.boxes import get_region_boxes, get_region_boxes_v2, nms
from ..parallel.mesh import make_mesh, pad_to_ranks, world_size
from .detector import MetaDetector, PlainDetector
from .device_pipeline import DevicePipeline, MetaDevicePipeline

CONF_THRESH = 0.005
NMS_THRESH = 0.45


def set_float32_precision(tf32: bool = False) -> None:
    """State both float32 precision switches of PyTorch explicitly. By
    default a float32 convolution would run in TF32 (about three decimal
    digits) while a float32 matrix product would not; the sweep and the smoke
    script run both in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _device_pipe(region, n_cls: int | None = None):
    """The sweeps route decode + per-(image[, class]) NMS through the
    fixed-buffer device pipeline — the replacement for the reference's host
    hot loop (valid_ensemble.py:137-178 -> utils.py:195-290). A batch that
    the fixed candidate buffer (FSD_DEVICE_NMS_K, default 256) would
    truncate is redone on the host path (`_batch_boxes`), so result files
    are identical in every regime."""
    top_k = int(os.environ.get("FSD_DEVICE_NMS_K", "256"))
    if n_cls is None:
        return DevicePipeline(region, conf_thresh=CONF_THRESH, nms_thresh=NMS_THRESH,
                              top_k=top_k, validation=True)
    return MetaDevicePipeline(region, n_cls, conf_thresh=CONF_THRESH,
                              nms_thresh=NMS_THRESH, top_k=top_k)


def _batch_boxes(pipe, output, host_boxes):
    """Post-NMS box lists of one sweep batch (validation format) and whether
    the device pipeline made them: the pipeline when its buffer holds every
    candidate, else `host_boxes(output)` — the same boxes either way."""
    final = pipe.eval_boxes(output)
    if final is not None:
        return final, True
    return host_boxes(output), False


def plain_host_boxes(region, output):
    """The host path of a plain sweep batch: host decode + host NMS, one
    box list per image."""
    batch_boxes = get_region_boxes(
        output, CONF_THRESH, region.num_classes, region.anchor_wh,
        only_objectness=False, validation=True,
    )
    return [nms(boxes, NMS_THRESH) for boxes in batch_boxes]


def meta_host_boxes(region, output, n_cls: int):
    """The host path of a meta sweep batch: host decode + host NMS, one box
    list per (image, class) row, image-major."""
    batch_boxes = get_region_boxes_v2(
        output, n_cls, CONF_THRESH, region.num_classes, region.anchor_wh,
        only_objectness=False, validation=True,
    )
    return [nms(boxes, NMS_THRESH) for boxes in batch_boxes]


def eval_mesh(device="cuda"):
    """FSD_EVAL_MESH=N runs the sweep data-parallel over a world of N ranks
    (FSD_EVAL_MESH=all: every rank of the world), one device a rank: each
    rank sweeps its contiguous block of every batch. The world is
    torchrun's (`torchrun --nproc_per_node=N valid_torch.py ...`); a world
    of another size raises, and so does a world of several ranks with the
    switch unset. Pair with FSD_EVAL_BATCH >= N. None when unset."""
    n = os.environ.get("FSD_EVAL_MESH")
    if not n:
        if world_size() > 1:  # N ranks each sweeping everything into one set of files
            raise ValueError(
                f"this process is one of {world_size()} ranks: set FSD_EVAL_MESH to shard "
                "the sweep over them")
        return None
    want = None if n == "all" else int(n)
    if want is not None and want != world_size():
        raise ValueError(
            f"FSD_EVAL_MESH={n} needs a world of {n} ranks, and this process is one of "
            f"{world_size()}: launch the sweep with torchrun --nproc_per_node={n}")
    return make_mesh(want, device=device)


def _local_batch(imgs, mesh):
    """(the images this rank runs, the batch's length): the whole batch in
    one process; a rank's block of it padded to a multiple of the ranks."""
    if mesh is None:
        return imgs, imgs.shape[0]
    return pad_to_ranks(mesh, imgs)


def _gathered(rows: list, mesh, n_rows: int):
    """Every rank's box lists put together on rank 0 in rank order, the rows
    of the padding cut (`n_rows` of the real batch, image-major); None on
    the other ranks. In one process the rows as they are."""
    if mesh is None:
        return rows
    parts = mesh.gather_object(rows)
    if parts is None:
        return None
    return [r for part in parts for r in part][:n_rows]


def _on_chief(mesh, fn):
    """fn() on rank 0 (or in one process), its result broadcast to every
    rank: the class codes, so every rank reweights with the same bits."""
    if mesh is None:
        return fn()
    return mesh.broadcast_object(fn() if mesh.is_chief else None)


def quantize_sweep(m: MetaDetector, ds, codes, batch_size: int) -> bool:
    """FSD_INT8=1: int8 serving for the whole sweep. The activation scales
    are calibrated on the first min(batch_size, 16) images of the valid list
    (the weights are per-channel symmetric, so one representative batch
    suffices; models/quant.py), and the fused reweight+head contraction runs
    as an int8 product too unless FSD_INT8_HEAD=0. Returns whether it
    quantized."""
    if os.environ.get("FSD_INT8", "0") != "1":
        return False
    calib_imgs, _ = next(iter(ds.batches(min(batch_size, 16), drop_last=False)))
    m.quantize_int8(
        calib_imgs, [c.astype(np.float32) for c in codes],
        quant_head=os.environ.get("FSD_INT8_HEAD", "1") == "1",
    )
    print("===> int8 serving calibrated for the sweep")
    return True


def eval_batch_size(default: int = 2) -> int:
    """The reference swept validation at batch 2 (valid.py:37); raise it
    with FSD_EVAL_BATCH."""
    return int(os.environ.get("FSD_EVAL_BATCH", default))


def _open_result_files(prefix: str, names, outfile: str):
    os.makedirs(prefix, exist_ok=True)
    return [open(f"{prefix}/{outfile}{n}.txt", "w") for n in names]


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


def run_valid(
    data_options: dict,
    cfgfile: str,
    weightfile: str,
    settings: Settings,
    outfile: str = "comp4_det_test_",
    batch_size: int | None = None,
    device="cuda",
) -> str:
    """Plain YOLOv2 sweep in full float32 on `device`; boxes routed to files
    by predicted class id. Returns the results prefix."""
    mesh = eval_mesh(device)
    set_float32_precision(tf32=False)
    batch_size = batch_size or eval_batch_size()
    m = PlainDetector(cfgfile, weightfile, device=mesh.device if mesh else device)
    prefix = results_prefix(weightfile, "e")
    if mesh is None or mesh.is_chief:
        print("saving to: " + prefix)
    ds = DetectionDataset(
        data_options["valid"], settings, shape=(m.width, m.height),
        shuffle=False, train=False, filter_valid=False,
    )
    return _plain_sweep(m, ds, prefix, outfile, settings.classes, batch_size, mesh=mesh)


def _plain_sweep(m, ds, prefix, outfile, class_names, batch_size,
                 stats: dict | None = None, mesh=None) -> str:
    """Detection sweep of a PlainDetector over `ds` (the interface of
    `_meta_sweep`). Every (cls_conf, cls_id) pair of a kept box goes to that
    class's file (reference valid.py:62-80). `stats` and `mesh` as in
    `_meta_sweep`."""
    chief = mesh is None or mesh.is_chief
    fps = _open_result_files(prefix, class_names, outfile) if chief else []
    try:
        pipe = _device_pipe(m.region)
        host = functools.partial(plain_host_boxes, m.region)
        line_id = -1
        n_batches = n_device = 0
        for imgs, _ in ds.batches(batch_size, drop_last=False):
            local, n_imgs = _local_batch(imgs, mesh)
            final, done = _batch_boxes(pipe, m(local), host)
            n_batches += 1
            n_device += int(done)
            final = _gathered(final, mesh, n_imgs)
            if final is None:
                continue
            for boxes in final:
                line_id += 1
                imgid = os.path.basename(ds.lines[line_id]).split(".")[0]
                width, height = ds.image_size(line_id)
                for box in boxes:
                    for j in range((len(box) - 5) // 2):
                        cls_id = int(box[6 + 2 * j])
                        _write_boxes(fps[cls_id], imgid, [box[:5] + [box[5 + 2 * j], cls_id]],
                                     width, height)
        if stats is not None:
            stats.update(batches=n_batches, device_batches=n_device,
                         max_candidates=pipe.max_candidates)
    finally:
        for fp in fps:
            fp.close()
    return prefix


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
    """The whole ensemble sweep in full float32 on `device` (int8 under
    FSD_INT8=1, see `quantize_sweep`); returns the results prefix. Under
    FSD_EVAL_MESH rank 0 alone makes the class codes (over every support
    image) and hands them to the other ranks."""
    mesh = eval_mesh(device)
    set_float32_precision(tf32=False)
    batch_size = batch_size or eval_batch_size()
    m = MetaDetector(darknetcfg, learnetcfg, weightfile,
                     metain_type=settings.metain_type, device=mesh.device if mesh else device)
    kind = "ene_" if use_baserw else "ene"
    prefix = results_prefix(weightfile, kind)
    metaset = MetaDataset(
        data_options["meta"], settings, train=False, ensemble=True,
        with_ids=True,
    )
    n_cls = len(metaset.classes)
    codes = _on_chief(mesh, lambda: _ensemble_codes(m, metaset, prefix, settings, use_baserw))
    ds = DetectionDataset(
        data_options["valid"], settings, shape=(m.width, m.height),
        shuffle=False, train=False, filter_valid=False,
    )
    quantize_sweep(m, ds, codes, batch_size)
    # the fixed codes go to the device once; per-batch conversion would
    # cost n_cls transfers on every sweep batch
    fixed = m.commit_codes(codes)
    return _meta_sweep(m, ds, prefix, outfile, lambda: fixed, n_cls,
                       metaset.classes, batch_size, mesh=mesh)


def _ensemble_codes(m: MetaDetector, metaset, prefix: str, settings: Settings,
                    use_baserw: bool) -> list:
    """The ensemble sweep's class codes (valid_ensemble.py:76-112): the
    running mean over every support image, saved under FSD_SAVE_RW, the
    base classes' spliced from the stored pickle with `use_baserw`."""
    print("saving to: " + prefix)
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
    return codes


def run_valid_meta(
    data_options: dict,
    darknetcfg,
    learnetcfg,
    weightfile: str,
    settings: Settings,
    outfile: str = "comp4_det_test_",
    batch_size: int | None = None,
    rng=None,
    device="cuda",
) -> str:
    """Per-batch support codes (reference valid_meta.py): each detection
    batch uses a fresh support batch from the (train=False) meta stream.
    Full float32 on `device`; returns the results prefix.

    The batch size is part of this protocol (codes refresh once per
    detection batch), so FSD_EVAL_BATCH does NOT apply here: the
    reference's batch 2 stays the default. Under FSD_EVAL_MESH rank 0 draws
    each batch's support set and makes its codes for every rank."""
    mesh = eval_mesh(device)
    set_float32_precision(tf32=False)
    batch_size = batch_size or 2
    m = MetaDetector(darknetcfg, learnetcfg, weightfile,
                     metain_type=settings.metain_type, device=mesh.device if mesh else device)
    prefix = results_prefix(weightfile, "e")
    if mesh is None or mesh.is_chief:
        print("saving to: " + prefix)

    # support selection is random per batch, as in the reference's eval
    # loader (dataset.py:345-348); `rng` pins it for parity tests
    metaset = MetaDataset(data_options["meta"], settings, train=False,
                          num_replicas=1, rng=rng)
    n_cls = len(metaset.classes)
    meta_iter = metaset.batches(n_cls)
    ds = DetectionDataset(
        data_options["valid"], settings, shape=(m.width, m.height),
        shuffle=False, train=False, filter_valid=False,
    )
    return _meta_sweep(m, ds, prefix, outfile,
                       lambda: _on_chief(mesh, lambda: m.class_codes(*next(meta_iter))),
                       n_cls, metaset.classes, batch_size, mesh=mesh)


def _write_meta_batch(fps, batch_boxes, ds, bs, n_cls, line_id):
    for b in range(bs):
        line_id += 1
        imgid = os.path.basename(ds.lines[line_id]).split(".")[0]
        width, height = ds.image_size(line_id)
        for i in range(n_cls):
            _write_boxes(fps[i], imgid, batch_boxes[b * n_cls + i], width, height)
    return line_id


def _meta_sweep(m, ds, prefix, outfile, batch_codes, n_cls, class_names, batch_size,
                stats: dict | None = None, mesh=None):
    """Meta detection sweep over `ds`, which yields (images, labels) from
    `batches(batch_size, drop_last=False)` and answers `lines[i]` (a name
    whose basename is the image id) and `image_size(i)`; `batch_codes()`
    gives the class codes of each batch, called once per batch before its
    forward (fixed codes, or a fresh support batch's). Returns the results
    prefix. A `stats` dict, when given, receives the number of `batches`, of
    `device_batches` (those the device pipeline finished without handing the
    batch to the host path) and `max_candidates` (the most candidates above
    the threshold in any row, to hold against the buffer size), counted on
    this rank. With a `mesh` each rank runs its block of every batch, rank 0
    gathers the box lists and writes the files (`batch_codes` must then give
    every rank the same codes)."""
    chief = mesh is None or mesh.is_chief
    fps = _open_result_files(prefix, class_names, outfile) if chief else []
    try:
        pipe = _device_pipe(m.region, n_cls)
        host = functools.partial(meta_host_boxes, m.region, n_cls=n_cls)
        line_id = -1
        n_batches = n_device = 0
        for imgs, _ in ds.batches(batch_size, drop_last=False):
            codes = batch_codes()
            local, n_imgs = _local_batch(imgs, mesh)
            batch_boxes, done = _batch_boxes(pipe, m.detect(local, codes), host)
            n_batches += 1
            n_device += int(done)
            batch_boxes = _gathered(batch_boxes, mesh, n_imgs * n_cls)
            if batch_boxes is not None:
                line_id = _write_meta_batch(fps, batch_boxes, ds, n_imgs, n_cls, line_id)
        if stats is not None:
            stats.update(batches=n_batches, device_batches=n_device,
                         max_candidates=pipe.max_candidates)
    finally:
        for fp in fps:
            fp.close()
    return prefix
