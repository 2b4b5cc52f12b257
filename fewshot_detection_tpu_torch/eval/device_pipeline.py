"""Fixed-buffer detection pipeline on the device: decode -> rank -> NMS.

The reference's inference path decoded on GPU then filtered + NMS'd with
python loops on host (reference utils.py:112-193, 85-104). This variant
keeps everything on the device with fixed shapes: raw head output in, a
fixed-size (R, K, 7) box buffer + keep mask out, one small copy to the host
per batch. The NMS inside is `ops.nms_device.nms_rows`: the CUDA kernel for a
CUDA tensor, its plain version for a CPU tensor.

Parity: for rows whose candidate count above conf_thresh is <= top_k, the
kept boxes equal the host path's (same decode, same greedy NMS order, ties
broken identically by the stable sort). `eval_boxes` returns None for a
batch the buffer would truncate and the caller redoes it on the host path,
so result files are the same in every regime.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.boxes import decode_region_output
from ..ops.nms_device import nms_rows


def _decode_rank(
    output: torch.Tensor,
    n_cls: int | None,
    anchors: tuple[tuple[float, float], ...],
    num_classes: int,
    conf_thresh: float,
    top_k: int,
    validation: bool = True,
):
    """Decode, class softmax, threshold and rank: everything of the
    pipelines before the NMS. Returns (bsel (R,K,4), dsel (R,K), cconf
    (R,K), cid (R,K) int64, counts (R,) int32, csel (R,K,nC)).

    n_cls=None is the plain YOLOv2 head (the JAX package's `_pipeline`):
    per-anchor softmax over the nC classes, `cid` the argmax class of each
    candidate (the first of tied maxima, as numpy and JAX take it).
    Otherwise the meta head (`_pipeline_v2`): softmax ACROSS the n_cls
    image-major copies of each image (reference utils.py:212-219), `cid`
    the row's class position. `validation` thresholds on
    det*max_cls_conf (the mAP sweeps, reference valid.py:60); without it on
    det alone (serving, reference utils.py:112-193 only_objectness)."""
    decoded = decode_region_output(output, anchors, num_classes)
    bn = output.shape[0]
    logits = decoded["cls_logits"]  # (R, A, H, W, nC)
    if n_cls is None:
        sm = torch.softmax(logits, dim=-1)
    else:
        # softmax ACROSS the n_cls copies of each image: axis 1, not the last
        sm = torch.softmax(
            logits.reshape(bn // n_cls, n_cls, *logits.shape[1:]), dim=1
        ).reshape(logits.shape)

    # flatten candidates in the host loop order (cy, cx, anchor) so NMS
    # tie-breaking matches ops.boxes.filter_boxes + nms exactly
    boxes = decoded["boxes"].permute(0, 2, 3, 1, 4).reshape(bn, -1, 4)
    det = decoded["det_conf"].permute(0, 2, 3, 1).reshape(bn, -1)
    cls_full = sm.permute(0, 2, 3, 1, 4).reshape(bn, -1, sm.shape[-1])
    cls = cls_full.amax(dim=-1)
    if n_cls is None:
        cid = cls_full.argmax(dim=-1)
    else:
        # integer class position: a float index in the compute dtype would
        # go inexact past 256 rows and misroute boxes to the wrong per-class
        # file; it becomes a float only in the final concatenate
        cid = (torch.arange(bn, device=output.device) % n_cls)[:, None].expand(-1, det.shape[1])

    # rank and NMS on objectness — the host nms key (utils.py:85-104)
    mask = (det * cls if validation else det) > conf_thresh
    # The host sorts ascending on the float32 key (1 - det) with a STABLE
    # argsort; dets that collide after that rounding must stay ties here
    # too, so rank on -(1 - det) rather than raw det. Masked-out candidates
    # get a sentinel below any real key (keys live in (-1, 0]). torch.topk
    # promises no order among ties, so this is a stable descending sort cut
    # to the buffer size.
    one = torch.ones((), dtype=torch.float32, device=output.device)
    scores = torch.where(mask, -(one - det.float()), -2.0 * one)
    top_k = min(top_k, scores.shape[-1])  # buffer can cover ALL candidates
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :top_k], idx[:, :top_k]
    counts = mask.sum(dim=-1, dtype=torch.int32)

    bsel = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)).contiguous()
    dsel = torch.where(
        top_scores > -1.5, torch.gather(det, 1, idx), torch.zeros_like(top_scores)
    ).contiguous()
    cconf = torch.gather(cls, 1, idx)
    csel = torch.gather(cls_full, 1, idx[..., None].expand(-1, -1, cls_full.shape[-1]))
    return bsel, dsel, cconf, torch.gather(cid, 1, idx), counts, csel


def _nms_and_rows(bsel, dsel, cconf, cid, nms_thresh: float):
    """Greedy NMS over the ranked buffer (conf-descending, so NMS order ==
    identity and `keep` aligns with the buffer rows), and the rows
    [cx cy w h det cls_conf class_idx]."""
    keep = nms_rows(bsel, dsel, nms_thresh)
    rows = torch.cat(
        [bsel, dsel[..., None], cconf[..., None], cid[..., None].to(bsel.dtype)],
        dim=-1,
    )
    return rows, keep


def _kept_boxes(rows: np.ndarray, keep: np.ndarray):
    """(row index, [cx, cy, w, h, det, cls_conf, class_idx]) of every kept
    slot, in buffer order. The float32 values become Python floats exactly;
    the class index is rounded to an int. One bulk conversion per batch."""
    b_idx, r_idx = np.nonzero(keep)
    sel = rows[b_idx, r_idx]
    cids = np.rint(sel[:, 6]).astype(np.int64).tolist()
    return [(b, vals + [cid]) for b, vals, cid in zip(b_idx.tolist(), sel[:, :6].tolist(), cids)]


def _to_box_lists(rows, keep) -> list[list[list[float]]]:
    rows, keep = rows.cpu().numpy(), keep.cpu().numpy()
    out: list = [[] for _ in range(rows.shape[0])]
    for b, box in _kept_boxes(rows, keep):
        out[b].append(box)
    return out


def _rows_to_eval_boxes(rows, keep, csel, conf_thresh):
    """Convert the pipeline's device tensors into the host sweep's box-list
    format: [cx, cy, w, h, det, cls_conf, cls_id, (extra cls_conf,
    cls_id)...] per kept box — the `validation=True` contract of
    ops.boxes.filter_boxes (reference utils.py:160-184). The caller has
    already made sure that the buffer truncated nothing. Each tensor crosses
    to the host in one copy."""
    rows, keep = rows.cpu().numpy(), keep.cpu().numpy()
    n_classes = csel.shape[-1]
    out: list = [[] for _ in range(rows.shape[0])]
    kept = _kept_boxes(rows, keep)
    if n_classes > 1:
        csel = csel.cpu().numpy()[np.nonzero(keep)]  # (kept, nC), same order
        for (b, box), conf in zip(kept, csel):
            # `best` from the class-conf row itself: box[6] is the
            # class-COPY index here (the writers key on row position)
            det, best = box[4], int(np.argmax(conf))
            for c in range(n_classes):
                tc = float(conf[c])
                if c != best and det * tc > conf_thresh:
                    box.extend([tc, c])
    for b, box in kept:
        out[b].append(box)
    return out


class DevicePipeline:
    """On-device decode + per-image NMS for the plain YOLOv2 detector.

    `__call__(raw_output) -> list of per-image reference-format box lists`
    (``[cx, cy, w, h, det_conf, cls_conf, cls_id]``, kept boxes in
    objectness-descending order — the ops.boxes.nms contract). An image with
    more than top_k candidates above conf_thresh keeps the top_k
    highest-objectness ones there (`eval_boxes` reports that instead; a
    top_k above the grid's anchor count is cut to it, so a buffer can hold
    every candidate). `validation=False` is serving (threshold on
    objectness, `detect`);
    `validation=True` the mAP sweeps' semantics. Runs on whatever device
    `output` lies on.
    """

    n_cls = None  # one row per image

    def __init__(
        self,
        region,
        conf_thresh: float = 0.5,
        nms_thresh: float = 0.4,
        top_k: int = 128,
        validation: bool = False,
    ):
        self.anchors = region.anchor_wh
        self.num_classes = region.num_classes
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.top_k = top_k
        self.validation = validation
        # most candidates above conf_thresh that any row handed to
        # `eval_boxes` has held: the sweep's margin to the buffer size
        self.max_candidates = 0

    def _ranked(self, output: torch.Tensor):
        return _decode_rank(
            output.float(), self.n_cls, self.anchors, self.num_classes,
            self.conf_thresh, self.top_k, self.validation,
        )

    def device_call(self, output: torch.Tensor):
        """(rows, keep) device tensors, one row per image (per (image,
        class), image-major, for the meta pipeline)."""
        bsel, dsel, cconf, cid, _, _ = self._ranked(output)
        return _nms_and_rows(bsel, dsel, cconf, cid, self.nms_thresh)

    def eval_boxes(self, output: torch.Tensor):
        """Post-NMS per-row box lists in the host path's exact format (with
        `validation`, incl. the reference's extra (cls_conf, cls_id) pairs),
        or None when the fixed buffer truncated: the caller then redoes the
        batch on the host path, so its results are the same in every
        regime. The candidate counts are looked at before the NMS, so a
        batch that goes to the host path launches no NMS kernel."""
        bsel, dsel, cconf, cid, counts, csel = self._ranked(output)
        most = int(counts.max()) if counts.numel() else 0
        self.max_candidates = max(self.max_candidates, most)
        if most > self.top_k:
            return None
        rows, keep = _nms_and_rows(bsel, dsel, cconf, cid, self.nms_thresh)
        if not self.validation:
            return _to_box_lists(rows, keep)
        return _rows_to_eval_boxes(rows, keep, csel, self.conf_thresh)

    def __call__(self, output: torch.Tensor) -> list[list[list[float]]]:
        rows, keep = self.device_call(output)
        return _to_box_lists(rows, keep)


class MetaDevicePipeline(DevicePipeline):
    """On-device decode + per-(image, class) NMS for the META detector.

    The serving counterpart of the get_region_boxes_v2 + host-nms eval path
    (reference valid_ensemble.py:137-178): raw detect_forward output in
    (image-major B*n_cls rows), kept boxes out, one small copy to the host
    per batch, ``[cx, cy, w, h, det_conf, cls_conf, class_idx]`` per kept
    box with class_idx the row's class position. Thresholds on det*cls (the
    sweeps' semantics); truncates like `DevicePipeline`.
    """

    def __init__(
        self,
        region,
        n_cls: int,
        conf_thresh: float = 0.25,
        nms_thresh: float = 0.45,
        top_k: int = 128,
    ):
        super().__init__(region, conf_thresh, nms_thresh, top_k, validation=True)
        self.n_cls = n_cls
