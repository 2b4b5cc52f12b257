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
    n_cls: int,
    anchors: tuple[tuple[float, float], ...],
    num_classes: int,
    conf_thresh: float,
    top_k: int,
):
    """Decode, cross-copy softmax, threshold and rank: everything of
    `_pipeline_v2` before the NMS. Returns (bsel (R,K,4), dsel (R,K),
    cconf (R,K), cid (R,K) int64, counts (R,) int32, csel (R,K,nC))."""
    decoded = decode_region_output(output, anchors, num_classes)
    bn = output.shape[0]
    logits = decoded["cls_logits"]  # (B*n, A, H, W, nC)
    # softmax ACROSS the n_cls copies of each image: axis 1, not the last
    sm = torch.softmax(
        logits.reshape(bn // n_cls, n_cls, *logits.shape[1:]), dim=1
    ).reshape(logits.shape)
    # metayolo heads are single-class per copy; rank by the max class conf
    cls_conf = sm.amax(dim=-1)

    boxes = decoded["boxes"].permute(0, 2, 3, 1, 4).reshape(bn, -1, 4)
    det = decoded["det_conf"].permute(0, 2, 3, 1).reshape(bn, -1)
    cls = cls_conf.permute(0, 2, 3, 1).reshape(bn, -1)
    cls_full = sm.permute(0, 2, 3, 1, 4).reshape(bn, -1, sm.shape[-1])

    # threshold on det*cls (validation semantics, reference utils.py:255-282)
    # but rank and NMS on objectness — the host nms key (utils.py:85-104)
    mask = det * cls > conf_thresh
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
    # integer class position: a float index in the compute dtype would go
    # inexact past 256 rows and misroute boxes to the wrong per-class file;
    # it becomes a float only in the final concatenate
    cid = (torch.arange(bn, device=output.device) % n_cls)[:, None].expand(-1, top_k)
    return bsel, dsel, cconf, cid, counts, csel


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


def _pipeline_v2(
    output: torch.Tensor,
    n_cls: int,
    anchors: tuple[tuple[float, float], ...],
    num_classes: int,
    conf_thresh: float,
    nms_thresh: float,
    top_k: int,
):
    """Meta-detector decode: cross-copy class softmax (reference
    utils.py:212-219) normalizes class confidence ACROSS the n_cls batch
    copies, then each (image, class) row is thresholded on det*cls and
    greedily NMS'd on objectness — all on the device with fixed buffers.

    output: (B*n_cls, H, W, A*(5+nC)) image-major. Returns (rows, keep,
    counts, csel) with leading dim B*n_cls; rows are [cx cy w h det
    cls_conf class_idx] (class_idx = the row's class position, which is what
    routes boxes to per-class result files in the meta sweeps)."""
    bsel, dsel, cconf, cid, counts, csel = _decode_rank(
        output.float(), n_cls, anchors, num_classes, conf_thresh, top_k
    )
    rows, keep = _nms_and_rows(bsel, dsel, cconf, cid, nms_thresh)
    return rows, keep, counts, csel


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


class MetaDevicePipeline:
    """On-device decode + per-(image, class) NMS for the META detector.

    The serving counterpart of the get_region_boxes_v2 + host-nms eval path
    (reference valid_ensemble.py:137-178): raw detect_forward output in
    (image-major B*n_cls rows), kept boxes out, one small copy to the host
    per batch. Rows with more than top_k candidates above conf_thresh keep
    the top_k highest-objectness ones (`eval_boxes` reports that instead).
    Runs on whatever device `output` lies on.
    """

    def __init__(
        self,
        region,
        n_cls: int,
        conf_thresh: float = 0.25,
        nms_thresh: float = 0.45,
        top_k: int = 128,
    ):
        self.anchors = region.anchor_wh
        self.num_classes = region.num_classes
        self.n_cls = n_cls
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.top_k = top_k
        # most candidates above conf_thresh that any row handed to
        # `eval_boxes` has held: the sweep's margin to the buffer size
        self.max_candidates = 0

    def device_call(self, output: torch.Tensor):
        """(rows, keep) device tensors, leading dim B*n_cls image-major."""
        return _pipeline_v2(
            output, self.n_cls, self.anchors, self.num_classes,
            self.conf_thresh, self.nms_thresh, self.top_k,
        )[:2]

    def eval_boxes(self, output: torch.Tensor):
        """Post-NMS per-(image, class) box lists in the host sweep's exact
        format, or None when the fixed buffer truncated (host path then).
        The candidate counts are looked at before the NMS, so a batch that
        goes to the host path launches no NMS kernel."""
        bsel, dsel, cconf, cid, counts, csel = _decode_rank(
            output.float(), self.n_cls, self.anchors, self.num_classes,
            self.conf_thresh, self.top_k,
        )
        most = int(counts.max()) if counts.numel() else 0
        self.max_candidates = max(self.max_candidates, most)
        if most > self.top_k:
            return None
        rows, keep = _nms_and_rows(bsel, dsel, cconf, cid, self.nms_thresh)
        return _rows_to_eval_boxes(rows, keep, csel, self.conf_thresh)

    def __call__(self, output: torch.Tensor) -> list[list[list[float]]]:
        """B*n_cls per-(image, class) box lists, ``[cx, cy, w, h, det_conf,
        cls_conf, class_idx]``, kept boxes in objectness-descending order."""
        rows, keep = self.device_call(output)
        return _to_box_lists(rows, keep)
