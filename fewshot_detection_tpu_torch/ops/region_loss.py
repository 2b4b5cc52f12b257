"""YOLOv2 region loss — targets built ON DEVICE, fully vectorized.

Counterpart of the JAX package's `ops/region_loss.py`. The reference
(region_loss.py) decoded predictions on the GPU, copied them to the CPU
every step (region_loss.py:298), and built targets with a python double loop
over images x 50 gt slots (region_loss.py:37-132). Here everything stays on
the device and nothing synchronises with the host:

  * silence-mask: one broadcast IoU (nB, A*H*W, 50) + max-reduce
  * best-anchor assignment: argmax over anchor IoUs per gt slot
  * target planes: ONE scatter for all nine planes after an up-front
    duplicate-cell deduplication that preserves the reference's
    LAST-WRITE-WINS ordering; dropped slots go to one spare slot behind the
    planes (an out-of-range index would be a device-side assert, and a
    duplicate index has no defined winner on CUDA)
  * neg_filter (region_loss.py:15-34) becomes a per-copy 0/1 `keep` weight
    sampled on host (sample_neg_keep) so shapes stay static; positives are
    always kept, so loss values match the reference's row-dropping exactly

Loss terms replicate region_loss.py:340-355: MSE/2 on sigmoid(x),sigmoid(y),
w,h with 0/1 coord mask (all-ones warm-up while seen<12800), MSE/2 on conf
weighted by conf_mask (noobject_scale baseline, 0 where a pred overlaps any
gt above sil_thresh, object_scale at assigned cells), and cross-entropy for
classification — per-anchor over nC for the plain loss, ACROSS the n_cls
batch copies for the meta loss (RegionLossV2, region_loss.py:252-366).

`seen` is a host integer: the warm-up switch is decided in Python.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.spec import RegionSpec
from .boxes import iou_xywh_t

# seen < warmup_seen trains EVERY cell of EVERY copy toward the constant
# box prior (tx=ty=0.5, tw=th=0, region_loss.py:70-79). The reference
# hardcodes 12800; here it is a Settings field (settings.warmup_seen)
# threaded through the trainer.
WARMUP_SEEN_DEFAULT = 12800

_PLANES = ("coord_mask", "cls_mask", "conf_mask", "tx", "ty", "tw", "th", "tconf", "tcls")


# ---------------------------------------------------------------------------
# host-side negative-copy sampling (replaces neg_filter's row dropping)
# ---------------------------------------------------------------------------


def sample_neg_keep(
    target: np.ndarray, neg_ratio, rng: np.random.RandomState | None = None
) -> np.ndarray:
    """0/1 keep weight per (image, class) copy.

    target: (nB, 50*5). 'full' keeps everything; a numeric ratio keeps all
    positive copies and negatives with prob ratio*npos/nneg
    (region_loss.py:15-34)."""
    n = target.shape[0]
    if neg_ratio == "full":
        return np.ones(n, np.float32)
    rng = rng or np.random
    pos = (np.abs(target).sum(1) != 0).astype(np.float32)
    npos = pos.sum()
    nneg = n - npos
    if nneg == 0:
        return np.ones(n, np.float32)
    ratio = float(neg_ratio) * npos / nneg
    if ratio >= 1:
        return np.ones(n, np.float32)
    u = rng.rand(n)
    return np.where(pos > 0, 1.0, (u <= ratio).astype(np.float32)).astype(np.float32)


# ---------------------------------------------------------------------------
# on-device target building
# ---------------------------------------------------------------------------


def _anchors(region: RegionSpec, device) -> torch.Tensor:
    return torch.tensor(region.anchor_wh, dtype=torch.float32, device=device)  # (A, 2)


def _decode_pred_boxes(o: torch.Tensor, region: RegionSpec) -> torch.Tensor:
    """o: (nB, A, 5+nC, H, W) raw. Returns grid-unit boxes (nB, A, H, W, 4)
    (detached: targets never backprop)."""
    o = o.detach()
    H, W = o.shape[-2:]
    grid_x = torch.arange(W, dtype=torch.float32, device=o.device)[None, None, None, :]
    grid_y = torch.arange(H, dtype=torch.float32, device=o.device)[None, None, :, None]
    anchors = _anchors(region, o.device)
    aw = anchors[:, 0][None, :, None, None]
    ah = anchors[:, 1][None, :, None, None]
    px = torch.sigmoid(o[:, :, 0]) + grid_x
    py = torch.sigmoid(o[:, :, 1]) + grid_y
    pw = torch.exp(o[:, :, 2]) * aw
    ph = torch.exp(o[:, :, 3]) * ah
    return torch.stack([px, py, pw, ph], dim=-1)


@torch.no_grad()
def build_targets(
    pred_boxes: torch.Tensor,
    target: torch.Tensor,
    region: RegionSpec,
    H: int,
    W: int,
    seen: int,
    warmup_seen: int = WARMUP_SEEN_DEFAULT,
) -> dict[str, torch.Tensor]:
    """Vectorized equivalent of region_loss.py:37-132.

    pred_boxes: (nB, A, H, W, 4) in grid units; target: (nB, 50, 5)
    normalized [cls, cx, cy, w, h], zero-padded.

    Returns dict of (nB, A, H, W) planes + counters (0-d tensors).
    """
    nB, A = pred_boxes.shape[:2]
    dev = pred_boxes.device
    anchors = _anchors(region, dev)

    t = target.to(torch.float32)
    valid = t[:, :, 1] > 0  # (nB, 50) — packed rows, 0-pad tail
    gx = t[:, :, 1] * W
    gy = t[:, :, 2] * H
    gw = t[:, :, 3] * W
    gh = t[:, :, 4] * H
    gt_boxes = torch.stack([gx, gy, gw, gh], dim=-1)  # (nB, 50, 4)

    # --- conf silencing: any pred with IoU > sil_thresh vs any gt ---
    pb_flat = pred_boxes.reshape(nB, -1, 4)  # (nB, AHW, 4)
    ious = iou_xywh_t(pb_flat[:, :, None, :], gt_boxes[:, None, :, :])
    ious = torch.where(valid[:, None, :], ious, torch.zeros_like(ious))
    cur_ious = ious.max(dim=2).values.reshape(nB, A, H, W)
    warmup = int(seen) < warmup_seen

    shape = (nB, A, H, W)
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    planes = torch.stack([
        torch.full_like(zeros, 1.0 if warmup else 0.0),  # coord_mask
        zeros,  # cls_mask
        torch.where(cur_ious > region.thresh, 0.0, float(region.noobject_scale)).to(torch.float32),
        torch.full_like(zeros, 0.5 if warmup else 0.0),  # tx
        torch.full_like(zeros, 0.5 if warmup else 0.0),  # ty
        zeros, zeros, zeros, zeros,  # tw, th, tconf, tcls
    ])  # (9, nB, A, H, W)

    # --- best anchor per gt: IoU of (0,0,gw,gh) vs (0,0,aw,ah) ---
    wh_gt = torch.stack([torch.zeros_like(gw), torch.zeros_like(gh), gw, gh], dim=-1)
    wh_anchor = torch.cat([torch.zeros((A, 2), device=dev), anchors], dim=-1)  # (A, 4)
    anchor_ious = iou_xywh_t(wh_gt[:, :, None, :], wh_anchor[None, None, :, :])  # (nB, 50, A)
    best_n = torch.argmax(anchor_ious, dim=-1)  # first max, like the ref loop

    # the cast truncates towards zero, as the reference's int() does
    gi = gx.to(torch.int64).clamp(0, W - 1)
    gj = gy.to(torch.int64).clamp(0, H - 1)

    # pred box at the assigned cell, IoU with gt -> tconf
    b_idx = torch.arange(nB, device=dev)[:, None]
    assigned_pred = pred_boxes[b_idx, best_n, gj, gi]  # (nB, 50, 4)
    assigned_iou = iou_xywh_t(gt_boxes, assigned_pred)  # (nB, 50)

    aw_sel = anchors[best_n, 0]
    ah_sel = anchors[best_n, 1]
    val_tx = gx - gi
    val_ty = gy - gj
    val_tw = torch.log(torch.clamp(gw, min=1e-12) / aw_sel)
    val_th = torch.log(torch.clamp(gh, min=1e-12) / ah_sel)

    nGT = valid.sum()
    nCorrect = (valid & (assigned_iou > 0.5)).sum()

    # The reference assigns gts sequentially, so when two gts land on the
    # same (anchor, cell) the LAST write wins. Deduplicate up front — mask
    # any slot that a LATER valid slot overwrites — then do ONE scatter;
    # with unique indices the scatter order is irrelevant.
    n_slots = target.shape[1]
    lin = (best_n * H + gj) * W + gi  # (nB, 50) linearized cell index
    eq = lin[:, :, None] == lin[:, None, :]
    later = torch.triu(torch.ones((n_slots, n_slots), dtype=torch.bool, device=dev), diagonal=1)
    overwritten = (eq & later[None] & valid[:, None, :]).any(dim=2)
    keep = valid & ~overwritten

    # dropped slots all land in one spare slot behind the planes
    cells = nB * A * H * W
    flat = b_idx * (A * H * W) + lin
    flat = torch.where(keep, flat, torch.full_like(flat, cells)).reshape(-1)
    ones = torch.ones_like(val_tx)
    vals = torch.stack([
        ones,  # coord_mask
        ones,  # cls_mask
        torch.full_like(val_tx, float(region.object_scale)),  # conf_mask
        val_tx, val_ty, val_tw, val_th,
        assigned_iou,
        t[:, :, 0],  # tcls
    ]).reshape(len(_PLANES), -1)
    padded = torch.cat(
        [planes.reshape(len(_PLANES), cells), torch.zeros((len(_PLANES), 1), device=dev)], dim=1
    )
    padded.scatter_(1, flat[None].expand(len(_PLANES), -1), vals)
    planes = padded[:, :cells].reshape(len(_PLANES), *shape)

    out = {name: planes[i] for i, name in enumerate(_PLANES)}
    out["nGT"] = nGT
    out["nCorrect"] = nCorrect
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _split_output(output: torch.Tensor, region: RegionSpec):
    """(nB, H, W, A*(5+nC)) -> raw (nB, A, 5+nC, H, W) + activated parts."""
    nB, H, W, _ = output.shape
    A = region.num_anchors
    nC = region.num_classes
    # loss math in float32 regardless of the network's compute dtype
    o = output.to(torch.float32).reshape(nB, H, W, A, 5 + nC).permute(0, 3, 4, 1, 2)
    x = torch.sigmoid(o[:, :, 0])
    y = torch.sigmoid(o[:, :, 1])
    w = o[:, :, 2]
    h = o[:, :, 3]
    conf = torch.sigmoid(o[:, :, 4])
    cls_logits = o[:, :, 5:]  # (nB, A, nC, H, W)
    return o, x, y, w, h, conf, cls_logits


def _coord_conf_losses(parts, tgt, keep, region: RegionSpec):
    _, x, y, w, h, conf, _ = parts
    km = keep[:, None, None, None]
    cm = tgt["coord_mask"] * km
    cfm = tgt["conf_mask"] * km  # == sqrt(conf_mask)^2 in the MSE
    cs = region.coord_scale
    loss_x = cs * torch.sum(cm * torch.square(x - tgt["tx"])) / 2.0
    loss_y = cs * torch.sum(cm * torch.square(y - tgt["ty"])) / 2.0
    loss_w = cs * torch.sum(cm * torch.square(w - tgt["tw"])) / 2.0
    loss_h = cs * torch.sum(cm * torch.square(h - tgt["th"])) / 2.0
    loss_conf = torch.sum(cfm * torch.square(conf - tgt["tconf"])) / 2.0
    return loss_x, loss_y, loss_w, loss_h, loss_conf


def _masked_cross_entropy(rows: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Sum over the masked rows of -log_softmax(rows)[label]. A label under
    a zero mask may lie outside the row (it is a sum over copies, or padding);
    it is replaced before the gather, and the row is selected away after it."""
    n = rows.shape[-1]
    labels = torch.where(mask, labels, torch.zeros_like(labels)).clamp(0, n - 1)
    logp = torch.log_softmax(rows, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.sum(torch.where(mask, ce, torch.zeros_like(ce)))


def _metrics(tgt, parts, keep, losses, loss_cls):
    total = losses[0] + losses[1] + losses[2] + losses[3] + losses[4] + loss_cls
    n_proposals = torch.sum((parts[5] > 0.25) * keep[:, None, None, None])
    metrics = {
        "nGT": tgt["nGT"],
        "nCorrect": tgt["nCorrect"],
        "nProposals": n_proposals,
        "loss_x": losses[0],
        "loss_y": losses[1],
        "loss_w": losses[2],
        "loss_h": losses[3],
        "loss_conf": losses[4],
        "loss_cls": loss_cls,
        "loss": total,
    }
    return total, metrics


def region_loss(
    output: torch.Tensor,
    target: torch.Tensor,
    keep: torch.Tensor,
    seen: int,
    region: RegionSpec,
    *,
    zero_tcls: bool = False,
    warmup_seen: int = WARMUP_SEEN_DEFAULT,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Plain YOLOv2 loss (RegionLoss, region_loss.py:134-232).

    output: (nB, H, W, A*(5+nC)); target: (nB, 50, 5); keep: (nB,) 0/1;
    seen: host int. zero_tcls replicates the `cfg.metayolo` tcls.zero_()
    branch (region_loss.py:198-199)."""
    nB, H, W, _ = output.shape
    parts = _split_output(output, region)
    pred_boxes = _decode_pred_boxes(parts[0], region)
    tgt = build_targets(pred_boxes, target, region, H, W, seen, warmup_seen)
    losses = _coord_conf_losses(parts, tgt, keep, region)

    nC = region.num_classes
    rows = parts[6].permute(0, 1, 3, 4, 2).reshape(-1, nC)
    mask = (tgt["cls_mask"] * keep[:, None, None, None]).reshape(-1) > 0
    labels = tgt["tcls"].reshape(-1).to(torch.int64)
    if zero_tcls:
        labels = torch.zeros_like(labels)
    loss_cls = region.class_scale * _masked_cross_entropy(rows, labels, mask)
    return _metrics(tgt, parts, keep, losses, loss_cls)


def region_loss_v2(
    output: torch.Tensor,
    target: torch.Tensor,
    keep: torch.Tensor,
    seen: int,
    region: RegionSpec,
    n_cls: int,
    *,
    warmup_seen: int = WARMUP_SEEN_DEFAULT,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Meta region loss (RegionLossV2, region_loss.py:234-366).

    output: (bs*n_cls, H, W, A*(5+1)) b-major; target: (bs, n_cls, 50, 5);
    keep: (bs*n_cls,) 0/1 per copy. Classification is a softmax ACROSS the
    n_cls copies of each anchor: per (image, anchor, cell) location marked
    by exactly one kept copy's gt, CE over copies with the copy index as
    label (the merged-histogram logic of region_loss.py:303-335)."""
    if region.num_classes != 1:
        raise NotImplementedError("RegionLossV2 expects single-class copies")
    bs = target.shape[0]
    nB = output.shape[0]
    if nB != bs * n_cls:
        raise ValueError(f"output has {nB} rows for {bs} images x {n_cls} classes")
    H, W = output.shape[1:3]

    parts = _split_output(output, region)
    pred_boxes = _decode_pred_boxes(parts[0], region)
    tgt = build_targets(
        pred_boxes, target.reshape(nB, *target.shape[2:]), region, H, W, seen, warmup_seen
    )
    losses = _coord_conf_losses(parts, tgt, keep, region)

    # ---- cross-copy classification ----
    A = region.num_anchors
    cls_logits = parts[6][:, :, 0]  # (bs*n_cls, A, H, W), nC == 1
    rows = cls_logits.reshape(bs, n_cls, A, H, W).permute(0, 2, 3, 4, 1)
    # merged per-image mask / labels over KEPT copies (histogram merge)
    km = keep[:, None, None, None]
    cm = (tgt["cls_mask"] * km).reshape(bs, n_cls, A, H, W).sum(dim=1)
    tc = (tgt["tcls"] * tgt["cls_mask"] * km).reshape(bs, n_cls, A, H, W).sum(dim=1)
    # where two kept copies mark one cell the summed label can reach n_cls
    # or more; the mask excludes exactly those cells
    loss_cls = region.class_scale * _masked_cross_entropy(rows, tc.to(torch.int64), cm == 1)
    return _metrics(tgt, parts, keep, losses, loss_cls)
