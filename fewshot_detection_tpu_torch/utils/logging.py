"""Timestamped logging + per-step loss line (utils.py:571-572,
region_loss.py:364 of the reference)."""

from __future__ import annotations

import time

import torch

from .profiling import span

_KEYS = ("nGT", "nCorrect", "nProposals", "loss_x", "loss_y", "loss_w", "loss_h",
         "loss_conf", "loss_cls", "loss")


def log(message: str) -> None:
    print(f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime())} {message}")


def format_loss_line(seen: int, metrics: dict) -> str:
    """The step's loss line. The [yolo] loss's `loss_iou` (its CIoU box
    term, where the heads take one), `positives` (one count a head),
    `extra_positives` (where `iou_thresh` assigns any) and `ignored` come in
    the same transfer and end the line."""
    # fetch the whole metrics dict in ONE device transfer: a float() per
    # scalar would synchronise with the device ten times a step (the
    # `train.sync` span)
    extra = [k for k in ("loss_iou", "positives", "extra_positives", "ignored") if k in metrics]
    with span("train.sync"):
        vals = torch.cat([torch.as_tensor(metrics[k]).to(torch.float64).reshape(-1)
                          for k in _KEYS + tuple(extra)]).tolist()
    g = dict(zip(_KEYS, vals))
    line = (
        f"{seen}: nGT {int(g['nGT'])}, recall {int(g['nCorrect'])}, "
        f"proposals {int(g['nProposals'])}, loss: x {g['loss_x']:f}, "
        f"y {g['loss_y']:f}, w {g['loss_w']:f}, h {g['loss_h']:f}, "
        f"conf {g['loss_conf']:f}, cls {g['loss_cls']:f}, total {g['loss']:f}"
    )
    rest = vals[len(_KEYS):]
    if "loss_iou" in metrics:
        line += f", iou {rest.pop(0):f}"
    if "positives" in metrics:
        n = torch.as_tensor(metrics["positives"]).numel()
        line += f", positives {'/'.join(str(int(v)) for v in rest[:n])}"
        rest = rest[n:]
        if "extra_positives" in metrics:
            line += f", extra {int(rest.pop(0))}"
        line += f", ignored {int(rest.pop(0))}"
    return line
