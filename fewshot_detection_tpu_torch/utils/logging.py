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
    # fetch the whole metrics dict in ONE device transfer: a float() per
    # scalar would synchronise with the device ten times a step (the
    # `train.sync` span)
    with span("train.sync"):
        vals = torch.stack([torch.as_tensor(metrics[k]).to(torch.float64)
                            for k in _KEYS]).tolist()
    g = dict(zip(_KEYS, vals))
    return (
        f"{seen}: nGT {int(g['nGT'])}, recall {int(g['nCorrect'])}, "
        f"proposals {int(g['nProposals'])}, loss: x {g['loss_x']:f}, "
        f"y {g['loss_y']:f}, w {g['loss_w']:f}, h {g['loss_h']:f}, "
        f"conf {g['loss_conf']:f}, cls {g['loss_cls']:f}, total {g['loss']:f}"
    )
