"""Inputs made from the seed: painted scenes, their labels, support sets,
and the seeded weights of a net.

A scene is dark noise with one to `max_objects` bright rectangles; the
noise gives the batch-norm statistics texture (its amplitude, drawn a
scene from the mix's `background_noise` range, sets how many candidates a
trained detector finds), and the rectangles are the labelled objects. The
layout of each scene (its rectangles, their classes and colours, its
noise) is drawn on the host from a numpy generator of the seed; the
pixels are painted on the device in a few large calls from a torch
generator of the same seed, so that every seed costs the same work.
"""

from __future__ import annotations

import numpy as np
import torch


def torch_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def layouts(rng: np.random.Generator, n: int, n_classes: int, max_objects: int,
            first_class=None, noise=(0.0, 0.0)) -> list[list[tuple]]:
    """n scene layouts: [(cls, cx, cy, w, h, r, g, b)] normalised, each
    list carrying its background's noise amplitude, drawn in `noise`, as
    `.noise`. The first object of scene i has class first_class(i) when
    given."""
    out = []
    for i in range(n):
        amp = float(rng.uniform(*noise))
        objs = []
        for j in range(int(rng.integers(1, max_objects + 1))):
            w, h = rng.uniform(0.15, 0.5, 2)
            cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
            cls = first_class(i) if (j == 0 and first_class) else int(rng.integers(n_classes))
            objs.append((cls, cx, cy, w, h, *rng.uniform(120 / 255, 1.0, 3)))
        out.append(Scene(objs, amp))
    return out


class Scene(list):
    """A scene's objects, with its background noise amplitude."""

    def __init__(self, objs, noise: float):
        super().__init__(objs)
        self.noise = noise


def paint(scenes, height: int, width: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, height, width, 3) float32 in [0, 1] on `device`."""
    n = len(scenes)
    amp = torch.tensor([float(s.noise) for s in scenes], dtype=torch.float32,
                       device=device)[:, None, None, None]
    img = torch.rand((n, height, width, 3), generator=gen, device=device) * amp
    k = max(len(s) for s in scenes)
    spec = torch.zeros((n, k, 8))
    for i, objs in enumerate(scenes):
        for j, (cls, cx, cy, w, h, r, g, b) in enumerate(objs):
            spec[i, j] = torch.tensor([1.0, cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, r, g, b])
    spec = spec.to(device)
    xs = (torch.arange(width, device=device) + 0.5) / width
    ys = (torch.arange(height, device=device) + 0.5) / height
    for j in range(k):  # a later object paints over an earlier one
        s = spec[:, j]
        inside = ((xs[None, None, :] >= s[:, 1, None, None]) & (xs[None, None, :] < s[:, 3, None, None])
                  & (ys[None, :, None] >= s[:, 2, None, None]) & (ys[None, :, None] < s[:, 4, None, None])
                  & (s[:, 0, None, None] > 0))
        img = torch.where(inside[..., None], s[:, None, None, 5:8], img)
    return img


def box_mask(scenes, size: int, device) -> torch.Tensor:
    """(n, size, size, 1) float32: 1 inside each scene's first object."""
    xs = (torch.arange(size, device=device) + 0.5) / size
    boxes = torch.tensor([[o[0][1] - o[0][3] / 2, o[0][2] - o[0][4] / 2,
                           o[0][1] + o[0][3] / 2, o[0][2] + o[0][4] / 2] for o in scenes],
                         device=device)
    cols, rows = xs[None, None, :], xs[None, :, None]
    inside = ((cols >= boxes[:, 0, None, None]) & (cols < boxes[:, 2, None, None])
              & (rows >= boxes[:, 1, None, None]) & (rows < boxes[:, 3, None, None]))
    return inside[..., None].float()


def plain_labels(scenes, max_boxes: int = 50) -> np.ndarray:
    """(n, 50, 5) [cls, cx, cy, w, h], zero-padded."""
    out = np.zeros((len(scenes), max_boxes, 5), np.float32)
    for i, objs in enumerate(scenes):
        for j, o in enumerate(objs[:max_boxes]):
            out[i, j] = o[:5]
    return out


def binned_labels(scenes, n_cls: int, max_boxes: int = 50) -> np.ndarray:
    """(n, n_cls, 50, 5): each object in the row of its class, in order."""
    out = np.zeros((len(scenes), n_cls, max_boxes, 5), np.float32)
    fill = np.zeros((len(scenes), n_cls), np.int64)
    for i, objs in enumerate(scenes):
        for o in objs:
            c = int(o[0])
            if fill[i, c] < max_boxes:
                out[i, c, fill[i, c]] = o[:5]
                fill[i, c] += 1
    return out


def neg_keep(labels: np.ndarray, neg_ratio, rng: np.random.Generator) -> np.ndarray:
    """0/1 weight a row (image, class copy): every row with a box, and each
    other row with probability neg_ratio * positives / negatives (the
    authors' `neg_filter`, as the CLI's batch maker samples it)."""
    rows = labels.reshape(labels.shape[0], -1)
    n = rows.shape[0]
    if neg_ratio == "full":
        return np.ones(n, np.float32)
    pos = (np.abs(rows).sum(1) != 0).astype(np.float32)
    npos, nneg = pos.sum(), n - pos.sum()
    if nneg == 0 or float(neg_ratio) * npos / nneg >= 1:
        return np.ones(n, np.float32)
    u = rng.random(n)
    return np.where(pos > 0, 1.0, (u <= float(neg_ratio) * npos / nneg)).astype(np.float32)


def seeded_weights(nets: dict, seed: int, device) -> dict:
    """One parameter dict a net (reference/darknet.py's layout) on
    `device`: conv weights and biases uniform in +-1/sqrt(fan-in), drawn in
    ONE call from the seed's generator and sliced; batch norm at its
    initial state (gamma 1, beta 0, mean 0, variance 1)."""
    sizes = []
    for name, layers in nets.items():
        for l in layers:
            if l.kind == "conv" and not l.dynamic:
                sizes.append(l.c_out * l.c_in * l.size ** 2 + (0 if l.bn else l.c_out))
    flat = torch.rand(sum(sizes), generator=torch_generator(seed, device), device=device) * 2 - 1
    out, pos = {}, 0
    for name, layers in nets.items():
        params = {}
        for l in layers:
            if l.kind != "conv" or l.dynamic:
                continue
            stdv = 1.0 / float(np.sqrt(l.c_in * l.size ** 2))
            n = l.c_out * l.c_in * l.size ** 2
            p = {"w": flat[pos:pos + n].view(l.c_out, l.c_in, l.size, l.size) * stdv}
            pos += n
            if l.bn:
                p.update(gamma=torch.ones(l.c_out, device=device),
                         beta=torch.zeros(l.c_out, device=device),
                         mean=torch.zeros(l.c_out, device=device),
                         var=torch.ones(l.c_out, device=device))
            else:
                p["b"] = flat[pos:pos + l.c_out] * stdv
                pos += l.c_out
            params[l.index] = p
        out[name] = params
    return out
