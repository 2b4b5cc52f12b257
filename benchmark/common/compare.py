"""The numbers that decide `correct`, and the check of each against its limit.

Training: gaps of norms taken leaf by leaf. For a leaf, the gap is
|program's norm - reference's norm| over the larger of the reference's norm
and the median leaf's (some gradients are all but zero). Sweep: the widest
gap between a result row and the reference's row nearest to it (see
`row_gap`).

A cell's limits live in `benchmark/limits/<cell>.json`, one entry a
number: `{"limit": x, "lower": ..., "upper": ..., "from": "..."}`, the
readings the limit was set between.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import torch


def leaf_norms(tree: dict) -> dict:
    """{leaf name: float32 norm}, all in one transfer."""
    names = sorted(tree)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tree[k].float()) for k in names]).tolist()
    return dict(zip(names, vals))


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> tuple[float, str]:
    """(worst gap, its leaf) over `leaves` (default: every leaf of ref)."""
    leaves = sorted(ref) if leaves is None else sorted(leaves)
    median = statistics.median(ref[k] for k in leaves)
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst or not where:
            worst, where = gap, k
    return worst, where


def median_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The median over `leaves` of the leaf gaps of `worst_leaf_gap`."""
    leaves = sorted(ref) if leaves is None else sorted(leaves)
    median = statistics.median(ref[k] for k in leaves)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in leaves)


def moved_leaves(ref_grad: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is at least `share` of the median
    leaf's: the others move under momentum and decay by rounding alone."""
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= share * median]


def rel_gap(a: float, b: float) -> float:
    gap = abs(a - b) / max(abs(b), 1e-30)
    return gap if math.isfinite(gap) else math.inf


def row_distance(a: torch.Tensor, b: torch.Tensor, size: tuple) -> torch.Tensor:
    """(n, m) distances of rows (prob, x1, y1, x2, y2): the larger of the
    probabilities' gap and of the corners' gaps, each corner's over the
    image's side plus the larger box's extent on that axis (a box past the
    image's edges is judged relative to itself, not to the image)."""
    w, h = size
    wa, wb = (a[:, 3] - a[:, 1]).abs(), (b[:, 3] - b[:, 1]).abs()
    ha, hb = (a[:, 4] - a[:, 2]).abs(), (b[:, 4] - b[:, 2]).abs()
    sx = w + torch.maximum(wa[:, None], wb[None, :])
    sy = h + torch.maximum(ha[:, None], hb[None, :])
    d = (a[:, None, :] - b[None, :, :]).abs()
    return torch.stack([d[..., 0], d[..., 1] / sx, d[..., 3] / sx, d[..., 2] / sy,
                        d[..., 4] / sy], -1).amax(-1)


def row_gap(program: dict, required: dict, allowed: dict, size: tuple) -> float:
    """The widest gap between the program's rows and the reference's.

    Each dict maps (image id, class) to a (n, 5) float64 tensor of rows
    (prob, x1, y1, x2, y2) in pixels of an image of `size` (width,
    height); `row_distance` measures two rows. Every required reference
    row (kept, and whose fate lies `delta` or more from changing) must lie
    near a program row, and every program row near an allowed reference
    row (kept, or one whose fate could change); a row with no counterpart
    reads 1."""
    worst = 0.0

    def nearest(a, b):
        if len(a) == 0:
            return 0.0
        if len(b) == 0:
            return 1.0
        return float(row_distance(a, b, size).amin(1).amax())

    empty = torch.zeros((0, 5), dtype=torch.float64)
    for key in set(program) | set(required) | set(allowed):
        prog = program.get(key, empty)
        worst = max(worst, nearest(required.get(key, empty), prog),
                    nearest(prog, allowed.get(key, empty)))
    return min(worst, 1.0)


def load_limits(root: str, cell: str) -> dict:
    path = os.path.join(root, "benchmark", "limits", f"{cell}.json")
    with open(path) as f:
        return json.load(f)


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: every one under its limit; one that is missing or not
    finite fails."""
    checks, ok = {}, True
    for name, entry in limits.items():
        value, limit = readings.get(name, math.inf), entry["limit"]
        checks[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, checks
