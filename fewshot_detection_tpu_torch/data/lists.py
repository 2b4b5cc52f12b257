"""Image-list plumbing for the eval-mode datasets.

Reproduces reference dataset.py:17-59 and utils.py:488-523 as far as the
sweeps need it: dict files map `class list_path` pairs; plain files are one
image path per line (`is_dict` sniffs the first line).
"""

from __future__ import annotations

import os

import numpy as np

from .datasets import get_labpath


def is_dict(filename: str) -> bool:
    with open(filename, "r") as f:
        first = f.readline().strip().split()
    return len(first) == 2


def _read_class_boxes(imgpath: str) -> np.ndarray | None:
    labpath = get_labpath(imgpath.rstrip())
    if not os.path.exists(labpath) or not os.path.getsize(labpath):
        return None
    bs = np.loadtxt(labpath)
    if bs is None or bs.size == 0:
        return None
    return np.reshape(bs, (-1, 5))


def image_is_valid(imgpath: str, base_ids: tuple[int, ...]) -> bool:
    """True iff the image has at least one base-class box (dataset.py:273-283)."""
    bs = _read_class_boxes(imgpath)
    if bs is None:
        return False
    return not set(bs[:, 0].astype(int).tolist()).isdisjoint(set(base_ids))


def parse_dict_file(path: str) -> list[tuple[str, str]]:
    """`class listfile` pairs. COCO class names (and the reference's list
    paths) may contain spaces (dataset.py:316-324 handled exactly 2- and
    4-token rows); here the path is taken to start at the first token
    containing a '/', which covers both layouts and one-word paths too."""
    pairs = []
    with open(path, "r") as f:
        for line in f:
            toks = line.rstrip().split()
            if not toks:
                continue
            if len(toks) == 2:
                pairs.append((toks[0], toks[1]))
                continue
            split_at = next(
                (i for i, t in enumerate(toks) if i > 0 and "/" in t), None
            )
            if split_at is None:
                raise ValueError(f"unrecognized dict row: {toks}")
            pairs.append((" ".join(toks[:split_at]), " ".join(toks[split_at:])))
    return pairs
