"""Image-list / few-shot-list plumbing.

Own copy of the JAX package's `data/lists.py` (numpy code, no JAX).
Reproduces reference dataset.py:17-169 and utils.py:488-523:
  * dict files map `class list_path` pairs; plain files are one image path
    per line (`is_dict` sniffs the first line)
  * `load_lines` expands dict files, filters to images containing >=1
    base-class box, dedups + sorts
  * `build_dataset` resolves the training list for base training vs tuning
    (meta list x repeat, or dynamically sampled k-shot sets)
  * `build_fewset` randomly samples base-class boxes to a per-class budget,
    skipping images with >3 boxes or any novel-class object
"""

from __future__ import annotations

import os
import random as _random

import numpy as np

from ..config.settings import Settings
from .datasets import get_labpath, topath


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


def load_lines(root: str, settings: Settings, checkvalid: bool = True) -> list[str]:
    """Expand a list or dict file into image paths (dataset.py:20-39)."""
    if is_dict(root):
        lines: list[str] = []
        with open(root, "r") as f:
            pairs = [ln.rstrip().split() for ln in f if ln.strip()]
        universe = settings.base_classes if checkvalid else settings.classes
        files = [p[-1] for p in pairs if p[0] in universe]
        for fname in files:
            with open(topath(fname), "r") as f:
                lines.extend(f.readlines())
        lines = sorted(set(lines))
    else:
        with open(root, "r") as f:
            lines = f.readlines()
    lines = [topath(l) for l in lines]
    if checkvalid:
        lines = [l for l in lines if image_is_valid(l, settings.base_ids)]
    return lines


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


def load_metadict(
    metapath: str, settings: Settings, repeat: int = 1
) -> tuple[list[str], dict[str, int]]:
    """Expand a meta dict into (image list, per-class box counts), keeping
    novel classes only (dataset.py:77-115, sans the stray pdb)."""
    pairs = parse_dict_file(metapath)
    metadict = {cls: load_lines(path, settings) for cls, path in pairs}
    for k in list(metadict):
        if k not in settings.novel_classes:
            metadict[k] = []
    metalist = sorted(set(sum(metadict.values(), [])))

    metacnt = {c: 0 for c in metadict}
    for imgpath in metalist:
        bs = _read_class_boxes(imgpath.strip())
        if bs is None:
            continue
        bcls = bs[:, 0].astype(int).tolist()
        for ci in set(bcls):
            metacnt[settings.classes[ci]] += bcls.count(ci)

    for c in metacnt:
        metacnt[c] *= repeat
    return list(metalist) * repeat, metacnt


def build_fewset(
    imglist: str | list[str],
    metalist: list[str],
    metacnt: dict[str, int],
    shot: int,
    settings: Settings,
    rng: _random.Random | None = None,
    replace: bool = True,
) -> list[str]:
    """Randomly grow `metalist` with base-class images until every class has
    >= `shot` boxes (dataset.py:118-169): skip empty labels, images with >3
    boxes, images containing novel objects, and images that would overflow
    any class budget."""
    rng = rng or _random
    if isinstance(imglist, str):
        with open(imglist) as f:
            names = f.readlines()
    else:
        names = list(imglist)
    metalist = list(metalist)

    stalls = 0
    while min(metacnt.values()) < shot:
        # robustness extension over dataset.py:128 (which loops forever /
        # crashes on an exhausted pool): tiny or skewed pools can run out
        # of usable images — fail with the residual budgets instead
        if not names or stalls > 200_000:
            short = {c: n for c, n in metacnt.items() if n < shot}
            raise RuntimeError(
                f"build_fewset: candidate pool exhausted with classes "
                f"below the {shot}-box budget: {short}"
            )
        stalls += 1
        imgpath = rng.sample(names, 1)[0]
        bs = _read_class_boxes(imgpath.strip())
        if bs is None:
            names.remove(imgpath)
            continue
        bcls = bs[:, 0].astype(int).tolist()
        if bs.shape[0] > 3:
            continue
        if not set(bcls).isdisjoint(set(settings.novel_ids)):
            names.remove(imgpath)
            continue
        overflow = any(
            metacnt[settings.classes[ci]] + bcls.count(ci) > shot
            for ci in set(bcls)
        )
        if overflow:
            names.remove(imgpath)
            continue
        for ci in set(bcls):
            metacnt[settings.classes[ci]] += bcls.count(ci)
        metalist.append(imgpath)
        stalls = 0
        if not replace:
            names.remove(imgpath)

    rng.shuffle(metalist)
    return metalist


def build_dataset(
    data_options: dict, settings: Settings, rng: _random.Random | None = None
) -> list[str]:
    """Resolve the per-epoch training list (dataset.py:61-74)."""
    if not settings.tuning:
        return load_lines(data_options["train"], settings)
    if settings.repeat == 1:
        return load_lines(data_options["meta"], settings)
    if int(data_options.get("dynamic", "0")) == 0:
        return load_lines(data_options["meta"], settings) * settings.repeat
    metalist, metacnt = load_metadict(
        data_options["meta"], settings, settings.repeat
    )
    return build_fewset(
        data_options["train"], metalist, metacnt,
        settings.shot * settings.repeat, settings, rng,
    )
