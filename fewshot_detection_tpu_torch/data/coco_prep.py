"""COCO few-shot data preparation (the reference's coco/process_data.py,
with all cluster paths parameterized).

Own copy of the JAX package's `data/coco_prep.py` (no JAX there either); its
outputs are byte-identical to that module's.

  * gen_valid_lists        — per-novel-split validation image lists capped
                             at 3000 images whose classes are a subset of
                             VOC+novel (process_data.py:34-82)
  * get_bbox_fewlist       — seeded box-budgeted k-shot sampling, images
                             restricted to target-class-only content and
                             <=10 boxes (process_data.py:84-146)
  * get_bbox_fewlist_v2    — the priority-class variant used for full-COCO
                             10/30/50-shot lists: hard classes get a
                             fewest-boxes-first pass before random sampling
                             (process_data.py:148-277)
  * gen_label1c            — per-class labels_1c/<cls>/ label files
                             (process_data.py:317-355)
  * gen_traindict/trainval — class -> image-list dict files
                             (process_data.py:358-411)
"""

from __future__ import annotations

import os
import random
from os import path

import numpy as np

from ..config.settings import load_class_names

# priority classes (COCO ids) that run dry in random sampling
PRIORITY_CLASSES = {10: [[78]], 30: [[24, 26, 30, 31, 34, 35, 38, 42, 44, 70, 78]],
                    50: [[34, 35], [38], [29, 32, 70, 78],
                         [24, 26, 30, 31, 40, 42, 44, 57]]}


def get_labelpath(imgpath: str) -> str:
    from .datasets import get_labpath

    return get_labpath(imgpath.strip())


def _load_boxes(imgpath: str) -> np.ndarray | None:
    labpath = get_labelpath(imgpath)
    if not path.exists(labpath) or not path.getsize(labpath):
        return None
    return np.loadtxt(labpath).reshape(-1, 5)


def load_coco_novels() -> list[list[str]]:
    from ..config.settings import _data_asset

    with open(_data_asset("data/coco_novels.txt")) as f:
        return [l.strip().split(",") for l in f if l.strip()]


def gen_valid_lists(out_dir: str, valid_imgdir: str, cap: int = 3000):
    """One validN.txt per novel split: first `cap` val images whose class
    set is a strict subset of VOC+novel."""
    os.makedirs(out_dir, exist_ok=True)
    classes = list(load_class_names("coco"))
    voc = list(load_class_names("voc"))
    for novel in load_coco_novels():
        validids = {classes.index(n) for n in voc + novel}
        out = []
        for name in sorted(os.listdir(valid_imgdir)):
            p = path.join(valid_imgdir, name)
            bs = _load_boxes(p)
            if bs is None:
                continue
            if set(bs[:, 0].astype(int).tolist()) < validids:
                out.append(p + "\n")
            if len(out) >= cap:
                break
        fname = path.join(out_dir, f"valid{len(novel)}.txt")
        with open(fname, "w") as f:
            f.writelines(out)
        print("wrote", fname, len(out))


def _iter_names(rootdir: str) -> list[str]:
    if os.path.isdir(rootdir):
        return [path.join(rootdir, n) + "\n" for n in sorted(os.listdir(rootdir))]
    with open(rootdir) as f:
        return f.readlines()


def get_bbox_fewlist(rootdir: str, shot: int, tgtclasses: list[str],
                     classes: list[str] | None = None, seed: int | None = None):
    classes = classes or list(load_class_names("coco"))
    names = _iter_names(rootdir)
    rng = random.Random(seed if seed is not None else 2018 + len(tgtclasses) + shot)
    clsids = {classes.index(n) for n in tgtclasses}
    cls_lists: list[list[str]] = [[] for _ in tgtclasses]
    cls_counts = [0] * len(tgtclasses)

    while min(cls_counts) < shot:
        if not names:
            assert min(cls_counts) >= 0.8 * shot, f"No enough data: {cls_counts}"
            break
        imgpath = rng.sample(names, 1)[0]
        names.remove(imgpath)
        bs = _load_boxes(imgpath)
        if bs is None:
            continue
        bcls = bs[:, 0].astype(int).tolist()
        if not set(bcls) <= clsids or len(bcls) > 10:
            continue
        if any(
            cls_counts[tgtclasses.index(classes[ci])] + bcls.count(ci) > shot
            for ci in set(bcls)
        ):
            continue
        for ci in set(bcls):
            ind = tgtclasses.index(classes[ci])
            cls_counts[ind] += bcls.count(ci)
            cls_lists[ind].append(imgpath)
    return cls_lists


def get_bbox_fewlist_v2(rootdir: str, shot: int, tgtclasses: list[str],
                        classes: list[str] | None = None, seed: int = 999):
    """Priority-class variant: rare classes are filled first by scanning
    candidate images fewest-boxes-first (process_data.py:148-277)."""
    classes = classes or list(load_class_names("coco"))
    names = _iter_names(rootdir)
    rng = random.Random(seed)
    priority_cs = PRIORITY_CLASSES.get(shot, [])
    clsids = {classes.index(n) for n in tgtclasses}
    cls_lists: list[list[str]] = [[] for _ in tgtclasses]
    cls_counts = [0] * len(tgtclasses)
    threshold = 10 if shot == 50 else 5

    def is_valid(bcls):
        if bcls is None or not set(bcls) <= clsids or len(bcls) > threshold:
            return False
        return not any(
            cls_counts[tgtclasses.index(classes[ci])] + bcls.count(ci) > shot
            for ci in set(bcls)
        )

    def add_it(imgpath, bcls):
        for ci in set(bcls):
            ind = tgtclasses.index(classes[ci])
            cls_counts[ind] += bcls.count(ci)
            cls_lists[ind].append(imgpath)

    for pcs in priority_cs:
        selected = []
        for imgpath in list(names):
            bs = _load_boxes(imgpath)
            if bs is None:
                continue
            bcls = bs[:, 0].astype(int).tolist()
            if not set(bcls).isdisjoint(set(pcs)):
                selected.append((imgpath, bcls))
        for imgpath, bcls in sorted(selected, key=lambda t: len(t[1])):
            if is_valid(bcls):
                add_it(imgpath, bcls)
            names.remove(imgpath)

    while min(cls_counts) < shot:
        if not names:
            assert min(cls_counts) >= 0.8 * shot, f"No enough data: {cls_counts}"
            break
        imgpath = rng.sample(names, 1)[0]
        names.remove(imgpath)
        bs = _load_boxes(imgpath)
        bcls = bs[:, 0].astype(int).tolist() if bs is not None else None
        if is_valid(bcls):
            add_it(imgpath, bcls)
    return cls_lists


def gen_label1c(img_sources: list[str], classes: list[str] | None = None):
    """Split each image's label file into per-class labels_1c/<cls>/ files.
    img_sources: image paths (or list-file contents)."""
    classes = classes or list(load_class_names("coco"))
    for img in img_sources:
        labpath = get_labelpath(img)
        bs = _load_boxes(img)
        if bs is None:
            continue
        for clsid in set(bs[:, 0].astype(int).tolist()):
            sub = bs[bs[:, 0] == clsid]
            folder = path.join(
                path.dirname(labpath), classes[clsid]
            ).replace("labels", "labels_1c")
            os.makedirs(folder, exist_ok=True)
            with open(path.join(folder, path.basename(labpath)), "w") as f:
                for b in sub:
                    f.write(" ".join(str(a) for a in b) + "\n")


def gen_traindict(trainsource: str, out_dir: str, suffix: str = "train",
                  classes: list[str] | None = None):
    """full_<cls>_<suffix>.txt per class: images containing that class."""
    classes = classes or list(load_class_names("coco"))
    os.makedirs(out_dir, exist_ok=True)
    cls_lists: list[list[str]] = [[] for _ in classes]
    for imgpath in _iter_names(trainsource):
        bs = _load_boxes(imgpath)
        if bs is None:
            continue
        for c in set(bs[:, 0].astype(int).tolist()):
            cls_lists[c].append(imgpath)
    for ci, c in enumerate(classes):
        fname = path.join(out_dir, f"full_{c}_{suffix}.txt")
        with open(fname, "w") as f:
            f.writelines(cls_lists[ci])
        print(f"{c} {fname}")
