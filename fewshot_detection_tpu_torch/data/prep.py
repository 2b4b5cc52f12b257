"""Dataset preparation: VOC label conversion + few-shot list generation.

Own copy of the JAX package's `data/prep.py` (no JAX there either); its
outputs are byte-identical to that module's. Reproduces the reference
tooling (file:line in the reference):
  * write_voc_labels     — VOC XML -> darknet `cls cx cy w h` label files +
                           per-(year,set) image lists (scripts/voc_label.py)
  * write_voc_labels_1c  — per-class labels_1c/<cls>/ label dirs + voclist/
                           per-class image lists (scripts/voc_label_1c.py)
  * gen_image_fewlist    — per-class k-shot IMAGE sampling, seeded by class
                           index (scripts/gen_fewlist.py:29-48)
  * gen_bbox_fewlist     — box-budgeted k-shot sampling with <=3 boxes per
                           image, seed 2018 (scripts/gen_fewlist.py:53-103)
  * gen_traindict        — class -> list dict files + .data cfgs
                           (scripts/gen_traindict.py)
  * convert_fewlist      — path rewriting of the frozen data/vocsplit lists
                           (scripts/convert_fewlist.py)

All paths are parameters (the reference hardcoded cluster paths)."""

from __future__ import annotations

import os
import random
import xml.etree.ElementTree as ET
from os import path

import numpy as np

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable",
    "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
]

DEFAULT_SETS = [
    ("2012", "train"), ("2012", "val"),
    ("2007", "train"), ("2007", "val"), ("2007", "test"),
]

FEW_NUMS = [1, 2, 3, 5, 10]


def xyxy_to_darknet(size_wh, xmin, xmax, ymin, ymax):
    w, h = size_wh
    cx = (xmin + xmax) / 2.0 / w
    cy = (ymin + ymax) / 2.0 / h
    bw = (xmax - xmin) / w
    bh = (ymax - ymin) / h
    return cx, cy, bw, bh


def _convert_annotation(xml_path, out_path, keep_class=None, classes=VOC_CLASSES):
    """One XML -> one darknet label file. keep_class: restrict to one class
    and write class id 0 (the labels_1c layout)."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    rows = []
    for obj in root.iter("object"):
        difficult = obj.find("difficult")
        if difficult is not None and int(difficult.text) == 1:
            continue
        cls = obj.find("name").text
        if keep_class is not None:
            if cls != keep_class:
                continue
            cls_id = 0
        else:
            if cls not in classes:
                continue
            cls_id = classes.index(cls)
        bb = obj.find("bndbox")
        box = xyxy_to_darknet(
            (w, h),
            float(bb.find("xmin").text), float(bb.find("xmax").text),
            float(bb.find("ymin").text), float(bb.find("ymax").text),
        )
        rows.append(f"{cls_id} " + " ".join(str(v) for v in box))
    with open(out_path, "w") as f:
        if rows:
            f.write("\n".join(rows) + "\n")


def write_voc_labels(devkit: str, out_root: str | None = None,
                     sets=DEFAULT_SETS, classes=VOC_CLASSES):
    """All-class labels + per-(year,set) image lists. Returns list paths."""
    out_root = out_root or os.getcwd()
    lists = []
    for year, image_set in sets:
        ids_file = path.join(
            devkit, f"VOC{year}", "ImageSets", "Main", f"{image_set}.txt"
        )
        if not os.path.exists(ids_file):
            print(f"WARNING: skipping missing set {year}/{image_set}")
            continue
        lab_dir = path.join(devkit, f"VOC{year}", "labels")
        os.makedirs(lab_dir, exist_ok=True)
        with open(ids_file) as f:
            image_ids = f.read().strip().split()
        list_path = path.join(out_root, f"{year}_{image_set}.txt")
        with open(list_path, "w") as lf:
            for image_id in image_ids:
                lf.write(
                    path.abspath(
                        path.join(devkit, f"VOC{year}", "JPEGImages",
                                  image_id + ".jpg")
                    ) + "\n"
                )
                _convert_annotation(
                    path.join(devkit, f"VOC{year}", "Annotations",
                              image_id + ".xml"),
                    path.join(lab_dir, image_id + ".txt"),
                    classes=classes,
                )
        lists.append(list_path)
    return lists


def write_voc_labels_1c(devkit: str, voclist_dir: str,
                        sets=DEFAULT_SETS, classes=VOC_CLASSES):
    """Per-class labels_1c dirs + voclist/<cls>_train.txt merged lists."""
    os.makedirs(voclist_dir, exist_ok=True)
    for class_name in classes:
        per_set_lists = {}
        for year, image_set in sets:
            ids_file = path.join(
                devkit, f"VOC{year}", "ImageSets", "Main",
                f"{class_name}_{image_set}.txt",
            )
            if not os.path.exists(ids_file):
                continue
            with open(ids_file) as f:
                toks = f.read().strip().split()
            pairs = list(zip(toks[::2], toks[1::2]))
            lab_dir = path.join(devkit, f"VOC{year}", "labels_1c", class_name)
            os.makedirs(lab_dir, exist_ok=True)
            list_path = path.join(
                voclist_dir, f"{year}_{class_name}_{image_set}.txt"
            )
            with open(list_path, "w") as lf:
                for image_id, flag in pairs:
                    if int(flag) == -1:
                        continue
                    lf.write(
                        path.abspath(
                            path.join(devkit, f"VOC{year}", "JPEGImages",
                                      image_id + ".jpg")
                        ) + "\n"
                    )
                    _convert_annotation(
                        path.join(devkit, f"VOC{year}", "Annotations",
                                  image_id + ".xml"),
                        path.join(lab_dir, image_id + ".txt"),
                        keep_class=class_name,
                    )
            per_set_lists[(year, image_set)] = list_path
        # merged train list: 2007 train+val + all 2012 sets (voc_label_1c.py)
        merged = path.join(voclist_dir, f"{class_name}_train.txt")
        with open(merged, "w") as mf:
            for (year, image_set), lp in per_set_lists.items():
                if (year, image_set) == ("2007", "test"):
                    continue
                with open(lp) as f:
                    mf.write(f.read())
    return voclist_dir


def _labpath_1c(imgpath: str, cls_name: str) -> str:
    from .datasets import get_labpath_1c

    return get_labpath_1c(imgpath.strip(), cls_name, "voc")


def gen_image_fewlist(voclist_dir: str, few_nums=FEW_NUMS, classes=VOC_CLASSES):
    """k-shot per-class IMAGE lists: <n>shot_<cls>_train.txt, class-seeded."""
    for i, clsname in enumerate(classes):
        with open(path.join(voclist_dir, f"{clsname}_train.txt")) as f:
            name_list = f.readlines()
        num = max(few_nums)
        rng = random.Random(i)
        selected = []
        while len(selected) < num:
            x = rng.sample(name_list, 1)[0]
            lab = _labpath_1c(x, clsname)
            if not (os.path.exists(lab) and os.path.getsize(lab)):
                continue
            selected.append(x)
        for n in few_nums:
            with open(path.join(voclist_dir, f"{n}shot_{clsname}_train.txt"),
                      "w") as f:
                f.writelines(selected[:n])


def get_bbox_fewlist(rootfile: str, shot: int, classes=VOC_CLASSES, seed=2018):
    """Box-budgeted sampling (gen_fewlist.py:53-88): skip empty labels and
    images with >3 boxes; every class ends with exactly `shot` boxes."""
    with open(rootfile) as f:
        names = f.readlines()
    rng = random.Random(seed)
    cls_lists = [[] for _ in classes]
    cls_counts = [0] * len(classes)
    while min(cls_counts) < shot:
        if not names:  # candidate pool exhausted (tiny datasets)
            print(f"WARNING: candidates exhausted at counts {cls_counts}")
            break
        imgpath = rng.sample(names, 1)[0]
        names.remove(imgpath)
        from .datasets import get_labpath

        labpath = get_labpath(imgpath.strip())
        if not (os.path.exists(labpath) and os.path.getsize(labpath)):
            continue
        bs = np.loadtxt(labpath).reshape(-1, 5)
        if bs.shape[0] > 3:
            continue
        bcls = bs[:, 0].astype(int).tolist()
        if any(cls_counts[ci] + bcls.count(ci) > shot for ci in set(bcls)):
            continue
        for ci in set(bcls):
            cls_counts[ci] += bcls.count(ci)
            cls_lists[ci].append(imgpath)
    return cls_lists


def gen_bbox_fewlist(rootfile: str, voclist_dir: str, few_nums=FEW_NUMS,
                     classes=VOC_CLASSES):
    for n in few_nums:
        filelists = get_bbox_fewlist(rootfile, n, classes)
        for i, clsname in enumerate(classes):
            with open(
                path.join(voclist_dir, f"box_{n}shot_{clsname}_train.txt"), "w"
            ) as f:
                f.writelines(filelists[i])


def gen_traindict(voclist_dir: str, out_data_dir: str, out_cfg_dir: str,
                  novel_classes=("bird", "bus", "cow", "motorbike", "sofa"),
                  few_nums=FEW_NUMS, classes=VOC_CLASSES, gpus="0,1,2,3"):
    """class->list dict files + learnet .data cfgs (gen_traindict.py)."""
    n_novel = len(novel_classes)
    os.makedirs(out_data_dir, exist_ok=True)
    os.makedirs(out_cfg_dir, exist_ok=True)
    for typ in ("mix", "few"):
        for n in few_nums:
            fname = f"voc_traindict_{typ}{n_novel}c_{n}shot.txt"
            with open(path.join(out_data_dir, fname), "w") as f:
                for cls_name in classes:
                    if typ == "mix" and cls_name not in novel_classes:
                        f.write(
                            f"{cls_name} {voclist_dir}/{cls_name}_train.txt\n"
                        )
                    else:
                        f.write(
                            f"{cls_name} {voclist_dir}/{n}shot_{cls_name}_train.txt\n"
                        )
            datacfg = f"voc_learnet_{typ}{n_novel}c_{n}shot.data"
            with open(path.join(out_cfg_dir, datacfg), "w") as f:
                f.write(f"meta = data/{fname}\n")
                f.write(f"train = data/{fname}\n")
                f.write("valid = data/voc_testdict_full.txt\n")
                f.write(f"backup = backup/meta_{typ}{n_novel}c_{n}shot\n")
                f.write(f"gpus = {gpus}")


def convert_fewlist(droot: str, src_folder: str = "data/vocsplit",
                    old_root: str = "/scratch/bykang/datasets"):
    """Rewrite the frozen k-shot lists' image roots to a local path and
    install them under <droot>/voclist (convert_fewlist.py)."""
    droot = droot.rstrip("/")
    tgt = path.join(droot, "voclist")
    os.makedirs(tgt, exist_ok=True)
    for name_list in sorted(os.listdir(src_folder)):
        with open(path.join(src_folder, name_list)) as f:
            names = f.readlines()
        names = [n.replace(old_root, droot) for n in names]
        with open(path.join(tgt, name_list), "w") as f:
            f.writelines(names)

    for fname in ["voc_traindict_full.txt"] + [
        f"voc_traindict_bbox_{n}shot.txt" for n in FEW_NUMS
    ]:
        full = path.join("data", fname)
        if not os.path.exists(full):
            continue
        with open(full) as f:
            lines = f.readlines()
        lines = [l.replace(old_root, droot).replace("/home/bykang/voc", droot)
                 for l in lines]
        with open(full, "w") as f:
            f.writelines(lines)
