"""Synthetic VOC-like and COCO-like data for the workflows
(`cli/workflow.py`, `cli/workflow_coco.py`).

The port's copy of what the JAX workflows' data stages take from the test
helpers (`make_voc_like` with the "color", "shape" and "huebin" class styles, their
painters, the VOCdevkit writer, and the COCO-layout trees `make_coco_like`
and `make_coco_rich`): the same numpy and `random` draws in the same order,
so one seed gives the same images, labels, per-class lists and devkit. Images are written as 8-bit RGB PNG by `data/png.py` (zlib
and struct, never PIL, which the port does not need); PNG is lossless, so
the pixels are those the reference writes with PIL."""

from __future__ import annotations

import colorsys
import os
import random

import numpy as np

from .png import write_png

VOC = ["aeroplane", "bicycle", "bird", "boat", "bottle",
       "bus", "car", "cat", "chair", "cow", "diningtable",
       "dog", "horse", "motorbike", "person", "pottedplant",
       "sheep", "sofa", "train", "tvmonitor"]
STYLES = ("color", "shape", "huebin")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _shape_mask(shape, u, v):
    """Filled silhouette on box coordinates u, v in [-1, 1]; all five are
    symmetric under a horizontal flip."""
    if shape == 0:  # disk
        return u * u + v * v <= 1.0
    if shape == 1:  # square
        return (np.abs(u) <= 1.0) & (np.abs(v) <= 1.0)
    if shape == 2:  # triangle, apex top-centre
        return (np.abs(v) <= 1.0) & (np.abs(u) <= (v + 1.0) / 2.0)
    if shape == 3:  # plus
        return ((np.abs(u) <= 1 / 3) & (np.abs(v) <= 1.0)) | (
            (np.abs(v) <= 1 / 3) & (np.abs(u) <= 1.0))
    return np.abs(u) + np.abs(v) <= 1.0  # diamond


def paint_object(arr, shape, fill, x1, y1, x2, y2, color):
    """Paint silhouette `shape` (of 5) with fill pattern `fill` (of 4):
    solid, hollow, checkerboard or horizontal stripes."""
    h, w = y2 - y1, x2 - x1
    if h < 2 or w < 2:
        arr[y1:y2, x1:x2] = color
        return
    yy, xx = np.mgrid[0:h, 0:w]
    u = (xx + 0.5) / w * 2.0 - 1.0
    v = (yy + 0.5) / h * 2.0 - 1.0
    m = _shape_mask(shape, u, v)
    if fill == 1:
        m &= ~_shape_mask(shape, u / 0.55, v / 0.55)
    elif fill == 2:
        cell = max(2, min(h, w) // 4)
        m &= ((xx // cell) + (yy // cell)) % 2 == 0
    elif fill == 3:
        band = max(2, h // 5)
        m &= (yy // band) % 2 == 0
    region = arr[y1:y2, x1:x2]
    region[m] = color
    arr[y1:y2, x1:x2] = region


def paint_shape_object(arr, cls, x1, y1, x2, y2, color):
    """Class `cls` as silhouette cls//4 x fill pattern cls%4, one colour."""
    paint_object(arr, cls // 4, cls % 4, x1, y1, x2, y2, color)


def _hue_color(bin5, rng):
    """A colour in hue bin `bin5` of 5 (72 degrees apart: the training HSV
    shift of at most 36 degrees keeps the bin), random high saturation and
    value."""
    hue = bin5 / 5.0 + rng.uniform(-0.02, 0.02)
    r, g, b = colorsys.hsv_to_rgb(hue % 1.0, rng.uniform(0.8, 1.0), rng.uniform(0.7, 1.0))
    return np.array([r * 255, g * 255, b * 255], np.uint8)


def make_voc_like(root, n_images=10, classes_per_image=2, size=(64, 48), seed=0,
                  style="huebin", box_range=(0.1, 0.4)):
    """images/, labels/, labels_1c/, per-class lists, train.txt,
    traindict.txt and a VOCdevkit under `root`; returns their paths.

    style="color": one fixed bright colour per class, a solid rectangle
    (not robust to the training-time HSV augmentation).
    style="shape": class = silhouette x fill pattern in a random bright
    colour per instance. style="huebin": class = hue bin (cls//4) x
    silhouette (cls%4), solid fill."""
    if style not in STYLES:
        raise ValueError(f"style {style!r}: the port paints {STYLES}")
    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    lab_dir = os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    # one colour per class for style="color" (drawn for every style, so the
    # later draws line up)
    cls_colors = (nprng.rand(20, 3) * 155 + 100).astype(np.uint8)

    per_class_imgs = {c: [] for c in range(20)}
    img_paths = []
    lo, hi = box_range
    for i in range(n_images):
        w, h = size
        arr = nprng.randint(0, 60, (h, w, 3), np.uint8)  # dark noise background
        path = os.path.join(img_dir, f"im{i:03d}.png")
        img_paths.append(path)
        rows = []
        # the first box cycles the classes: n_images >= 20 covers them all
        for j in range(rng.randint(1, classes_per_image)):
            cls = (i % 20) if j == 0 else rng.randrange(20)
            cx, cy = rng.uniform(0.25, 0.75), rng.uniform(0.25, 0.75)
            bw, bh = rng.uniform(lo, hi), rng.uniform(lo, hi)
            rows.append((cls, cx, cy, bw, bh))
            per_class_imgs[cls].append((path, (cls, cx, cy, bw, bh)))
            x1 = max(0, int((cx - bw / 2) * w))
            y1 = max(0, int((cy - bh / 2) * h))
            x2 = min(w, int((cx + bw / 2) * w))
            y2 = min(h, int((cy + bh / 2) * h))
            if style == "shape":
                color = (nprng.rand(3) * 135 + 120).astype(np.uint8)
                paint_shape_object(arr, cls, x1, y1, x2, y2, color)
            elif style == "huebin":
                color = _hue_color(cls // 4, rng)
                paint_shape_object(arr, (cls % 4) * 4, x1, y1, x2, y2, color)
            else:
                arr[y1:y2, x1:x2] = cls_colors[cls]
        write_png(path, arr)
        with open(os.path.join(lab_dir, f"im{i:03d}.txt"), "w") as f:
            for r in rows:
                f.write("%d %.6f %.6f %.6f %.6f\n" % r)

    cls_lists = {}
    for cid, items in per_class_imgs.items():
        cname = VOC[cid]
        d = os.path.join(root, "labels_1c", cname)
        os.makedirs(d, exist_ok=True)
        paths = []
        for path, row in items:
            base = os.path.basename(path).replace(".png", ".txt")
            with open(os.path.join(d, base), "a") as f:
                f.write("%d %.6f %.6f %.6f %.6f\n" % row)
            if path not in paths:
                paths.append(path)
        if paths:
            lst = os.path.join(root, f"{cname}_train.txt")
            with open(lst, "w") as f:
                f.write("\n".join(paths) + "\n")
            cls_lists[cname] = lst

    train_list = os.path.join(root, "train.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(img_paths) + "\n")
    traindict = os.path.join(root, "traindict.txt")
    with open(traindict, "w") as f:
        for cname, lst in cls_lists.items():
            f.write(f"{cname} {lst}\n")
    return {
        "root": root,
        "train_list": train_list,
        "traindict": traindict,
        "img_paths": img_paths,
        "cls_lists": cls_lists,
        "devkit": make_devkit(root, img_paths, size),
    }


def make_devkit(root, img_paths, size, classes=None):
    """VOCdevkit/VOC2007 annotations mirroring labels/, and the ImageSets
    lists, so eval/voc_eval.py scores result files on the synthetic set."""
    classes = classes or VOC
    w, h = size
    devkit = os.path.join(root, "VOCdevkit")
    anno = os.path.join(devkit, "VOC2007", "Annotations")
    main = os.path.join(devkit, "VOC2007", "ImageSets", "Main")
    os.makedirs(anno, exist_ok=True)
    os.makedirs(main, exist_ok=True)
    ids = []
    per_class_presence = {c: [] for c in classes}
    for path in img_paths:
        imgid = os.path.basename(path).split(".")[0]
        ids.append(imgid)
        labfile = path.replace("images", "labels").replace(".png", ".txt")
        objs = []
        present = set()
        if os.path.getsize(labfile):
            rows = np.loadtxt(labfile).reshape(-1, 5)
            for cls, cx, cy, bw, bh in rows:
                name = classes[int(cls)]
                present.add(name)
                x1 = max(1, int((cx - bw / 2) * w))
                y1 = max(1, int((cy - bh / 2) * h))
                x2 = min(w, int((cx + bw / 2) * w))
                y2 = min(h, int((cy + bh / 2) * h))
                objs.append(
                    f"<object><name>{name}</name><pose>x</pose>"
                    f"<truncated>0</truncated><difficult>0</difficult>"
                    f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
                    f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
        with open(os.path.join(anno, imgid + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{imgid}</filename>"
                    f"<size><width>{w}</width><height>{h}</height>"
                    f"<depth>3</depth></size>{''.join(objs)}</annotation>")
        for c in classes:
            per_class_presence[c].append((imgid, 1 if c in present else -1))
    for split in ("test", "train", "val"):
        with open(os.path.join(main, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        for c, rows in per_class_presence.items():
            with open(os.path.join(main, f"{c}_{split}.txt"), "w") as f:
                for imgid, flag in rows:
                    f.write(f"{imgid} {flag}\n")
    return devkit


def coco_identity(cls):
    """The 80 COCO classes' visual identities: (hue bin of 5, silhouette of
    5, fill pattern of 4), all distinct. The hue bin survives the training
    HSV shift; shape and texture survive any colour change."""
    return cls % 5, (cls // 5) % 5, (cls // 25) % 4


def paint_coco_object(arr, cls, x1, y1, x2, y2, rng):
    hue_bin, shape, fill = coco_identity(cls)
    paint_object(arr, shape, fill, x1, y1, x2, y2, _hue_color(hue_bin, rng))


def load_coco_names():
    with open(os.path.join(REPO, "data", "coco.names")) as f:
        return [line.strip() for line in f if line.strip()]


def _write_row(path, row, mode="w"):
    with open(path, mode) as f:
        f.write("%d %.6f %.6f %.6f %.6f\n" % row)


def make_coco_like(root, class_ids, size=(64, 48), seed=0, n_train=8):
    """A COCO-layout tree (images/train2014, labels/train2014,
    labels_1c/train2014/<class>/): one image a class id of `class_ids`, a
    solid rectangle of the class's colour on dark noise. Returns the train
    list (the first `n_train` images), a valid list (the first 4) and the
    class -> list dict file."""
    names = load_coco_names()
    nprng = np.random.RandomState(seed)
    rng = random.Random(seed)
    img_dir = os.path.join(root, "images", "train2014")
    lab_dir = os.path.join(root, "labels", "train2014")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    cls_colors = (nprng.rand(len(names), 3) * 155 + 100).astype(np.uint8)

    img_paths = []
    cls_lists = {}
    for i, cid in enumerate(class_ids):
        w, h = size
        arr = nprng.randint(0, 60, (h, w, 3), np.uint8)
        name = f"COCO_train2014_{i:012d}"
        path = os.path.join(img_dir, name + ".png")
        img_paths.append(path)
        cx, cy = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7)
        bw, bh = rng.uniform(0.2, 0.4), rng.uniform(0.2, 0.4)
        x1, y1 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
        x2, y2 = int((cx + bw / 2) * w), int((cy + bh / 2) * h)
        arr[max(0, y1):y2, max(0, x1):x2] = cls_colors[cid]
        write_png(path, arr)
        row = (cid, cx, cy, bw, bh)
        _write_row(os.path.join(lab_dir, name + ".txt"), row)
        cname = names[cid]
        d1c = os.path.join(root, "labels_1c", "train2014", cname)
        os.makedirs(d1c, exist_ok=True)
        _write_row(os.path.join(d1c, name + ".txt"), row)
        lst = os.path.join(root, f"coco_{cname.replace(' ', '_')}_train.txt")
        with open(lst, "a") as f:
            f.write(path + "\n")
        cls_lists[cname] = lst

    train_list = os.path.join(root, "train.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(img_paths[:n_train]) + "\n")
    valid_list = os.path.join(root, "valid.txt")
    with open(valid_list, "w") as f:
        f.write("\n".join(img_paths[:4]) + "\n")
    traindict = os.path.join(root, "traindict.txt")
    with open(traindict, "w") as f:
        for cname, lst in cls_lists.items():
            f.write(f"{cname} {lst}\n")
    return {"root": root, "train_list": train_list, "valid_list": valid_list,
            "traindict": traindict, "img_paths": img_paths}


def make_coco_rich(root, n_images=400, size=(256, 256), seed=0, classes_per_image=2,
                   box_range=(0.18, 0.45)):
    """A trainable COCO-layout tree over the 80-class universe: every class
    painted in its own identity (`coco_identity`), the first box of image i
    of class i % 80, labels and labels_1c/train2014/<class>/ files, per-class
    lists, train.txt, traindict.txt and a VOCdevkit over the COCO names for
    the AP scorer. Returns the paths as `make_voc_like` does, plus names."""
    names = load_coco_names()
    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images", "train2014")
    lab_dir = os.path.join(root, "labels", "train2014")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)

    n_cls = len(names)
    per_class_imgs = {c: [] for c in range(n_cls)}
    img_paths = []
    lo, hi = box_range
    for i in range(n_images):
        w, h = size
        arr = nprng.randint(0, 60, (h, w, 3), np.uint8)
        name = f"COCO_train2014_{i:012d}"
        path = os.path.join(img_dir, name + ".png")
        img_paths.append(path)
        rows = []
        for j in range(rng.randint(1, classes_per_image)):
            cls = (i % n_cls) if j == 0 else rng.randrange(n_cls)
            cx, cy = rng.uniform(0.25, 0.75), rng.uniform(0.25, 0.75)
            bw, bh = rng.uniform(lo, hi), rng.uniform(lo, hi)
            rows.append((cls, cx, cy, bw, bh))
            per_class_imgs[cls].append((path, (cls, cx, cy, bw, bh)))
            x1 = max(0, int((cx - bw / 2) * w))
            y1 = max(0, int((cy - bh / 2) * h))
            x2 = min(w, int((cx + bw / 2) * w))
            y2 = min(h, int((cy + bh / 2) * h))
            paint_coco_object(arr, cls, x1, y1, x2, y2, rng)
        write_png(path, arr)
        with open(os.path.join(lab_dir, name + ".txt"), "w") as f:
            for r in rows:
                f.write("%d %.6f %.6f %.6f %.6f\n" % r)

    cls_lists = {}
    for cid, items in per_class_imgs.items():
        cname = names[cid]
        d1c = os.path.join(root, "labels_1c", "train2014", cname)
        os.makedirs(d1c, exist_ok=True)
        paths = []
        for path, row in items:
            base = os.path.basename(path).replace(".png", ".txt")
            _write_row(os.path.join(d1c, base), row, "a")
            if path not in paths:
                paths.append(path)
        if paths:
            lst = os.path.join(root, f"coco_{cname.replace(' ', '_')}_train.txt")
            with open(lst, "w") as f:
                f.write("\n".join(paths) + "\n")
            cls_lists[cname] = lst

    train_list = os.path.join(root, "train.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(img_paths) + "\n")
    traindict = os.path.join(root, "traindict.txt")
    with open(traindict, "w") as f:
        for cname, lst in cls_lists.items():
            f.write(f"{cname} {lst}\n")
    return {"root": root, "train_list": train_list, "traindict": traindict,
            "img_paths": img_paths, "cls_lists": cls_lists, "names": names,
            "devkit": make_devkit(root, img_paths, size, classes=names)}
