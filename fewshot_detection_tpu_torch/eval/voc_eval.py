"""PASCAL VOC detection mAP (python3).

Protocol identical to the reference scorer (the reference's scripts/
voc_eval.py, the standard Fast/er-R-CNN evaluator): XML annotation parse
with a pickle cache, greedy TP/FP matching at IoU>=ovthresh with
difficult-box exclusion and duplicate-detection penalties, VOC07 11-point
AP for year<2010, and the base/novel mean split keyed by the novelid parsed
from the results directory name.

Differences from the reference are operational only: the VOCdevkit path is
a parameter / $VOC_DEVKIT (it was hardcoded to a cluster path), and output
is plain text (no termcolor)."""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable",
    "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)


def parse_rec(filename: str) -> list[dict]:
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        objects.append(
            {
                "name": obj.find("name").text,
                "difficult": int(obj.find("difficult").text)
                if obj.find("difficult") is not None
                else 0,
                "bbox": [
                    int(float(bbox.find("xmin").text)),
                    int(float(bbox.find("ymin").text)),
                    int(float(bbox.find("xmax").text)),
                    int(float(bbox.find("ymax").text)),
                ],
            }
        )
    return objects


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _load_annotations(annopath: str, imagenames: list[str], cachedir: str) -> dict:
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, "annots.pkl")
    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            return pickle.load(f)
    recs = {name: parse_rec(annopath.format(name)) for name in imagenames}
    with open(cachefile, "wb") as f:
        pickle.dump(recs, f)
    return recs


def voc_eval(
    detpath: str,
    annopath: str,
    imagesetfile: str,
    classname: str,
    cachedir: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
    single_class_images: str | None = None,
):
    """(recall, precision, ap) for one class.

    detpath.format(classname) -> detection file, rows
    `imgid conf x1 y1 x2 y2`. `single_class_images` optionally restricts
    detections to images listed positive in a `<class>_test.txt` file
    (the reference's --single filter)."""
    with open(imagesetfile) as f:
        imagenames = [x.strip() for x in f]
    recs = _load_annotations(annopath, imagenames, cachedir)

    class_recs = {}
    npos = 0
    for name in imagenames:
        objs = [o for o in recs[name] if o["name"] == classname]
        bbox = np.array([o["bbox"] for o in objs])
        difficult = np.array([o["difficult"] for o in objs]).astype(bool)
        npos += int((~difficult).sum())
        class_recs[name] = {
            "bbox": bbox,
            "difficult": difficult,
            "det": [False] * len(objs),
        }

    with open(detpath.format(classname)) as f:
        splitlines = [x.strip().split(" ") for x in f if x.strip()]
    if single_class_images:
        with open(single_class_images) as f:
            pos_ids = {
                l.split()[0] for l in f if len(l.split()) > 1 and l.split()[1] == "1"
            }
        splitlines = [d for d in splitlines if d[0] in pos_ids]

    image_ids = [x[0] for x in splitlines]
    confidence = np.array([float(x[1]) for x in splitlines])
    BB = np.array([[float(z) for z in x[2:]] for x in splitlines])

    order = np.argsort(-confidence)
    BB = BB[order] if len(BB) else BB
    image_ids = [image_ids[i] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d].astype(float)
        ovmax, jmax = -np.inf, -1
        BBGT = R["bbox"].astype(float)
        if BBGT.size > 0:
            ixmin = np.maximum(BBGT[:, 0], bb[0])
            iymin = np.maximum(BBGT[:, 1], bb[1])
            ixmax = np.minimum(BBGT[:, 2], bb[2])
            iymax = np.minimum(BBGT[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (BBGT[:, 2] - BBGT[:, 0] + 1.0) * (BBGT[:, 3] - BBGT[:, 1] + 1.0)
                - inters
            )
            overlaps = inters / uni
            ovmax = float(np.max(overlaps))
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not R["difficult"][jmax]:
                if not R["det"][jmax]:
                    tp[d] = 1.0
                    R["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _novelid_from_prefix(res_prefix: str) -> str | None:
    parts = res_prefix.split("/")
    if len(parts) < 3:
        return None
    for s in parts[-3].split("_"):
        if "novel" in s:
            return s.replace("novel", "")
    return None


def do_python_eval(
    res_prefix: str,
    devkit_path: str | None = None,
    year: str = "2007",
    novel: bool = True,
    novel_file: str = "data/voc_novels.txt",
    novelid: str | None = None,
    output_dir: str = "output",
    single: bool = False,
    classes: tuple[str, ...] | None = None,
) -> dict:
    """Per-class AP + mean + base/novel means. Returns a result dict (the
    reference only printed). `classes` defaults to the VOC 20; pass the
    COCO names (+ novel_file=data/coco_novels.txt) to score a COCO-protocol
    result dir — the AP math is class-universe agnostic (the reference's
    scorer was VOC-only, scripts/voc_eval.py:246-331)."""
    from ..config.settings import get_novels

    classes = tuple(classes) if classes is not None else VOC_CLASSES

    devkit_path = devkit_path or os.environ.get("VOC_DEVKIT", "VOCdevkit")
    if novelid is None:
        novelid = _novelid_from_prefix(res_prefix)
    novel_classes = get_novels(novel_file, novelid) if novelid is not None else ()

    filename = res_prefix + "{:s}.txt"
    annopath = os.path.join(devkit_path, "VOC" + year, "Annotations", "{:s}.xml")
    imagesetfile = os.path.join(
        devkit_path, "VOC" + year, "ImageSets", "Main", "test.txt"
    )
    cachedir = os.path.join(devkit_path, "annotations_cache")
    use_07 = int(year) < 2010
    print("VOC07 metric? " + ("Yes" if use_07 else "No"))
    os.makedirs(output_dir, exist_ok=True)

    aps, base_aps, novel_aps = [], [], []
    per_class = {}
    for cls in classes:
        single_file = (
            os.path.join(os.path.dirname(imagesetfile), f"{cls}_test.txt")
            if single
            else None
        )
        rec, prec, ap = voc_eval(
            filename, annopath, imagesetfile, cls, cachedir,
            ovthresh=0.5, use_07_metric=use_07,
            single_class_images=single_file,
        )
        aps.append(ap)
        per_class[cls] = ap
        if novel and cls in novel_classes:
            novel_aps.append(ap)
        else:
            base_aps.append(ap)
        print(f"AP for {cls} = {ap:.4f}")
        with open(os.path.join(output_dir, cls + "_pr.pkl"), "wb") as f:
            pickle.dump({"rec": rec, "prec": prec, "ap": ap}, f)

    print("~~~~~~~~")
    print(f"Mean AP = {np.mean(aps):.4f}")
    result = {"ap": per_class, "mean": float(np.mean(aps))}
    if novel:
        result["base_mean"] = float(np.mean(base_aps)) if base_aps else 0.0
        result["novel_mean"] = float(np.mean(novel_aps)) if novel_aps else 0.0
        print(f"Mean Base AP = {result['base_mean']:.4f}")
        print(f"Mean Novel AP = {result['novel_mean']:.4f}")
    print("~~~~~~~~")
    row = ("{:.2f}\t" * len(aps)).format(*(np.asarray(aps) * 100).tolist())
    if novel:
        row += ("{:.2f}\t" * 3).format(
            np.mean(aps) * 100, result["base_mean"] * 100, result["novel_mean"] * 100
        )
    print(row)
    return result
