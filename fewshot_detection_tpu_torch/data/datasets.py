"""Detection + support (meta) datasets, eval mode.

Pure-python samplers feeding the sweeps; no torch DataLoader. Reference
behavior being reproduced (file:line in the reference):
  * listDataset — label-path derivation (dataset.py:265-271), plain resize
    to the network size when not training
  * MetaDataset in ensemble mode — every support image of every class
    enumerated once, 4-channel (RGB+mask) input synthesis from one labeled
    box (dataset.py:378-403), images whose boxes give an empty mask dropped
    (dataset.py:447-457), per-class labels_1c paths (dataset.py:472-488)

Training mode (augmentation, the multi-scale schedule, random support
sampling) is not part of this module yet. PIL is imported where an image
file is opened.
"""

from __future__ import annotations

import os
import random as _random

import numpy as np

from ..config.settings import MAX_BOXES, Settings
from ..utils.imaging import get_image_size


def topath(p: str) -> str:
    """Dataset-root remapping hook (the reference hardcoded a cluster
    rewrite, dataset.py:17-18). Configure with FSD_PATH_MAP="old=new[,o=n]".
    """
    spec = os.environ.get("FSD_PATH_MAP", "")
    for rule in spec.split(","):
        if "=" in rule:
            old, new = rule.split("=", 1)
            p = p.replace(old, new)
    return p


def get_labpath(imgpath: str) -> str:
    return (
        imgpath.replace("images", "labels")
        .replace("JPEGImages", "labels")
        .replace(".jpg", ".txt")
        .replace(".png", ".txt")
    )


def get_labpath_1c(imgpath: str, cls_name: str, data: str = "voc") -> str:
    """Per-class label path under labels_1c/<class>/ (dataset.py:472-488)."""
    if data == "voc":
        return (
            imgpath.replace("images", f"labels_1c/{cls_name}")
            .replace("JPEGImages", f"labels_1c/{cls_name}")
            .replace(".jpg", ".txt")
            .replace(".png", ".txt")
        )
    if "train2014" in imgpath:
        return imgpath.replace(
            "images/train2014", f"labels_1c/train2014/{cls_name}"
        ).replace(".jpg", ".txt").replace(".png", ".txt")
    if "val2014" in imgpath:
        return imgpath.replace(
            "images/val2014", f"labels_1c/val2014/{cls_name}"
        ).replace(".jpg", ".txt").replace(".png", ".txt")
    raise ValueError(f"cannot derive labels_1c path for {imgpath!r}")


# ---------------------------------------------------------------------------
# label transforms (reference image.py:90-231), identity crop in eval mode
# ---------------------------------------------------------------------------


def _clamp_box(row):
    """Corner clamp to [0, 0.999] and recompose one [cls, cx, cy, w, h] row;
    None when degenerate (< 0.001 wide or high)."""
    cls_id, cx, cy, w, h = row
    x1 = min(0.999, max(0, cx - w / 2))
    y1 = min(0.999, max(0, cy - h / 2))
    x2 = min(0.999, max(0, cx + w / 2))
    y2 = min(0.999, max(0, cy + h / 2))
    w = x2 - x1
    h = y2 - y1
    if w < 0.001 or h < 0.001:
        return None
    return [cls_id, (x1 + x2) / 2, (y1 + y2) / 2, w, h]


def _read_label_file(labpath: str) -> np.ndarray:
    if not os.path.exists(labpath) or not os.path.getsize(labpath):
        return np.zeros((0, 5))
    bs = np.loadtxt(labpath)
    if bs is None or bs.size == 0:
        return np.zeros((0, 5))
    return np.reshape(bs, (-1, 5))


def fill_truth_detection(labpath: str, base_ids: tuple[int, ...]) -> np.ndarray:
    """(50*5,) flat label; boxes outside the base classes are dropped."""
    label = np.zeros((MAX_BOXES, 5), np.float32)
    cc = 0
    base = set(base_ids)
    for row in _read_label_file(labpath):
        if int(row[0]) not in base:
            continue
        out = _clamp_box(row)
        if out is None:
            continue
        label[cc] = out
        cc += 1
        if cc >= MAX_BOXES:
            break
    return label.reshape(-1)


def fill_truth_detection_meta(labpath: str, base_ids: tuple[int, ...]) -> np.ndarray:
    """(n_cls, 50*5) labels binned per base class; the class field holds the
    POSITION in the base list (image.py:182-187)."""
    n_cls = len(base_ids)
    label = np.zeros((n_cls, MAX_BOXES, 5), np.float32)
    ccs = [0] * n_cls
    pos = {cid: i for i, cid in enumerate(base_ids)}
    for row in _read_label_file(labpath):
        clsid = int(row[0])
        if clsid not in pos:
            continue
        out = _clamp_box(row)
        if out is None:
            continue
        ind = pos[clsid]
        if ccs[ind] >= MAX_BOXES:
            continue
        out[0] = ind
        label[ind][ccs[ind]] = out
        ccs[ind] += 1
        if sum(ccs) >= MAX_BOXES:
            break
    return label.reshape(n_cls, -1)


def load_label_boxes(labpath: str) -> list[np.ndarray]:
    """[cx, cy, w, h] rows for support images (image.py:195-231); no class
    filtering (the file is already per-class)."""
    out = []
    for row in _read_label_file(labpath):
        r = _clamp_box(row)
        if r is None:
            continue
        out.append(np.asarray(r[1:], np.float32))
        if len(out) >= MAX_BOXES:
            break
    return out


def _open_resized(imgpath: str, shape: tuple[int, int]):
    from PIL import Image

    return Image.open(imgpath).convert("RGB").resize(shape)


def image_to_array(img) -> np.ndarray:
    """PIL RGB -> float32 HWC in [0, 1]."""
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0


class DetectionDataset:
    """Detection-image sampler (listDataset equivalent), eval mode.

    Yields (image HWC float32 [0,1], label) where label is (50*5,) flat for
    plain nets or (n_cls, 50*5) for the meta detector.
    """

    def __init__(
        self,
        lines: list[str] | str,
        settings: Settings,
        *,
        shape: tuple[int, int] | None = None,
        shuffle: bool = True,
        train: bool = False,
        filter_valid: bool | None = None,
        rng: _random.Random | None = None,
    ):
        from .lists import image_is_valid, is_dict

        if train:
            raise NotImplementedError("the training-mode dataset is not ported yet")
        self.settings = settings
        self.rng = rng or _random.Random()
        if isinstance(lines, str):
            if is_dict(lines):
                rows: list[str] = []
                with open(lines) as f:
                    files = [ln.rstrip().split()[-1] for ln in f if ln.strip()]
                for fname in files:
                    with open(topath(fname)) as f:
                        rows.extend(f.readlines())
                lines = sorted(set(rows))
            else:
                with open(lines) as f:
                    lines = f.readlines()
            # remap only at the raw-read boundary: python lists arriving
            # here are already remapped
            lines = [topath(l) for l in lines]
        self.lines = [l.rstrip() for l in lines if l.strip()]
        if filter_valid:
            self.lines = [
                l for l in self.lines if image_is_valid(l, settings.base_ids)
            ]
        if shuffle:
            self.rng.shuffle(self.lines)
        self.train = False
        self.shape = shape or (settings.width, settings.height)

    def __len__(self) -> int:
        return len(self.lines)

    def image_size(self, index: int) -> tuple[int, int]:
        """(width, height) of the original image behind `lines[index]`."""
        return get_image_size(self.lines[index])

    def __getitem__(self, index: int):
        s = self.settings
        imgpath = self.lines[index]
        arr = image_to_array(_open_resized(imgpath, self.shape))
        labpath = get_labpath(imgpath)
        if s.metayolo:
            label = fill_truth_detection_meta(labpath, s.base_ids)
        else:
            label = fill_truth_detection(labpath, s.base_ids)
        return arr, label

    def batches(self, batch_size: int, drop_last: bool = True):
        """Yield stacked (images (B,H,W,3), labels) numpy batches."""
        n = len(self.lines)
        end = n - (n % batch_size) if drop_last else n
        for start in range(0, end, batch_size):
            items = [self[i] for i in range(start, min(start + batch_size, n))]
            yield np.stack([im for im, _ in items]), np.stack([lb for _, lb in items])


class MetaDataset:
    """Per-class support sampler, ensemble mode: enumerates ALL support
    images once, dropping images whose boxes give empty masks.
    """

    def __init__(
        self,
        metafiles: str,
        settings: Settings,
        *,
        train: bool = False,
        ensemble: bool = False,
        with_ids: bool = False,
    ):
        from .lists import parse_dict_file

        if train or not ensemble:
            raise NotImplementedError(
                "only MetaDataset(train=False, ensemble=True) is ported yet"
            )
        self.settings = settings
        s = settings
        self.classes = s.base_classes if s.data == "coco" else s.classes

        files = dict(parse_dict_file(metafiles))
        self.metalines: list[list[str]] = []
        self.inds: list[tuple[int, int]] = []
        for i, cls in enumerate(self.classes):
            with open(topath(files[cls])) as f:
                lines = [topath(l.rstrip()) for l in f if l.strip()]
            self.metalines.append(lines)
            self.inds.extend((i, j) for j in range(len(lines)))
        self.meta_cnts = [len(l) for l in self.metalines]

        self.train = False
        self.ensemble = True
        self.with_ids = with_ids
        self.meta_shape = (s.meta_width, s.meta_height)
        self.mask_shape = (s.mask_width, s.mask_height)

    # -- internals ---------------------------------------------------------

    def _box_pixels(self, box: np.ndarray) -> tuple[int, int, int, int]:
        w, h = self.mask_shape
        x1 = int(max(0, round((box[0] - box[2] / 2) * w)))
        y1 = int(max(0, round((box[1] - box[3] / 2) * h)))
        x2 = int(min(w, round((box[0] + box[2] / 2) * w)))
        y2 = int(min(h, round((box[1] + box[3] / 2) * h)))
        return x1, y1, x2, y2

    def _make_mask(self, box: np.ndarray) -> np.ndarray | None:
        """Binary object mask (H, W, 1) from one normalized box
        (dataset.py:378-398); None when it rounds to empty."""
        w, h = self.mask_shape
        x1, y1, x2, y2 = self._box_pixels(box)
        if x1 == x2 or y1 == y2:
            return None
        mask = np.zeros((h, w, 1), np.float32)
        mask[y1:y2, x1:x2, :] = 1.0
        return mask

    def _compose_input(self, img, box: np.ndarray):
        """(image array, mask) per metain_type; type 3/4 appends the cropped
        object resized to full size (dataset.py:386-391)."""
        mask = self._make_mask(box)
        if mask is None:
            return None, None
        arr = image_to_array(img)
        if self.settings.metain_type in (3, 4):
            croped = img.crop(self._box_pixels(box)).resize(img.size)
            arr = np.concatenate([arr, image_to_array(croped)], axis=-1)
        return arr, mask

    def _get(self, clsid: int, metaind: int):
        imgpath = self.metalines[clsid][metaind].rstrip()
        labpath = get_labpath_1c(imgpath, self.classes[clsid], self.settings.data)
        img = _open_resized(imgpath, self.meta_shape)
        for box in load_label_boxes(labpath):
            arr, mask = self._compose_input(img, box)
            if arr is not None:
                return arr, mask
        return None, None

    # -- public ------------------------------------------------------------

    def batches(self, batch_size: int):
        """Yield stacked (metax (B,H,W,C), mask (B,h,w,1)[, clsids]); each
        image is decoded once and its validity decided as it is loaded."""
        chunk = []
        for clsid, metaind in self.inds:
            arr, mask = self._get(clsid, metaind)
            if arr is None:
                continue
            chunk.append((arr, mask, clsid))
            if len(chunk) == batch_size:
                yield self._stack(chunk)
                chunk = []
        if chunk:
            yield self._stack(chunk)

    def _stack(self, chunk):
        arrs = np.stack([c[0] for c in chunk])
        masks = np.stack([c[1] for c in chunk])
        if self.with_ids:
            return arrs, masks, np.asarray([c[2] for c in chunk])
        return arrs, masks
