"""Image augmentation + label transforms for detection episodes.

Own copy of the JAX package's `data/augment.py` (numpy/PIL code, no JAX).
Reproduces the semantics of the reference's image.py:
  * crop-jitter (±jitter of each edge, independent), resize, horizontal
    flip, HSV distortion (hue shift with single wraparound, multiplicative
    saturation/exposure with 50% inversion) — image.py:19-87
  * box transform: corner clamp to [0, 0.999], recompose, flip as
    cx -> 0.999 - cx, degenerate (<0.001) drop — image.py:90-141
  * per-base-class binning into a (n_cls, 50, 5) label tensor with the class
    field remapped to the base-list position — image.py:144-192

PIL is used for decode/resize/HSV so the lookup-table quantization matches
the original pipeline bit-for-bit. Randomness is explicit: every function
takes a `random.Random` so episodes are reproducible and worker-shardable.
PIL is imported inside the functions that need it.
"""

from __future__ import annotations

import dataclasses
import os
import random as _random

import numpy as np

from ..config.settings import MAX_BOXES


def _rand_scale(rng: _random.Random, s: float) -> float:
    scale = rng.uniform(1, s)
    if rng.randint(1, 10000) % 2:
        return scale
    return 1.0 / scale


def distort_hsv(img, hue: float, sat: float, val: float):
    """Apply fixed HSV distortion via PIL point tables (image.py:19-37)."""
    from PIL import Image

    hsv = img.convert("HSV")
    h, s, v = hsv.split()
    s = s.point(lambda i: i * sat)
    v = v.point(lambda i: i * val)

    dh = hue * 255

    def shift_hue(x):
        x += dh
        if x > 255:
            x -= 255
        if x < 0:
            x += 255
        return x

    h = h.point(shift_hue)
    return Image.merge("HSV", (h, s, v)).convert("RGB")


def random_distort_hsv(
    img, rng: _random.Random, hue: float, saturation: float, exposure: float
):
    dhue = rng.uniform(-hue, hue)
    dsat = _rand_scale(rng, saturation)
    dexp = _rand_scale(rng, exposure)
    return distort_hsv(img, dhue, dsat, dexp)


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    """One sampled augmentation: crop paddings, flip, HSV factors, and the
    derived label-transform coefficients."""

    pleft: int = 0
    pright: int = 0
    ptop: int = 0
    pbot: int = 0
    flip: int = 0
    dhue: float = 0.0
    dsat: float = 1.0
    dexp: float = 1.0
    dx: float = 0.0
    dy: float = 0.0
    sx: float = 1.0
    sy: float = 1.0


def sample_augment_params(
    ow: int,
    oh: int,
    rng: _random.Random,
    *,
    jitter: float = 0.2,
    hue: float = 0.1,
    saturation: float = 1.5,
    exposure: float = 1.5,
) -> AugmentParams:
    """Sample all augmentation randomness in the reference's draw order
    (image.py:52-87 then 45-50) so PIL and native paths share one stream."""
    dw = int(ow * jitter)
    dh = int(oh * jitter)
    pleft = rng.randint(-dw, dw)
    pright = rng.randint(-dw, dw)
    ptop = rng.randint(-dh, dh)
    pbot = rng.randint(-dh, dh)
    flip = rng.randint(1, 10000) % 2
    dhue = rng.uniform(-hue, hue)
    dsat = _rand_scale(rng, saturation)
    dexp = _rand_scale(rng, exposure)

    swidth = ow - pleft - pright
    sheight = oh - ptop - pbot
    sx = swidth / ow
    sy = sheight / oh
    return AugmentParams(
        pleft, pright, ptop, pbot, flip, dhue, dsat, dexp,
        (pleft / ow) / sx, (ptop / oh) / sy, sx, sy,
    )


def apply_augment_pil(img, shape: tuple[int, int], p: AugmentParams):
    """PIL application of sampled params (the bit-parity path)."""
    from PIL import Image

    ow, oh = img.width, img.height
    swidth = ow - p.pleft - p.pright
    sheight = oh - p.ptop - p.pbot
    # the reference crops to (swidth-1, sheight-1) — preserved quirk
    cropped = img.crop((p.pleft, p.ptop, p.pleft + swidth - 1,
                        p.ptop + sheight - 1))
    sized = cropped.resize(shape)
    if p.flip:
        sized = sized.transpose(Image.FLIP_LEFT_RIGHT)
    return distort_hsv(sized, p.dhue, p.dsat, p.dexp)


def augment_image(
    img,
    shape: tuple[int, int],
    rng: _random.Random | None = None,
    *,
    jitter: float = 0.2,
    hue: float = 0.1,
    saturation: float = 1.5,
    exposure: float = 1.5,
    augment: bool = True,
) -> tuple[object, int, float, float, float, float]:
    """Returns (image, flip, dx, dy, sx, sy) — image.py:52-87 contract.
    The caller passes 1/sx, 1/sy to the label transforms (image.py:240-244).
    """
    if not augment:
        return img.resize(shape), 0, 0.0, 0.0, 1.0, 1.0
    rng = rng or _random
    p = sample_augment_params(
        img.width, img.height, rng,
        jitter=jitter, hue=hue, saturation=saturation, exposure=exposure,
    )
    out = apply_augment_pil(img, shape, p)
    return out, p.flip, p.dx, p.dy, p.sx, p.sy


def _transform_box(row, flip, dx, dy, sx, sy):
    """Apply the crop/flip transform to one [cls, cx, cy, w, h] row; returns
    the new row or None when degenerate. NOTE: sx/sy here are the caller's
    1/sx, 1/sy values (fill_truth receives them pre-inverted)."""
    cls_id, cx, cy, w, h = row
    x1 = cx - w / 2
    y1 = cy - h / 2
    x2 = cx + w / 2
    y2 = cy + h / 2

    x1 = min(0.999, max(0, x1 * sx - dx))
    y1 = min(0.999, max(0, y1 * sy - dy))
    x2 = min(0.999, max(0, x2 * sx - dx))
    y2 = min(0.999, max(0, y2 * sy - dy))

    cx = (x1 + x2) / 2
    cy = (y1 + y2) / 2
    w = x2 - x1
    h = y2 - y1
    if flip:
        cx = 0.999 - cx
    if w < 0.001 or h < 0.001:
        return None
    return [cls_id, cx, cy, w, h]


def _read_label_file(labpath: str) -> np.ndarray:
    if not os.path.exists(labpath) or not os.path.getsize(labpath):
        return np.zeros((0, 5))
    bs = np.loadtxt(labpath)
    if bs is None or bs.size == 0:
        return np.zeros((0, 5))
    return np.reshape(bs, (-1, 5))


def fill_truth_detection(
    labpath: str,
    flip: int,
    dx: float,
    dy: float,
    sx: float,
    sy: float,
    base_ids: tuple[int, ...],
    joint_keep: bool = False,
) -> np.ndarray:
    """(50*5,) flat label for plain training; boxes outside base classes are
    dropped unless `joint_keep` (the image is in the yolo_joint few-shot id
    set — image.py:104-112, resolved per-image by the caller)."""
    label = np.zeros((MAX_BOXES, 5), np.float32)
    bs = _read_label_file(labpath)
    cc = 0
    base = set(base_ids)
    for row in bs:
        clsid = int(row[0])
        if clsid not in base and not joint_keep:
            continue
        out = _transform_box(row, flip, dx, dy, sx, sy)
        if out is None:
            continue
        label[cc] = out
        cc += 1
        if cc >= MAX_BOXES:
            break
    return label.reshape(-1)


def fill_truth_detection_meta(
    labpath: str,
    flip: int,
    dx: float,
    dy: float,
    sx: float,
    sy: float,
    base_ids: tuple[int, ...],
) -> np.ndarray:
    """(n_cls, 50*5) labels binned per base class; the class field holds the
    POSITION in the base list (image.py:182-187)."""
    n_cls = len(base_ids)
    label = np.zeros((n_cls, MAX_BOXES, 5), np.float32)
    ccs = [0] * n_cls
    bs = _read_label_file(labpath)
    pos = {cid: i for i, cid in enumerate(base_ids)}
    for row in bs:
        clsid = int(row[0])
        if clsid not in pos:
            continue
        out = _transform_box(row, flip, dx, dy, sx, sy)
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


def load_label_boxes(
    labpath: str, flip: int, dx: float, dy: float, sx: float, sy: float
) -> list[np.ndarray]:
    """Transformed [cx, cy, w, h] rows for support images (image.py:195-231);
    no class filtering (the file is already per-class)."""
    out = []
    bs = _read_label_file(labpath)
    for row in bs:
        r = _transform_box(row, flip, dx, dy, sx, sy)
        if r is None:
            continue
        out.append(np.asarray(r[1:], np.float32))
        if len(out) >= MAX_BOXES:
            break
    return out


def image_to_array(img) -> np.ndarray:
    """PIL RGB -> float32 HWC in [0, 1] (NHWC pipeline layout)."""
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0
