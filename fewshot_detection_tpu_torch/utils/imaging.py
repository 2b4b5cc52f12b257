"""Image IO helpers + box drawing (reference utils.py:293-408, 536-569).
PIL and cv2 are imported inside the functions that open, draw or save image
files, so the package imports (and serves in-memory data) without them."""

from __future__ import annotations

import os

import numpy as np


def get_image_size(fname: str) -> tuple[int, int]:
    """(width, height) without decoding pixel data: from the header through
    the native pipeline under FSD_NATIVE=1 (no PIL needed), else PIL."""
    if os.environ.get("FSD_NATIVE", "0") == "1":
        from ..native import NativeImagePipe

        return NativeImagePipe().image_size(fname)
    from PIL import Image

    with Image.open(fname) as im:
        return im.size


def load_image_resized(fname: str, width: int, height: int) -> np.ndarray:
    """float32 HWC [0,1] resized input (reference detect.py:26-27 semantics):
    PIL's default resize (bicubic), or under FSD_NATIVE=1 the native
    library's copy of it (no PIL needed; the same bytes wherever the two
    decodes agree, native/src/resize.cpp)."""
    if os.environ.get("FSD_NATIVE", "0") == "1":
        from ..native import NativeImagePipe

        img = NativeImagePipe().load_resized_pil(fname, width, height)
        return img.astype(np.float32) / 255.0
    from PIL import Image

    img = Image.open(fname).convert("RGB")
    img = img.resize((width, height))
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0


def scale_bboxes(bboxes, width: float, height: float):
    out = []
    for b in bboxes:
        b = list(b)
        b[0] *= width
        b[1] *= height
        b[2] *= width
        b[3] *= height
        out.append(b)
    return out


def _class_color(cls_id: int, n_classes: int) -> tuple[int, int, int]:
    """Deterministic per-class color (the reference's HSV ramp keyed by
    cls_id*123457 % classes, utils.py:336-343)."""
    colors = np.asarray(
        [[1, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 0], [1, 1, 0], [1, 0, 0]],
        np.float32,
    )
    offset = cls_id * 123457 % max(n_classes, 1)
    ratio = offset / max(n_classes, 1) * 5
    i, j = int(np.floor(ratio)), int(np.ceil(ratio))
    r = ratio - i
    rgb = (1 - r) * colors[i] + r * colors[j]
    return tuple(int(v * 255) for v in rgb[::-1])


def plot_boxes_cv2(img, boxes, savename=None, class_names=None, color=None):
    """Draw reference-format boxes on a cv2 image (numpy HWC, BGR) —
    reference utils.py:293-333. The reference passes RGB-ordered color
    tuples to cv2 calls on a BGR image, so saved class colors come out
    channel-swapped; that quirk is part of the contract and reproduced."""
    import cv2

    width, height = img.shape[1], img.shape[0]
    for box in boxes:
        x1 = int(round((box[0] - box[2] / 2.0) * width))
        y1 = int(round((box[1] - box[3] / 2.0) * height))
        x2 = int(round((box[0] + box[2] / 2.0) * width))
        y2 = int(round((box[1] + box[3] / 2.0) * height))
        rgb = color if color else (255, 0, 0)
        if len(box) >= 7 and class_names:
            cls_id = int(box[6])
            print(f"{class_names[cls_id]}: {float(box[5]):f}")
            if color is None:
                rgb = _class_color(cls_id, len(class_names))
            img = cv2.putText(
                img, class_names[cls_id], (x1, y1),
                cv2.FONT_HERSHEY_SIMPLEX, 1.2, rgb, 1,
            )
        img = cv2.rectangle(img, (x1, y1), (x2, y2), rgb, 1)
    if savename:
        print(f"save plot results to {savename}")
        cv2.imwrite(savename, img)
    return img


def plot_boxes(img, boxes, savename: str | None = None, class_names: list[str] | None = None):
    """Draw reference-format boxes ([cx,cy,w,h,conf,cls_conf,cls_id,...],
    normalized) onto a PIL image (reference utils.py:335-371)."""
    from PIL import ImageDraw

    width, height = img.width, img.height
    draw = ImageDraw.Draw(img)
    for box in boxes:
        x1 = (box[0] - box[2] / 2.0) * width
        y1 = (box[1] - box[3] / 2.0) * height
        x2 = (box[0] + box[2] / 2.0) * width
        y2 = (box[1] + box[3] / 2.0) * height
        rgb = (255, 0, 0)
        if len(box) >= 7 and class_names:
            cls_id = int(box[6])
            print(f"{class_names[cls_id]}: {float(box[5]):f}")
            rgb = _class_color(cls_id, len(class_names))
            draw.text((x1, y1), class_names[cls_id], fill=rgb)
        draw.rectangle([x1, y1, x2, y2], outline=rgb)
    if savename:
        print(f"save plot results to {savename}")
        img.save(savename)
    return img


def draw_rectangle(rgb: np.ndarray, xy, color=(255, 0, 0)) -> None:
    """PIL's `ImageDraw.Draw(img).rectangle(xy, outline=color)` (width 1)
    on an (H, W, 3) uint8 array in place, pixel for pixel: the float
    corners cut toward zero, the top and bottom rows drawn in full and the
    sides between them, everything clipped at the border (Pillow's
    ImagingDrawRectangle with its hline and line primitives). As Pillow,
    it raises on x1 < x0 or y1 < y0."""
    x0f, y0f, x1f, y1f = (float(v) for v in xy)
    if x1f < x0f:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1f < y0f:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = int(x0f), int(y0f), int(x1f), int(y1f)
    h, w = rgb.shape[:2]
    for y in (y0, y1):  # Pillow's hline: clipped to the row
        if 0 <= y < h and x1 >= 0 and x0 < w:
            rgb[y, max(x0, 0):min(x1, w - 1) + 1] = color
    # the sides: Pillow's vertical line from y0 + 1 toward y1, which stops
    # one short of its end: rows y0+1 .. y1-1, none when y1 = y0 + 1, and
    # when y1 = y0 the line runs backwards one step, row y0 + 1
    first, end = y0 + 1, (y0 + 2 if y1 == y0 else y1)
    lo, hi = max(first, 0), min(end, h)
    if lo < hi:
        for x in (x1, x0):
            if 0 <= x < w:
                rgb[lo:hi, x] = color


def save_rgb(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 array into `path`: PNG through data/png.py (no
    PIL needed), any other format through PIL by the file's extension."""
    if os.path.splitext(path)[1].lower() == ".png":
        from ..data.png import write_png

        write_png(path, rgb)
        return
    from PIL import Image

    Image.fromarray(rgb).save(path)


def plot_boxes_array(rgb: np.ndarray, boxes, savename: str | None = None) -> np.ndarray:
    """`plot_boxes(img, boxes, savename)` without class names, on an (H, W,
    3) uint8 array: each reference-format box (normalized cx, cy, w, h) as
    a red outline, pixel-equal to the PIL drawing; saved with `save_rgb`."""
    height, width = rgb.shape[:2]
    for box in boxes:
        x1 = (box[0] - box[2] / 2.0) * width
        y1 = (box[1] - box[3] / 2.0) * height
        x2 = (box[0] + box[2] / 2.0) * width
        y2 = (box[1] + box[3] / 2.0) * height
        draw_rectangle(rgb, (x1, y1, x2, y2), (255, 0, 0))
    if savename:
        print(f"save plot results to {savename}")
        save_rgb(savename, rgb)
    return rgb
