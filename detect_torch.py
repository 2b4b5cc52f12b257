#!/usr/bin/env python3
"""Single-image detection with the PyTorch/CUDA port (reference CLI
contract, detect.py:105-119):

    python detect_torch.py cfgfile weightfile imgfile [pil|cv2|skimage]

Writes predictions.jpg with drawn boxes and prints class confidences. The
cv2/skimage variants reproduce detect.py:39-103 of the reference, including
their IO quirks (cv2's BGR read, skimage's float resize). Runs on the GPU and
fails when there is none; reads and writes image files with PIL, cv2 or
skimage. Decode, rank and NMS run on the card (`DevicePipeline`, conf 0.5,
NMS 0.4) with a candidate buffer that holds every anchor of the grid, so the
boxes are those of the reference's host path.
"""

import sys
import time

import numpy as np


def _setup(cfgfile, weightfile, device):
    from fewshot_detection_tpu_torch.eval.detector import PlainDetector

    m = PlainDetector(cfgfile, weightfile, device=device)
    print(f"Loading weights from {weightfile}... Done!")
    n_classes = m.region.num_classes
    if n_classes == 20:
        namesfile = "data/voc.names"
    elif n_classes == 80:
        namesfile = "data/coco.names"
    else:
        namesfile = "data/names"
    with open(namesfile) as f:
        class_names = [l.strip() for l in f if l.strip()]
    return m, class_names


def detect_pipeline(region):
    """do_detect's decode + NMS (conf 0.5 on objectness, NMS 0.4) on the
    device. The buffer is cut to the grid's anchor count, so it holds every
    candidate of a grid of up to `nms_device.MAX_K` anchors and nothing is
    truncated."""
    from fewshot_detection_tpu_torch.eval.device_pipeline import DevicePipeline
    from fewshot_detection_tpu_torch.ops.nms_device import MAX_K

    return DevicePipeline(region, conf_thresh=0.5, nms_thresh=0.4, top_k=MAX_K)


def detect_boxes(m, pipe, output):
    """The kept boxes of one image: `pipe` on the device, or the host path
    (get_region_boxes + nms) for an image whose candidates overflow the
    buffer, which only a grid larger than the kernel's limit can give."""
    from fewshot_detection_tpu_torch.ops.boxes import get_region_boxes, nms

    boxes = pipe.eval_boxes(output)
    if boxes is None:
        boxes = [nms(get_region_boxes(output, 0.5, m.region.num_classes,
                                      m.region.anchor_wh)[0], 0.4)]
    return boxes[0]


def _do_detect(m, sized01, imgfile):
    """Two timed passes (the second measures a warm forward), at do_detect's
    conf/nms 0.5/0.4 (reference utils.py:410-458)."""
    pipe = detect_pipeline(m.region)
    boxes = None
    for i in range(2):
        start = time.time()
        boxes = detect_boxes(m, pipe, m(sized01[None]))
        finish = time.time()
        if i == 1:
            print(f"{imgfile}: Predicted in {finish - start:f} seconds.")
    return boxes


def detect(cfgfile, weightfile, imgfile, device="cuda"):
    """PIL variant (reference detect.py:8-37)."""
    from PIL import Image

    from fewshot_detection_tpu_torch.utils import plot_boxes
    from fewshot_detection_tpu_torch.utils.imaging import load_image_resized

    m, class_names = _setup(cfgfile, weightfile, device)
    img = Image.open(imgfile).convert("RGB")
    sized = load_image_resized(imgfile, m.width, m.height)
    boxes = _do_detect(m, sized, imgfile)
    plot_boxes(img, boxes, "predictions.jpg", class_names)


def detect_cv2(cfgfile, weightfile, imgfile, device="cuda"):
    """cv2 variant (reference detect.py:39-70): BGR read, resize, then
    BGR->RGB for the model; boxes drawn on the original BGR array."""
    import cv2

    from fewshot_detection_tpu_torch.utils.imaging import plot_boxes_cv2

    m, class_names = _setup(cfgfile, weightfile, device)
    img = cv2.imread(imgfile)
    sized = cv2.resize(img, (m.width, m.height))
    sized = cv2.cvtColor(sized, cv2.COLOR_BGR2RGB)
    boxes = _do_detect(m, sized.astype(np.float32) / 255.0, imgfile)
    plot_boxes_cv2(img, boxes, savename="predictions.jpg", class_names=class_names)


def detect_skimage(cfgfile, weightfile, imgfile, device="cuda"):
    """skimage variant (reference detect.py:72-103). Quirks reproduced:
    `resize(img, (m.width, m.height))` passes (rows, cols), so width/height
    swap for non-square nets, and the result is float [0,1] scaled by 255
    then re-normalized by do_detect's /255."""
    from skimage import io
    from skimage.transform import resize

    from fewshot_detection_tpu_torch.utils.imaging import plot_boxes_cv2

    m, class_names = _setup(cfgfile, weightfile, device)
    img = io.imread(imgfile)
    sized = resize(img, (m.width, m.height)) * 255
    boxes = _do_detect(m, sized.astype(np.float32) / 255.0, imgfile)
    plot_boxes_cv2(img, boxes, savename="predictions.jpg", class_names=class_names)


VARIANTS = {"pil": detect, "cv2": detect_cv2, "skimage": detect_skimage}


if __name__ == "__main__":
    if len(sys.argv) in (4, 5):
        variant = sys.argv[4] if len(sys.argv) == 5 else "pil"
        if variant not in VARIANTS:
            print(f"unknown variant {variant!r}; pick one of {sorted(VARIANTS)}")
            sys.exit(1)
        VARIANTS[variant](sys.argv[1], sys.argv[2], sys.argv[3])
    else:
        print("Usage:")
        print("  python detect_torch.py cfgfile weightfile imgfile [pil|cv2|skimage]")
