#!/usr/bin/env python3
"""Webcam demo loop of the PyTorch/CUDA port (reference CLI contract,
demo.py:42-52):

    python demo_torch.py cfgfile weightfile

Requires OpenCV with camera access; exits with code 2 and the message of
`demo.py` when cv2 is missing. Each frame runs through `PlainDetector` on the
GPU, and its boxes come from the device pipeline of `detect_torch.py`
(decode, rank and NMS on the card, at conf 0.5 and NMS 0.4, with a buffer of
every anchor of the grid); nothing moves to the host before the boxes."""

import sys


def demo(cfgfile, weightfile, device="cuda"):
    try:
        import cv2
    except ImportError:
        print("demo.py requires OpenCV (cv2) with camera support; not available here")
        sys.exit(2)

    import numpy as np

    from detect_torch import detect_boxes, detect_pipeline
    from fewshot_detection_tpu_torch.eval.detector import PlainDetector

    m = PlainDetector(cfgfile, weightfile, device=device)
    n_classes = m.region.num_classes
    namesfile = "data/voc.names" if n_classes == 20 else "data/coco.names"
    with open(namesfile) as f:
        class_names = [l.strip() for l in f if l.strip()]  # noqa: F841  (read as demo.py does)
    pipe = detect_pipeline(m.region)

    cap = cv2.VideoCapture(0)
    if not cap.isOpened():
        print("Unable to open camera")
        sys.exit(-1)
    while True:
        res, img = cap.read()
        if not res:
            print("Unable to read image")
            break
        sized = cv2.resize(img, (m.width, m.height))
        rgb = cv2.cvtColor(sized, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        boxes = detect_boxes(m, pipe, m(rgb[None]))
        print("------")
        draw = img.copy()
        h, w = draw.shape[:2]
        for box in boxes:
            x1 = int((box[0] - box[2] / 2) * w)
            y1 = int((box[1] - box[3] / 2) * h)
            x2 = int((box[0] + box[2] / 2) * w)
            y2 = int((box[1] + box[3] / 2) * h)
            cv2.rectangle(draw, (x1, y1), (x2, y2), (0, 0, 255), 2)
        cv2.imshow(cfgfile, draw)
        if (cv2.waitKey(1) & 0xFF) == 27:
            break


if __name__ == "__main__":
    if len(sys.argv) == 3:
        demo(sys.argv[1], sys.argv[2])
    else:
        print("Usage:")
        print("    python demo_torch.py cfgfile weightfile")
