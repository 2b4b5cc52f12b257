#!/usr/bin/env python3
"""Multi-scale face-detection sweep on the PyTorch port (reference
scripts/eval_widerface.py): walks a WIDER-style directory tree, resizes each
image to a multiple of the network stride, detects at conf 0.05 / nms 0.4,
writes per-image box files and annotated images.

    python scripts/eval_widerface_torch.py cfgfile weightfile valdir savedir [--device DEVICE]
"""

# The counterpart of scripts/eval_widerface.py: the same walk, sizes, omit
# rule, prints, box files and annotated images, with a --device (default
# cuda). Where that script decodes and NMSes on the host, this one runs the
# device pipeline (eval/device_pipeline.py:DevicePipeline, then the nms_rows
# kernel) with a buffer of every anchor of the image's grid, so nothing is
# cut and the boxes are the host path's; a grid of more than 5,600 anchors
# (a portrait image over 1,120 cells) takes the kernel's long-row path.
# Images are read with PIL, or under FSD_NATIVE=1 by the native library
# (the port's decoders and its copy of PIL's default bicubic resize); the
# boxes are drawn on the array as PIL draws them, and a .png is written by
# data/png.py, any other format through PIL.

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

USAGE = ("Usage: python scripts/eval_widerface_torch.py cfgfile weightfile valdir savedir"
         " [--device DEVICE]")


def save_boxes(img_w, img_h, boxes, savename):
    with open(savename, "w") as f:
        f.write(f"{len(boxes)}\n")
        for box in boxes:
            x1 = round((box[0] - box[2] / 2.0) * img_w)
            y1 = round((box[1] - box[3] / 2.0) * img_h)
            w = round(box[2] * img_w)
            h = round(box[3] * img_h)
            f.write(f"{x1} {y1} {w} {h} {box[4]:f}\n")


def read_image(imgfile, sw, sh):
    """(the file as (H, W, 3) uint8 RGB, resized to (sh, sw, 3) as PIL's
    default `resize` makes it): PIL, or the native library under
    FSD_NATIVE=1."""
    import numpy as np

    if os.environ.get("FSD_NATIVE", "0") == "1":
        from fewshot_detection_tpu_torch.native import NativeImagePipe

        pipe = NativeImagePipe()
        rgb = pipe.decode(imgfile)
        return rgb, pipe.resize_pil(rgb, sw, sh)
    from PIL import Image

    img = Image.open(imgfile).convert("RGB")
    return np.array(img), np.asarray(img.resize((sw, sh)), np.uint8)


def detect_pipeline(m, output):
    """Decode, rank and NMS on the device at conf 0.05 / nms 0.4 with a
    buffer of every anchor of this output's grid."""
    from fewshot_detection_tpu_torch.eval.device_pipeline import DevicePipeline

    _, gh, gw, _ = output.shape
    return DevicePipeline(m.region, conf_thresh=0.05, nms_thresh=0.4,
                          top_k=len(m.region.anchor_wh) * gh * gw)


def eval_widerface(cfgfile, weightfile, valdir, savedir, device="cuda"):
    import numpy as np

    from fewshot_detection_tpu_torch.eval.detector import PlainDetector
    from fewshot_detection_tpu_torch.utils.imaging import get_image_size, plot_boxes_array

    m = PlainDetector(cfgfile, weightfile, device=device)
    scale = 16
    for parent, _dirnames, filenames in os.walk(valdir):
        if parent == valdir:
            continue
        targetdir = os.path.join(savedir, os.path.basename(parent))
        os.makedirs(targetdir, exist_ok=True)
        for filename in filenames:
            imgfile = os.path.join(parent, filename)
            width, height = get_image_size(imgfile)
            sw = int(round(width / scale) * 16)
            sh = int(round(height / scale) * 16)
            print(filename, width, height, sw, sh)
            if sw * sh > 1024 * 2560:
                print(f"omit {filename}")
                continue
            rgb, sized = read_image(imgfile, sw, sh)
            x = sized.astype(np.float32)[None] / 255.0
            output = m(x)
            boxes = detect_pipeline(m, output).eval_boxes(output)[0]
            plot_boxes_array(rgb, boxes, os.path.join(targetdir, filename))
            save_boxes(
                width, height, boxes,
                os.path.join(targetdir, os.path.splitext(filename)[0] + ".txt"),
            )


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) == 5:
        eval_widerface(argv[1], argv[2], argv[3], argv[4], device=device)
    else:
        print(USAGE)


if __name__ == "__main__":
    main()
