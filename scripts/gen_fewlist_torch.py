#!/usr/bin/env python3
"""Seeded k-shot list generation on the PyTorch port's `data/prep.py` (the
counterpart of scripts/gen_fewlist.py: same argv, files and prints).

    python scripts/gen_fewlist_torch.py --droot /path/to/voc [--type box|img|both]

Expects <droot>/voclist/<cls>_train.txt (from voc_label_1c_torch.py) and
<droot>/voc_train.txt (from voc_label_torch.py)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.data.prep import (  # noqa: E402
    gen_bbox_fewlist,
    gen_image_fewlist,
)

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--droot", required=True)
    p.add_argument("--type", default="box", choices=["box", "img", "both"])
    args = p.parse_args()
    voclist = os.path.join(args.droot, "voclist")
    rootfile = os.path.join(args.droot, "voc_train.txt")
    if args.type in ("img", "both"):
        print("===> Generating fewlist (images)")
        gen_image_fewlist(voclist)
    if args.type in ("box", "both"):
        print("===> Generating fewlist (bboxes)")
        gen_bbox_fewlist(rootfile, voclist)
