#!/usr/bin/env python3
"""VOC XML -> darknet labels + train lists, on the PyTorch port's
`data/prep.py` (the counterpart of scripts/voc_label.py: same argv, same
files, same prints).

    python scripts/voc_label_torch.py [--devkit VOCdevkit] [--out .]

Then: cat 2007_train.txt 2007_val.txt 2012_*.txt > voc_train.txt
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.data.prep import write_voc_labels  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--devkit", default="VOCdevkit")
    p.add_argument("--out", default=".")
    args = p.parse_args()
    lists = write_voc_labels(args.devkit, args.out)
    print("wrote:", *lists, sep="\n  ")
