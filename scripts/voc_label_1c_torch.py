#!/usr/bin/env python3
"""Per-class labels_1c + voclist lists, on the PyTorch port's `data/prep.py`
(the counterpart of scripts/voc_label_1c.py: same argv, files and prints).

    python scripts/voc_label_1c_torch.py [--devkit VOCdevkit] [--voclist voclist]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.data.prep import write_voc_labels_1c  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--devkit", default="VOCdevkit")
    p.add_argument("--voclist", default="voclist")
    args = p.parse_args()
    write_voc_labels_1c(args.devkit, args.voclist)
    print("wrote labels_1c dirs + per-class lists under", args.voclist)
