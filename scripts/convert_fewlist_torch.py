#!/usr/bin/env python3
"""Rewrite the frozen data/vocsplit k-shot lists to a local dataset root, on
the PyTorch port's `data/prep.py` (the counterpart of
scripts/convert_fewlist.py: same argv, files and prints).

    python scripts/convert_fewlist_torch.py --droot /path/to/voc
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.data.prep import convert_fewlist  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--droot", default="/home/bykang/voc")
    args = p.parse_args()
    print("===> Converting few-shot name lists..")
    convert_fewlist(args.droot)
    print("===> Finished!")
