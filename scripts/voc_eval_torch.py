#!/usr/bin/env python3
"""VOC mAP scorer on the PyTorch port's `eval/voc_eval.py` (the counterpart
of scripts/voc_eval.py: same argv, same prints):

    python scripts/voc_eval_torch.py results/<dir>/ene000XXX/comp4_det_test_ \
        [--novel] [--single] [--devkit PATH] [--year 2007]

The VOCdevkit location comes from --devkit or $VOC_DEVKIT."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.eval.voc_eval import do_python_eval  # noqa: E402

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("res_prefix", type=str)
    parser.add_argument("--novel", action="store_true")
    parser.add_argument("--single", action="store_true")
    parser.add_argument("--devkit", type=str, default=None)
    parser.add_argument("--year", type=str, default="2007")
    parser.add_argument("--novel_file", type=str, default="data/voc_novels.txt")
    args = parser.parse_args()
    print(args.res_prefix)
    # the reference forced novel=True whatever the flag (voc_eval.py:341)
    do_python_eval(
        args.res_prefix,
        devkit_path=args.devkit,
        year=args.year,
        novel=True,
        novel_file=args.novel_file,
        single=args.single,
    )
