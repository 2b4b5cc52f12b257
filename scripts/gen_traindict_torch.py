#!/usr/bin/env python3
"""class->list dict files + .data cfgs on the PyTorch port's `data/prep.py`
(the counterpart of scripts/gen_traindict.py: same argv, files and prints).

    python scripts/gen_traindict_torch.py --voclist /path/voc/voclist \
        [--data data] [--cfg cfg]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.data.prep import gen_traindict  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--voclist", required=True)
    p.add_argument("--data", default="data")
    p.add_argument("--cfg", default="cfg")
    args = p.parse_args()
    gen_traindict(args.voclist, args.data, args.cfg)
    print("wrote traindict files to", args.data, "and .data cfgs to", args.cfg)
