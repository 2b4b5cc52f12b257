#!/usr/bin/env python3
"""Per-image IoU recall sweep with the PyTorch/CUDA port (reference CLI
contract, recall.py:73-83):

    python recall_torch.py cfgfile weightfile imglist

Runs on the GPU and fails when there is none; reads image files with PIL.
"""

import sys


def main(cfgfile, weightfile, imglist, device="cuda"):
    from fewshot_detection_tpu_torch.eval.detector import PlainDetector
    from fewshot_detection_tpu_torch.eval.harness import recall_list

    return recall_list(PlainDetector(cfgfile, weightfile, device=device), imglist)


if __name__ == "__main__":
    if len(sys.argv) == 4:
        main(sys.argv[1], sys.argv[2], sys.argv[3])
    else:
        print("Usage:")
        print("python recall_torch.py cfgfile weightfile imglist")
