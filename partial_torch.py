#!/usr/bin/env python3
"""Weight-file truncation for pretrained-backbone extraction, on the PyTorch
port (same argv as partial.py, the reference CLI contract partial.py:3-23):

    python partial_torch.py cfgfile weightfile output cutoff

Reads `weightfile` against `cfgfile`'s layers and writes the first `cutoff`
layers to `output` with a zero `seen` counter. Host code only: no device is
needed.
"""

import sys

from fewshot_detection_tpu_torch.cli.partial import partial


if __name__ == "__main__":
    if len(sys.argv) == 5:
        partial(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:
        print("Usage:")
        print("python partial_torch.py cfgfile weightfile output cutoff")
