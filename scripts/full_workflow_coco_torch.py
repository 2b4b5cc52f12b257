#!/usr/bin/env python3
"""The paper's COCO protocol (60 base / 20 novel classes: data, plain, part,
base, few, tune, evalb, evalt) on the PyTorch port: the counterpart of
scripts/full_workflow_coco.py, with its --root and --stage and a --device
(default cuda).

    python3 scripts/full_workflow_coco_torch.py [--root DIR] [--stage STAGE] [--device cpu]

See fewshot_detection_tpu_torch/cli/workflow_coco.py for the stages."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.cli import workflow_coco  # noqa: E402

if __name__ == "__main__":
    workflow_coco.main()
