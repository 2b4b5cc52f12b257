#!/usr/bin/env python3
"""The paper's whole workflow (data, plain, part, base, few, tune, evalb,
evalt) on the PyTorch port: the counterpart of scripts/full_workflow.py,
with the same flags and a --device (default cuda).

    python3 scripts/full_workflow_torch.py [--tiny] [--root DIR] [--stage STAGE] [--device cpu]

See fewshot_detection_tpu_torch/cli/workflow.py for the stages."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.cli import workflow  # noqa: E402

if __name__ == "__main__":
    workflow.main()
