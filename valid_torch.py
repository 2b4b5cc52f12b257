#!/usr/bin/env python3
"""Plain VOC validation sweep with the PyTorch/CUDA port (reference CLI
contract, valid.py:87-110):

    python valid_torch.py datacfg cfgfile weightfile [gpu]

Runs on the GPU (float32, TF32 off for convolutions and matrix products) and
fails when there is none.
On N GPUs: `FSD_EVAL_MESH=N torchrun --nproc_per_node=N valid_torch.py ...`
(each rank sweeps its block of every batch; rank 0 writes the files).
"""

import sys

if __name__ == "__main__":
    if len(sys.argv) in (4, 5):
        from fewshot_detection_tpu_torch.cli.common import resolve_configs
        from fewshot_detection_tpu_torch.eval.valid import run_valid

        data_options, _, _, settings = resolve_configs(sys.argv[1], sys.argv[2])
        run_valid(data_options, sys.argv[2], sys.argv[3], settings, device="cuda")
    else:
        print("Usage:")
        print(" python valid_torch.py datacfg cfgfile weightfile")
