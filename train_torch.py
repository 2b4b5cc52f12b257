#!/usr/bin/env python3
"""Baseline YOLOv2 training with the PyTorch/CUDA port (reference CLI
contract, train.py):

    python train_torch.py datacfg cfgfile weightfile

Runs on the GPU and fails when there is none. FSD_DTYPE=bfloat16 trains in
bfloat16 (BN statistics and the loss stay float32); float32 runs without TF32.
On N GPUs: `torchrun --nproc_per_node=N train_torch.py ...`, one replica
group a rank (parallel/mesh.py).
"""

import sys

if __name__ == "__main__":
    if len(sys.argv) != 4:
        print("Usage:")
        print("python train_torch.py datacfg cfgfile weightfile")
        sys.exit(1)

    from fewshot_detection_tpu_torch.cli.train_plain_cli import main

    main(sys.argv[1], sys.argv[2], sys.argv[3], device="cuda")
