#!/usr/bin/env python3
"""Episodic meta training with the PyTorch/CUDA port (reference CLI contract,
train_meta.py:3-6):

    python train_meta_torch.py datacfg darknetcfg learnetcfg weightfile

Runs on the GPU and fails when there is none. FSD_DTYPE=bfloat16 trains in
bfloat16 (BN statistics and the loss stay float32); float32 runs without TF32.
On N GPUs: `torchrun --nproc_per_node=N train_meta_torch.py ...`, one
replica group a rank (parallel/mesh.py).
"""

import sys

if __name__ == "__main__":
    if len(sys.argv) != 5:
        print("Usage:")
        print("python train_meta_torch.py datacfg darknetcfg learnetcfg weightfile")
        sys.exit(1)

    from fewshot_detection_tpu_torch.cli.train_meta_cli import main

    main(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], device="cuda")
