#!/usr/bin/env python3
"""Meta validation with per-batch support codes, with the PyTorch/CUDA port
(reference CLI contract, valid_meta.py):

    python valid_meta_torch.py datacfg darknetcfg learnetcfg weightfile [gpu]

Runs on the GPU (float32, TF32 off for convolutions and matrix products) and
fails when there is none.
On N GPUs: `FSD_EVAL_MESH=N torchrun --nproc_per_node=N
valid_meta_torch.py ...` (rank 0 draws each batch's support codes).
"""

import sys

if __name__ == "__main__":
    if len(sys.argv) in (5, 6):
        from fewshot_detection_tpu_torch.cli.common import resolve_configs
        from fewshot_detection_tpu_torch.eval.valid import run_valid_meta

        data_options, darknet, learnet, settings = resolve_configs(
            sys.argv[1], sys.argv[2], sys.argv[3]
        )
        run_valid_meta(data_options, darknet, learnet, sys.argv[4], settings, device="cuda")
    else:
        print("Usage:")
        print(" python valid_meta_torch.py datacfg darknetcfg learnetcfg weightfile")
