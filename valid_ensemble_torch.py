#!/usr/bin/env python3
"""Ensemble-reweighting validation with the PyTorch/CUDA port (reference CLI
contract, valid_ensemble.py:185-217):

    python valid_ensemble_torch.py datacfg darknetcfg learnetcfg weightfile \
        [gpu] [use_baserw]

Runs on the GPU (float32, TF32 off for convolutions and matrix products) and
fails when there is none.
On N GPUs: `FSD_EVAL_MESH=N torchrun --nproc_per_node=N
valid_ensemble_torch.py ...` (each rank sweeps its block of every batch;
rank 0 makes the class codes and writes the files).
"""

import sys

if __name__ == "__main__":
    if len(sys.argv) in (5, 6, 7):
        from fewshot_detection_tpu_torch.cli.common import resolve_configs
        from fewshot_detection_tpu_torch.eval.valid import run_valid_ensemble

        use_baserw = len(sys.argv) == 7
        data_options, darknet, learnet, settings = resolve_configs(
            sys.argv[1], sys.argv[2], sys.argv[3]
        )
        run_valid_ensemble(
            data_options, darknet, learnet, sys.argv[4], settings,
            use_baserw=use_baserw, device="cuda",
        )
    else:
        print("Usage:")
        print(" python valid_ensemble_torch.py datacfg darknetcfg learnetcfg weightfile")
