#!/usr/bin/env python3
"""Precision/recall/F harness over a list of checkpoints, with the
PyTorch/CUDA port (reference CLI contract, eval.py):

    python eval_torch.py datacfg cfgfile weightfile1 [weightfile2 ...]

Runs on the GPU and fails when there is none; reads image files with PIL.
"""

import sys


def main(datacfg, cfgfile, weightfiles, device="cuda"):
    """(precision, recall, fscore) of every checkpoint, in order."""
    from fewshot_detection_tpu_torch.cli.common import resolve_configs
    from fewshot_detection_tpu_torch.eval.detector import PlainDetector
    from fewshot_detection_tpu_torch.eval.harness import test_detector
    from fewshot_detection_tpu_torch.utils import log

    data_options, _, _, settings = resolve_configs(datacfg, cfgfile)
    scores = []
    for weightfile in weightfiles:
        log(f"evaluating ... {weightfile}")
        detector = PlainDetector(cfgfile, weightfile, device=device)
        scores.append(test_detector(detector, data_options["valid"], settings))
    return scores


if __name__ == "__main__":
    if len(sys.argv) < 4:
        print("Usage:")
        print("python eval_torch.py datacfg cfgfile weightfile(s)")
        sys.exit(1)
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
