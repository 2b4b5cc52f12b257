#!/usr/bin/env python3
"""Weight-file truncation for pretrained-backbone extraction, on the PyTorch
port (same argv as partial.py, the reference CLI contract partial.py:3-23):

    python partial_torch.py cfgfile weightfile output cutoff

Reads `weightfile` against `cfgfile`'s layers and writes the first `cutoff`
layers to `output` with a zero `seen` counter. Host code only: no device is
needed.
"""

import sys


def partial(cfgfile, weightfile, outfile, cutoff):
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models import weights_io
    from fewshot_detection_tpu_torch.models.darknet import init_params
    from fewshot_detection_tpu_torch.models.spec import build_spec

    spec = build_spec(parse_cfg(cfgfile))
    params = init_params(spec, 0)
    (params,), _ = weights_io.load_weights(weightfile, [spec], [params])
    weights_io.save_weights(outfile, [spec], [params], seen=0, cutoff=cutoff)
    print(f"save {outfile}")


if __name__ == "__main__":
    if len(sys.argv) == 5:
        partial(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:
        print("Usage:")
        print("python partial_torch.py cfgfile weightfile output cutoff")
