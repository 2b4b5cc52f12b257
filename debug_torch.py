#!/usr/bin/env python3
"""Single-image forward/backward debugging harness of the PyTorch/CUDA port
(reference CLI contract, debug.py):

    python debug_torch.py cfgfile weightfile imgpath

Loads one image and its label, runs the training forward, the region loss
and autograd's backward, and prints what `debug.py` prints: the first BN
layer's parameters, image, target and output samples, the loss and nGT, and
each layer's largest weight gradient, marked `<-- LARGE` past 10. Runs on
the GPU and fails when there is none; reads the image with PIL, or with the
native pipeline under FSD_NATIVE=1."""

import os
import sys

import numpy as np


def main(cfgfile, weightfile, imgpath, device="cuda"):
    import torch

    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.data.datasets import get_labpath, topath
    from fewshot_detection_tpu_torch.models import weights_io
    from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
    from fewshot_detection_tpu_torch.models.darknet import apply_network, init_params
    from fewshot_detection_tpu_torch.models.spec import build_spec
    from fewshot_detection_tpu_torch.ops.region_loss import region_loss
    from fewshot_detection_tpu_torch.utils.imaging import load_image_resized

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("debug_torch.py runs on the GPU and found none")
    spec = build_spec(parse_cfg(cfgfile))
    params = init_params(spec, 0)
    if weightfile and os.path.exists(weightfile):
        (params,), _ = weights_io.load_weights(weightfile, [spec], [params])

    labpath = get_labpath(topath(imgpath))
    label = np.zeros((1, 50, 5), np.float32)
    if os.path.exists(labpath) and os.path.getsize(labpath):
        rows = np.loadtxt(labpath).reshape(-1, 5)[:50]
        label[0, : rows.shape[0]] = rows

    first_bn = next(
        p["bn"] for l, p in zip(spec.layers, params)
        if l.kind == "conv" and l.batch_normalize
    )
    print("--- bn gamma ---\n", np.asarray(first_bn["gamma"])[:8])
    print("--- bn beta ---\n", np.asarray(first_bn["beta"])[:8])
    print("--- bn running_mean ---\n", np.asarray(first_bn["mean"])[:8])
    print("--- bn running_var ---\n", np.asarray(first_bn["var"])[:8])

    img = load_image_resized(imgpath, spec.width, spec.height)[None]
    print("----- img -----\n", img.ravel()[:16])
    print("----- target -----\n", label.ravel()[:16])

    tp = require_grads(from_jax_params(spec, params, dev))
    y, _ = apply_network(spec, tp, torch.from_numpy(img).to(dev), train=True)
    loss, metrics = region_loss(y, torch.from_numpy(label).to(dev), torch.ones(1, device=dev), 0,
                                spec.region)
    weights = [(layer, p["w"]) for layer, p in zip(spec.layers, tp)
               if p is not None and "w" in p]
    grads = torch.autograd.grad(loss, [w for _, w in weights])
    print("----- output -----\n", y.detach().cpu().numpy().ravel()[:16])
    print(f"loss = {float(loss.detach()):.6f}  nGT={int(metrics['nGT'])}")

    print("----- gradient norms per layer -----")
    for (layer, _), g in zip(weights, grads):
        gmax = float(g.abs().max())
        line = f"layer {layer.index:3d} {layer.kind:<6s} |dw|max {gmax:.3e}"
        if gmax > 10:
            line += "   <-- LARGE"
        print(line)
    return float(loss.detach()), [float(g.abs().max()) for g in grads]


if __name__ == "__main__":
    if len(sys.argv) == 4:
        main(sys.argv[1], sys.argv[2], sys.argv[3])
    else:
        print("Usage: python debug_torch.py cfgfile weightfile imgpath")
