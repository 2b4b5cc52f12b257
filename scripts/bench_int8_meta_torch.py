#!/usr/bin/env python3
"""int8 meta-serving benchmark of the PyTorch port on the card: learnet
class codes and the detection sweep, bfloat16 against int8.

The counterpart of scripts/bench_int8_meta.py, with the same argv (and
--device, default cuda), the same inputs from RandomState(0) and the same
JSON keys. Ensemble eval has two hot phases: (1) the learnet over every
support image, (2) the fixed-code detection sweep over every test image.
Both are measured at the flagship 416 px 15-way config in bfloat16, then
int8 (backbone), int8 + head (the fused reweight+head as an int8 product)
and the int8 learnet for phase 1.

The JAX script calls MetaDetector's jitted privates; each maps to the
port's path that computes the same thing, on inputs already on the card:

  _codes(params, mx, mk)[0]           MetaDetector.class_codes(mx, mk)[0]
                                      (float graph; its codes come back
                                      to the host, which fences the call)
  _detect(params, x, committed)       MetaDetector.detect(x, committed)
                                      before quantize_int8
  detect_fold (jit of detect_forward  models/meta.py:detect_forward on the
  on fold_batchnorm / folded_spec)    same folded tree and spec, bfloat16,
                                      fuse=True
  _codes_int8(lqparams, mx, mk)[0]    class_codes(mx, mk)[0] after
                                      quantize_int8(calib_support=...)
  _detect_int8(qparams, x, committed) detect(x, committed) after
                                      quantize_int8 (quant_head=True for
                                      the *_head keys)

The fence is torch.cuda.synchronize() and then one value read back.

    python scripts/bench_int8_meta_torch.py [--batch 16] [--support-batch 64]
        [--weights W] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_CLS = 15
SIZE = 416
DARKNET_CFG = os.path.join(REPO, "cfg/darknet_dynamic.cfg")
LEARNET_CFG = os.path.join(REPO, "cfg/reweighting_net.cfg")
ITERS, WARMUP = 40, 3


def fence(x):
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x.reshape(-1)[0])
    return float(np.asarray(x).ravel()[0])


def rate(fn, n_items):
    for _ in range(WARMUP):
        out = fn()
    fence(out)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn()
    fence(out)
    return n_items * ITERS / (time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--support-batch", type=int, default=64)
    ap.add_argument("--weights", default=None,
                    help="trained .weights checkpoint — random init collapses "
                    "activations through 31 layers and underreports "
                    "quantization deviation")
    ap.add_argument("--device", default="cuda",
                    help="the device the networks run on (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from fewshot_detection_tpu_torch.eval.detector import MetaDetector, resolve_device
    from fewshot_detection_tpu_torch.models import meta as meta_mod
    from fewshot_detection_tpu_torch.models.darknet import fold_batchnorm, folded_spec
    from fewshot_detection_tpu_torch.models.meta import MetaSpec
    from fewshot_detection_tpu_torch.utils.card import card_line

    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    rng = np.random.RandomState(0)
    m = MetaDetector(DARKNET_CFG, LEARNET_CFG, args.weights,
                     compute_dtype=torch.bfloat16, device=dev)

    sb = args.support_batch
    metax = rng.rand(sb, SIZE, SIZE, 3).astype(np.float32)
    mask = (rng.rand(sb, SIZE, SIZE, 1) > 0.5).astype(np.float32)
    imgs = rng.rand(args.batch, SIZE, SIZE, 3).astype(np.float32)

    codes = m.class_codes(metax[:N_CLS], mask[:N_CLS])
    committed = m.commit_codes(codes)

    def dev_pct(ref, q):
        """max |q - ref| as % of ref's activation range."""
        ref = np.asarray(torch.as_tensor(ref).float().cpu(), np.float32)
        q = np.asarray(torch.as_tensor(q).float().cpu(), np.float32)
        rng_ = float(ref.max() - ref.min()) or 1.0
        return round(100.0 * float(np.abs(q - ref).max()) / rng_, 2)

    results = {}
    # phase 1: learnet codes, bf16
    mx = torch.from_numpy(metax).to(dev)
    mk = torch.from_numpy(mask).to(dev)
    codes_ref = m.class_codes(mx, mk)[0]
    results["codes_bf16_img_s"] = round(rate(lambda: m.class_codes(mx, mk)[0], sb), 1)
    # phase 2: detection sweep, bf16 (BN applied per layer at inference)
    xi = torch.from_numpy(imgs).to(dev)
    det_ref = m.detect(xi, committed)
    results["detect_bf16_img_s"] = round(
        rate(lambda: m.detect(xi, committed), args.batch), 1)

    # bf16 on the BN-FOLDED graph — the apples-to-apples serving baseline
    # for the int8 rows (quantization starts from the folded weights)
    fspec = MetaSpec(folded_spec(m.spec.darknet), m.spec.learnet)
    fparams = {"darknet": fold_batchnorm(m.spec.darknet, m.params["darknet"]),
               "learnet": None}

    @torch.no_grad()
    def detect_fold(p, x, dw):
        return meta_mod.detect_forward(
            fspec, p, x.to(torch.bfloat16), [d.to(torch.bfloat16) for d in dw],
            train=False, fuse=True,
        )[0].float()

    results["detect_bf16_folded_img_s"] = round(
        rate(lambda: detect_fold(fparams, xi, committed), args.batch), 1)
    results["detect_bf16_folded_dev_pct"] = dev_pct(
        det_ref, detect_fold(fparams, xi, committed))

    # quantize: backbone + learnet, head still bf16
    m.quantize_int8(imgs, codes, calib_support=(metax[:N_CLS], mask[:N_CLS]))
    results["codes_int8_img_s"] = round(rate(lambda: m.class_codes(mx, mk)[0], sb), 1)
    results["codes_int8_dev_pct"] = dev_pct(codes_ref, m.class_codes(mx, mk)[0])
    results["detect_int8_img_s"] = round(
        rate(lambda: m.detect(xi, committed), args.batch), 1)
    results["detect_int8_dev_pct"] = dev_pct(det_ref, m.detect(xi, committed))

    # + int8 fused reweight+head
    m.quantize_int8(imgs, codes, calib_support=None, quant_head=True)
    results["detect_int8_head_img_s"] = round(
        rate(lambda: m.detect(xi, committed), args.batch), 1)
    results["detect_int8_head_dev_pct"] = dev_pct(det_ref, m.detect(xi, committed))

    line = {"metric": "int8_meta_serving", "batch": args.batch, "support_batch": sb,
            **results}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
