"""Bench the port's MetaDevicePipeline on the card against the host v2
decode + NMS path.

The counterpart of scripts/bench_meta_pipeline.py: the same argv (without
--interpret, which has no counterpart, and with --device, default cuda),
the same `_Region`, the same raw head output from RandomState(0),
(batch * n_cls, 13, 13, 30) float32 on the device, the same host
reference and the same count-mismatch check (exit 1). The meta sweep's
per-(image, class) rows multiply the NMS calls by n_cls; on the card one
pipeline call decodes, ranks and runs every row's NMS in one launch of the
port's kernel (csrc/nms.cu through ops/nms_device.py:nms_rows). The JAX
script times two device pipelines, with and without its Pallas kernel; the
port has one, whose NMS is that kernel (its plain version serves CPU
tensors only), so one pipeline is timed.

    python scripts/bench_meta_pipeline_torch.py [--batch 16] [--n-cls 15]
        [--conf 0.25] [--iters 10] [--skip-host] [--device cuda]

Prints the card and its power limit, the device line, and unless
--skip-host the host line and the mismatch count.
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class _Region:
    # yolo-voc anchor set (cfg/darknet_dynamic.cfg), single-class meta head
    anchor_wh = ((1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
                 (9.47112, 4.84053), (11.2364, 10.0071))
    num_classes = 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-cls", type=int, default=15)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--skip-host", action="store_true",
                    help="skip the (very slow) host reference sweep")
    ap.add_argument("--device", default="cuda",
                    help="the device the pipeline runs on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.eval.device_pipeline import MetaDevicePipeline
    from fewshot_detection_tpu_torch.ops.boxes import get_region_boxes_v2, nms
    from fewshot_detection_tpu_torch.utils.card import card_line

    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    rng = np.random.RandomState(0)
    out = torch.from_numpy(rng.randn(
        args.batch * args.n_cls, 13, 13,
        5 * (5 + _Region.num_classes)).astype(np.float32)).to(dev)

    def fence(t):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(t.reshape(-1)[0])

    pipe = MetaDevicePipeline(_Region, args.n_cls, conf_thresh=args.conf,
                              nms_thresh=0.45, top_k=128)
    res = pipe(out)  # first call + host format once
    t0 = time.perf_counter()
    for _ in range(args.iters):
        rows, keep = pipe.device_call(out)
    fence(rows)
    dt = (time.perf_counter() - t0) / args.iters
    kept = sum(len(r) for r in res)
    nms_kernel = "csrc/nms.cu" if dev.type == "cuda" else "nms_rows_reference (cpu)"
    print(f"device pipeline nms={nms_kernel}: {dt * 1000:.1f} "
          f"ms/batch ({args.batch} imgs x {args.n_cls} cls), kept={kept}", flush=True)
    result = {"device_ms": dt * 1000, "kept": kept}

    if not args.skip_host:
        t0 = time.perf_counter()
        lists = get_region_boxes_v2(
            out, args.n_cls, args.conf, _Region.num_classes,
            _Region.anchor_wh, only_objectness=False, validation=False,
        )
        host = [nms(bl, 0.45) for bl in lists]
        dt = time.perf_counter() - t0
        host_kept = sum(len(r) for r in host)
        print(f"host v2 decode+nms: {dt * 1000:.1f} ms/batch, kept={host_kept}", flush=True)
        mism = sum(1 for a, b in zip(host, res) if len(a) != len(b))
        print(f"rows with count mismatch vs host: {mism}", flush=True)
        result.update(host_ms=dt * 1000, host_kept=host_kept, mismatch=mism)
        if mism:
            sys.exit(1)
    return result


if __name__ == "__main__":
    main()
