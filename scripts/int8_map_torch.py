#!/usr/bin/env python3
"""Score the port's int8 serving path in mAP, not just output deviation: the
counterpart of scripts/int8_map.py.

Reruns the ensemble sweep and VOC07 scoring of a finished
`full_workflow_torch.py` root's TUNED checkpoint with FSD_INT8=1 (per-channel
int8 weights and calibrated activation scales, models/quant.py; the fused
reweight+head int8 too unless --no-head), in process as cli/workflow.py runs
its eval stages, and prints the float-vs-int8 mAP pair. The float numbers
come from the root's state/evalt.done marker (same checkpoint, same
held-out valid list, same scorer). The sweep writes the same result files as
the evalt stage, over them; its log is <root>/logs/eval_int8.log.

    python3 scripts/int8_map_torch.py [--root DIR] [--no-head] [--device cpu]
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.cli import workflow  # noqa: E402


@contextlib.contextmanager
def int8_env(head: bool):
    env = {"FSD_INT8": "1", "FSD_INT8_HEAD": "1" if head else "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "fsd_flagship"),
                    help="a finished full_workflow_torch.py root")
    ap.add_argument("--no-head", action="store_true",
                    help="leave the fused reweight+head contraction in the compute dtype "
                    "(FSD_INT8_HEAD=0)")
    ap.add_argument("--device", default="cuda", help="the device the sweep runs on")
    args = ap.parse_args(argv)
    root = args.root

    data = workflow.read_done(root, "data")
    ckpt = workflow.read_done(root, "tune")["ckpt"]
    ref = workflow.read_done(root, "evalt")
    novelid = data.get("novelid", 0)
    workflow.configure(workflow.parse_args(
        ["--root", root, "--device", args.device, "--novelid", str(novelid)]
        + (["--tiny"] if workflow.recorded_mode(root) == "tiny" else [])))

    workflow.log(f"int8 sweep on {ckpt} (log: {os.path.join(root, 'logs', 'eval_int8.log')})")
    t0 = time.perf_counter()
    with int8_env(not args.no_head):
        out = workflow._eval(root, "int8", os.path.join(root, "tune.data"), ckpt)
    sweep_s = time.perf_counter() - t0

    rows = [("mean mAP", "mean_ap"), ("base mAP", "base_mean"), ("novel mAP", "novel_mean")]
    print(f"\nint8 (quant_head={not args.no_head}) vs float32, tuned checkpoint, "
          f"novelid {novelid}:")
    for name, key in rows:
        print(f"  {name:10s} float32 {ref[key]:.4f}  int8 {out[key]:.4f}  "
              f"delta {out[key] - ref[key]:+.4f}")
    per_cls = {c: round(out["aps"][c] - ref["aps"][c], 4) for c in out["aps"] if c in ref["aps"]}
    print("  per-class delta:", json.dumps(per_cls))
    result = {"float32": {k: ref[k] for _, k in rows}, "int8": {k: out[k] for _, k in rows},
              "quant_head": not args.no_head, "novelid": novelid,
              "sweep_s": sweep_s, "checkpoint": ckpt}
    print("INT8JSON " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
