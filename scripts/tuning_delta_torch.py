#!/usr/bin/env python3
"""Per-class base-vs-tuned AP table from a full_workflow run.

The paper's core claim is that k-shot tuning lifts novel-class AP above
the base-trained model (reference README.md:84-152; the tuned model is
valid_ensemble.py over the metatune checkpoint). This renders that delta
for a finished scripts/full_workflow[_coco]_torch.py run:

    python scripts/tuning_delta_torch.py --root /tmp/fsd_r4b
    python scripts/tuning_delta_torch.py --root /tmp/fsd_coco_r4 \
        --novel-file data/coco_novels.txt --novelid 2

Reads the evalb/evalt done markers ("aps" per-class dict); for runs
driven before the markers carried per-class APs, falls back to the
"AP for <cls> = <ap>" lines the scorer prints into logs/eval_*.log
(eval/voc_eval.py in the port; the reference printed the same line from
scripts/voc_eval.py:315).
"""

# The counterpart of scripts/tuning_delta.py on the port's roots: the same
# markers, log fallback, arguments and markdown table, byte for byte.

import argparse
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_aps(root, stage):
    marker = os.path.join(root, "state", f"eval{stage}.done")
    if os.path.exists(marker):
        payload = json.load(open(marker))
        if "aps" in payload:
            return payload["aps"], payload
    # fallback: scrape the scorer's per-class lines from the eval log
    log_path = os.path.join(root, "logs", f"eval_{'base' if stage == 'b' else 'tune'}.log")
    aps = {}
    payload = {}
    if os.path.exists(log_path):
        for line in open(log_path):
            m = re.match(r"AP for (.+) = ([0-9.]+)", line.strip())
            if m:
                aps[m.group(1)] = float(m.group(2))
        if os.path.exists(marker):
            payload = json.load(open(marker))
    return aps, payload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--novel-file", default=os.path.join(REPO, "data/voc_novels.txt"))
    ap.add_argument("--novelid", default="0")
    args = ap.parse_args()

    from fewshot_detection_tpu_torch.config.settings import get_novels

    novels = set(get_novels(args.novel_file, args.novelid))
    base_aps, base_meta = load_aps(args.root, "b")
    tune_aps, tune_meta = load_aps(args.root, "t")
    if not base_aps or not tune_aps:
        sys.exit(f"missing eval APs under {args.root} (evalb: {len(base_aps)}, "
                 f"evalt: {len(tune_aps)})")

    classes = sorted(set(base_aps) | set(tune_aps),
                     key=lambda c: (c not in novels, c))
    print("| class | base AP | tuned AP | delta |")
    print("|---|---|---|---|")
    for c in classes:
        b = base_aps.get(c)
        t = tune_aps.get(c)
        tag = " (novel)" if c in novels else ""
        bs = "--" if b is None else f"{b:.4f}"
        ts = "--" if t is None else f"{t:.4f}"
        ds = "--" if b is None or t is None else f"{t - b:+.4f}"
        print(f"| {c}{tag} | {bs} | {ts} | {ds} |")

    def mean(vals):
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else 0.0

    for label, pick in (("novel", lambda c: c in novels),
                        ("base-class", lambda c: c not in novels)):
        bm = mean([base_aps.get(c) for c in classes if pick(c) and c in base_aps])
        tm = mean([tune_aps.get(c) for c in classes if pick(c) and c in tune_aps])
        print(f"| mean {label} | {bm:.4f} | {tm:.4f} | {tm - bm:+.4f} |")
    if base_meta or tune_meta:
        print(f"\nbase ckpt: {base_meta.get('checkpoint')}\n"
              f"tuned ckpt: {tune_meta.get('checkpoint')}")


if __name__ == "__main__":
    main()
