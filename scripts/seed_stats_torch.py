#!/usr/bin/env python3
"""Mean +- std of the few-shot tuning delta over several workflow seeds.

The single-seed +29% novel-mAP claim from round 4 needs variance bars:
given N finished `full_workflow_torch --tiny --seed S` roots, this
aggregates evalb/evalt (base-checkpoint vs tuned-checkpoint ensemble eval)
into a per-seed table and mean +- std for base/novel/all mAP, plus
per-class novel deltas to spot systematic regressions (e.g. round 4's bus
-0.216).

    python scripts/seed_stats_torch.py --roots /tmp/fsd_tiny_r4,/tmp/fsd_tiny_s13
"""

# The counterpart of scripts/seed_stats.py on the port's roots: the same
# markers, numpy statistics, rounding and SEEDSTATS line.

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load(root):
    out = {}
    for stage in ("evalb", "evalt"):
        with open(os.path.join(root, "state", f"{stage}.done")) as f:
            out[stage] = json.load(f)
    data = json.load(open(os.path.join(root, "state", "data.done")))
    out["seed"] = data.get("seed", "?")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", required=True,
                    help="comma-separated finished workflow roots")
    ap.add_argument("--novel-file", default=os.path.join(REPO, "data/voc_novels.txt"))
    ap.add_argument("--novelid", default="0")
    args = ap.parse_args()

    from fewshot_detection_tpu_torch.config.settings import get_novels

    novel = set(get_novels(args.novel_file, args.novelid))
    rows = []
    cls_deltas = {}
    for root in args.roots.split(","):
        r = load(root)
        b, t = r["evalb"], r["evalt"]
        rows.append({
            "root": root, "seed": r["seed"],
            "novel_b": b["novel_mean"], "novel_t": t["novel_mean"],
            "novel_delta": round(t["novel_mean"] - b["novel_mean"], 4),
            "base_b": b["base_mean"], "base_t": t["base_mean"],
            "mean_b": b["mean_ap"], "mean_t": t["mean_ap"],
        })
        for c in novel:
            d = t["aps"][c] - b["aps"][c]
            cls_deltas.setdefault(c, []).append(round(d, 4))

    def ms(key):
        v = np.array([r[key] for r in rows])
        return round(float(v.mean()), 4), round(float(v.std()), 4)

    summary = {
        "n_seeds": len(rows),
        "per_seed": rows,
        "novel_before": ms("novel_b"), "novel_after": ms("novel_t"),
        "novel_delta": ms("novel_delta"),
        "base_before": ms("base_b"), "base_after": ms("base_t"),
        "mean_before": ms("mean_b"), "mean_after": ms("mean_t"),
        "novel_class_deltas": cls_deltas,
        "positive_delta_seeds": sum(1 for r in rows if r["novel_delta"] > 0),
    }
    print("SEEDSTATS " + json.dumps(summary))


if __name__ == "__main__":
    main()
