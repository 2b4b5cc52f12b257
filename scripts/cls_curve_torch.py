#!/usr/bin/env python3
"""Bucketed cls/GT learning curve from a train_meta log.

The per-step loss line (reference region_loss.py:315 format) carries the
classification loss summed over assigned anchors; cls/nGT against the
uniform-logits baseline ln(n_cls) is the schedule-progress signal PERF.md
tracks for the flagship runs. This buckets it per --bucket samples so the
curve across a (possibly multi-round, checkpoint-resumed) schedule is one
table.

Usage:
    python scripts/cls_curve_torch.py /tmp/fsd_flagship/logs/base.log \
        [--bucket 10000] [--n-cls 15]
"""

# The counterpart of scripts/cls_curve.py for the logs the PyTorch port
# writes (utils/logging.py:format_loss_line): the same pattern, table and
# arguments. It reads the log on the host only.

import argparse
import math
import re

# every line of utils/logging.py:format_loss_line with a finite class loss
LOSS_LINE = re.compile(r"^(\d+): nGT (\d+),.* cls ([0-9.]+),")


def curve(logfile, bucket=10000, n_cls=15):
    # a resumed run's log restarts at the checkpoint's seen counter; key
    # buckets on the seen value itself so restarts merge into one curve
    acc = {}
    for line in open(logfile):
        m = LOSS_LINE.match(line)
        if not m:
            continue
        seen, ngt, cls = int(m.group(1)), int(m.group(2)), float(m.group(3))
        b = seen // bucket
        acc.setdefault(b, []).append(cls / max(ngt, 1))
    rows = [(b * bucket, (b + 1) * bucket, sum(v) / len(v), len(v))
            for b, v in sorted(acc.items())]
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("logfile")
    ap.add_argument("--bucket", type=int, default=10000)
    ap.add_argument("--n-cls", type=int, default=15)
    args = ap.parse_args()
    rows = curve(args.logfile, args.bucket, args.n_cls)
    base = math.log(args.n_cls)
    print(f"ln({args.n_cls}) = {base:.4f} (uniform-logits baseline)")
    print("samples      cls/GT   lines")
    for lo, hi, v, n in rows:
        marker = " <- below uniform" if v < base else ""
        print(f"{lo:>7}-{hi:<7} {v:7.4f} {n:>6}{marker}")


if __name__ == "__main__":
    main()
