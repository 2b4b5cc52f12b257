#!/usr/bin/env python3
"""`calibrate_yolo3.py`'s readings for a cell whose mix's driver is
`train_yolo4`.

    python3 benchmark/calibrate_yolo4.py --workload yolov4_coco.train_v4_b64_608 \
        --seeds a,b,... [--controls c,d,e] [--dtype float32] [--lr-scale s] \
        [--look] [--dump DIR]

The same arguments, lines and `CALIBRATION {...}` summary as
`calibrate_yolo3.py`: the program's compared numbers against the plain
reference for each seed of `--seeds` (the lower readings), and for each
seed of `--controls` the reference at the precision below the
configuration's (bfloat16: int8 and fp8) and with half of each batch left
out (the upper readings). `calibrate_yolo3.py` reads its driver's
`Program`, `make_pool`, `reference_steps`, `numbers` and `own_leaf_gap` as
`benchmark.drivers.train_yolo3`; for the run, that name points at
`train_yolo4`, whose program and reference are YOLOv4's, and is put back
afterwards. The benchmark's own runs never run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None, root=None) -> int:
    root = root or ROOT
    if root not in sys.path:
        sys.path.insert(0, root)
    import benchmark.drivers as drivers
    from benchmark import calibrate_yolo3
    from benchmark.drivers import train_yolo3, train_yolo4

    drivers.train_yolo3 = train_yolo4
    try:
        return calibrate_yolo3.main(argv, device=device, root=root)
    finally:
        drivers.train_yolo3 = train_yolo3


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
