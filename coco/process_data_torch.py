#!/usr/bin/env python3
"""COCO few-shot data preparation on the PyTorch port's `data/coco_prep.py`
(the counterpart of coco/process_data.py: same argv, tasks, files and
prints).

    python coco/process_data_torch.py --task fewlist --root .../cocolist \
        --train-dir .../images/train2014 --shots 10 30
    python coco/process_data_torch.py --task fewlist-full --train-file trainvalno5k.txt
    python coco/process_data_torch.py --task validlists --valid-dir .../images/val2014
    python coco/process_data_torch.py --task label1c --train-dir .../images/train2014
    python coco/process_data_torch.py --task traindict --train-dir ... [--trainval-file ...]
"""

import argparse
import os
import sys
from os import path

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))

from fewshot_detection_tpu_torch.config.settings import load_class_names  # noqa: E402
from fewshot_detection_tpu_torch.data import coco_prep  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True,
                   choices=["fewlist", "fewlist-full", "validlists",
                            "label1c", "traindict", "trainvaldict"])
    p.add_argument("--root", default="cocolist", help="output list dir")
    p.add_argument("--train-dir", default="images/train2014")
    p.add_argument("--valid-dir", default="images/val2014")
    p.add_argument("--train-file", default="trainvalno5k.txt")
    p.add_argument("--shots", type=int, nargs="+", default=[10, 30])
    args = p.parse_args()

    classes = list(load_class_names("coco"))
    voc = list(load_class_names("voc"))
    os.makedirs(args.root, exist_ok=True)

    if args.task == "fewlist":
        for novel in coco_prep.load_coco_novels():
            tgt = voc + novel
            for n in args.shots:
                print(f"===> nov{len(novel)} {n}-shot ...")
                lists = coco_prep.get_bbox_fewlist(args.train_dir, n, tgt, classes)
                for i, cname in enumerate(tgt):
                    fname = path.join(args.root, f"nov{len(novel)}_box_{n}shot_{cname}_train.txt")
                    with open(fname, "w") as f:
                        f.writelines(lists[i])
    elif args.task == "fewlist-full":
        for n in args.shots:
            print(f"===> full-coco {n}-shot ...")
            lists = coco_prep.get_bbox_fewlist_v2(args.train_file, n, classes, classes)
            for i, cname in enumerate(classes):
                fname = path.join(args.root, f"full_box_{n}shot_{cname}_trainval.txt")
                print(f"{cname} {fname}")
                with open(fname, "w") as f:
                    f.writelines(lists[i])
    elif args.task == "validlists":
        coco_prep.gen_valid_lists(args.root, args.valid_dir)
    elif args.task == "label1c":
        names = sorted(os.listdir(args.train_dir))
        imgs = [path.join(args.train_dir, n) for n in names]
        coco_prep.gen_label1c(imgs, classes)
    elif args.task == "traindict":
        coco_prep.gen_traindict(args.train_dir, args.root, "train", classes)
    elif args.task == "trainvaldict":
        coco_prep.gen_traindict(args.train_file, args.root, "trainval", classes)


if __name__ == "__main__":
    main()
