#!/usr/bin/env python3
"""k-shot sweep: tune + evaluate a completed tiny workflow root at several
shot counts, on the PyTorch port.

The reference protocol's core result is mAP vs k over the frozen
box_{1,2,3,5,10}shot splits (reference scripts/gen_fewlist.py:53-103,
README.md:131-152). This driver reproduces that axis in miniature: from ONE
base checkpoint (a finished `full_workflow_torch --tiny` root), it builds a
box-budgeted k-shot dict per k, runs the dynamic few-shot tune
(train_meta_cli, tuning=1 dynamic=1), sweeps the tuned checkpoint with
run_valid_ensemble, and scores VOC07 AP — reporting novel/base mAP vs k.

Each k gets its own subdir <root>/shot<k>/ (tune backup + results), so the
sweep is resumable per k. The counterpart of scripts/shot_sweep.py, with the
same argv, prints and SHOTSWEEP line and a --device (default cuda). Where
that script runs train_meta.py as a subprocess, this one tunes in process
as cli/workflow.py's tune stage does: the newest checkpoint of the k's
backup directory, else the base checkpoint, into train_meta_cli.main under
the workflow's stage environment, its output in <root>/logs/tune_shot<k>.log.

Usage:
    python scripts/shot_sweep_torch.py --root /tmp/fsd_tiny [--shots 1,2,3,5,10] [--device cpu]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fewshot_detection_tpu_torch.cli import workflow as wf  # noqa: E402

# what scripts/shot_sweep.py sets on the workflow for a tiny root: the cfgs
# the root trained, and a tuning schedule of its own (tiny's 128 px cfg is
# below the 320-608 multi-scale range)
TINY_OVERRIDES = {"TINY": True, "DK_SRC": "cfg/tiny_darknet_dynamic.cfg",
                  "LN_SRC": "cfg/tiny_reweighting.cfg", "TUNE_SCALE": 0,
                  "TUNE_MAX_EPOCH": 10, "TUNE_REPEAT": 20}


def build_fewdict(root, kdir, shot):
    """Box-budgeted k-shot lists + dict file for `shot` (stage_few logic,
    parameterized by k; dict filename carries the shot count — settings
    parses it back out of the `meta` option). Written under the per-k dir
    so the sweep never clobbers the root's canonical stage_few lists."""
    from fewshot_detection_tpu_torch.data.prep import VOC_CLASSES, get_bbox_fewlist

    voclist = os.path.join(kdir, "voclist")
    os.makedirs(voclist, exist_ok=True)
    lists = wf._fewlists_full_budget(
        lambda seed: get_bbox_fewlist(
            os.path.join(root, "voc", "train_split.txt"), shot, VOC_CLASSES,
            seed=seed),
        VOC_CLASSES, shot)
    fewdict = os.path.join(kdir, f"voc_traindict_bbox_{shot}shot.txt")
    with open(fewdict, "w") as df:
        for cname, flist in zip(VOC_CLASSES, lists):
            out = os.path.join(voclist, f"box_{shot}shot_{cname}_train.txt")
            with open(out, "w") as f:
                f.writelines(flist)
            df.write(f"{cname} {out}\n")
    return fewdict


def tune_and_eval(root, shot):
    """One k: tune from the base checkpoint, ensemble-eval the tuned one."""
    from fewshot_detection_tpu_torch.cli import train_meta_cli

    kdir = os.path.join(root, f"shot{shot}")
    os.makedirs(kdir, exist_ok=True)
    marker = os.path.join(kdir, "result.json")
    if os.path.exists(marker):
        res = json.load(open(marker))
        wf.log(f"shot{shot}: already done ({res['novel_mean']})")
        return res

    base_ckpt = json.load(open(wf.done_marker(root, "base")))["ckpt"]
    fewdict = build_fewdict(root, kdir, shot)
    tune_data = os.path.join(kdir, "tune.data")
    with open(tune_data, "w") as f:
        f.write(
            "metayolo=1\nmetain_type=2\ndata=voc\nneg=0\nrand=0\n"
            f"tuning=1\nmax_epoch={wf.TUNE_MAX_EPOCH}\n"
            f"repeat={wf.TUNE_REPEAT}\n"
            f"dynamic=1\nscale={wf.TUNE_SCALE}\n"
            f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
            f"meta={fewdict}\ntrain={root}/voc/train_split.txt\n"
            f"valid={root}/voc/test_split.txt\nbackup={kdir}/backup_tune\n"
            "gpus=0\n"
        )
    bdir = wf.tune_backup_dir(kdir)
    init_w = wf.resume_from(bdir, base_ckpt)
    with wf.stage_context(root, f"tune_shot{shot}", wf.STAGE_ENV):
        train_meta_cli.main(tune_data, os.path.join(root, "dk.cfg"),
                            os.path.join(REPO, wf.LN_SRC), init_w, device=wf.DEVICE)
    ckpt = wf.latest_weights(bdir) if os.path.isdir(bdir) else None
    assert ckpt, f"shot{shot} tuning failed"

    res = wf._eval(root, f"shot{shot}", tune_data, ckpt)
    res["shot"] = shot
    with open(marker, "w") as f:
        json.dump(res, f)
    wf.log(f"shot{shot}: novel {res['novel_mean']} base {res['base_mean']} "
           f"mean {res['mean_ap']}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="a COMPLETED full_workflow --tiny root")
    ap.add_argument("--shots", default="1,2,3,5,10")
    ap.add_argument("--device", default="cuda",
                    help="the device the tuning and the sweeps run on (default cuda)")
    args = ap.parse_args(argv)

    from fewshot_detection_tpu_torch.eval.detector import resolve_device

    # adopt the root's mode knobs (tiny): same cfgs/scales the root trained;
    # the workflow's settings are put back afterwards
    mode = wf.recorded_mode(args.root)
    assert mode == "tiny", f"shot_sweep expects a tiny root, got {mode!r}"
    saved = {k: getattr(wf, k) for k in wf.DEFAULTS}
    vars(wf).update(wf.DEFAULTS)
    vars(wf).update(TINY_OVERRIDES, DEVICE=args.device)
    try:
        assert wf.is_done(args.root, "base"), "root has no finished base stage"
        resolve_device(args.device)  # no card: refused before anything is written

        shots = [int(s) for s in args.shots.split(",")]
        rows = []
        for k in shots:
            rows.append(tune_and_eval(args.root, k))
    finally:
        vars(wf).update(saved)
    evalb = (json.load(open(wf.done_marker(args.root, "evalb")))
             if wf.is_done(args.root, "evalb") else None)
    table = {
        "root": args.root,
        "base_checkpoint_novel": evalb["novel_mean"] if evalb else None,
        "per_shot": [
            {"shot": r["shot"], "novel": r["novel_mean"],
             "base": r["base_mean"], "mean": r["mean_ap"]} for r in rows
        ],
    }
    print("SHOTSWEEP " + json.dumps(table))
    return table


if __name__ == "__main__":
    main()
