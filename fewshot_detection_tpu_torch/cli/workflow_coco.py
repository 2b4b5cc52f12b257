"""The paper's COCO protocol on synthetic data, end to end on the port.

The counterpart of the JAX package's `scripts/full_workflow_coco.py`: the
60-base / 20-novel recipe (novel split 2 of data/coco_novels.txt) on an
80-class COCO-layout tree, with its stages, constants, `.done` markers and
final `WORKFLOW {...}` line:

    data   -> synthetic COCO (`data/synth.py:make_coco_rich`, 80 distinct
              identities; images/train2014 + labels_1c/train2014/<class>/),
              the 80-class 425-filter plain head, random initial weights
    plain  -> train_plain_cli.main   (80-class YOLOv2 from random init)
    part   -> cli/partial.partial    (backbone extraction, conv 23)
    base   -> train_meta_cli.main    (60-way episodic base training)
    few    -> data/coco_prep.get_bbox_fewlist, 10-shot lists topped up from
              the per-class pools of the train split
    tune   -> train_meta_cli.main    (80-way few-shot tuning, dynamic fewset)
    evalb  -> run_valid_ensemble + AP over the 60 base classes (BASE ckpt)
    evalt  -> run_valid_ensemble + AP over all 80, base and novel means
              (TUNED checkpoint)

The stages run in this process on `--device` (default "cuda"; the CPU only
when asked), under `cli/workflow.py`'s STAGE_ENV and `stage_context`, as the
VOC workflow's do. The depth is the module's constants; no flag sets it.

Usage:
    python scripts/full_workflow_coco_torch.py [--root DIR] [--stage STAGE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from .workflow import (
    EVAL_ENV,
    REPO,
    STAGE_ENV,
    _fewlists_full_budget,
    cls_loss_summary,
    is_done,
    latest_weights,
    log,
    mark_done,
    patch_cfg,
    read_done,
    resume_from,
    score_split_only,
    stage_context,
    write_split_pools,
)

N_TRAIN = 1200
N_TEST = 80
IMG_SIZE = (256, 256)
SHOT = 10
PLAIN_BATCHES = 900
BASE_BATCHES = 320
DK_STEPS = "-1,200,40000,60000"
DK_BATCH = 32
# two tuning epochs' worth over a 2x10-shot dynamic fewset; COCO saves
# every 2 epochs, so the epoch count stays even for the last save to fire
TUNE_MAX_EPOCH = 4
TUNE_REPEAT = 2
SEED = 11  # synthetic data and weight init
# the few-shot sampler's seeds: the VOC workflow's defaults (seed 7), which
# the JAX script's shared helper takes
FEWLIST_SEEDS = (2018 + 7, 7, 99 + 7, 1234 + 7, 4242 + 7)
NOVELID = 2
N_BASE, N_ALL = 60, 80
LN_SRC = "cfg/reweighting_net.cfg"
DEVICE = "cuda"


def plain_backup_dir(root):
    return os.path.join(root, f"backup_plain_novel{NOVELID}")


def base_backup_dir(root):
    return os.path.join(root, f"backup_novel{NOVELID}_neg1")


def tune_backup_dir(root):
    return os.path.join(root, f"backup_tune_novel{NOVELID}_neg0")


def novel_file():
    return os.path.join(REPO, "data", "coco_novels.txt")


def stage_data(root):
    from ..config import parse_cfg
    from ..data.synth import make_coco_rich
    from ..models import weights_io
    from ..models.darknet import init_params
    from ..models.meta import MetaSpec, init_meta_params
    from ..models.spec import build_spec

    coco = os.path.join(root, "coco")
    d = make_coco_rich(coco, n_images=N_TRAIN + N_TEST, size=IMG_SIZE, seed=SEED)
    img_paths = d["img_paths"]
    train_imgs, test_imgs = img_paths[:N_TRAIN], img_paths[N_TRAIN:]
    train_list = os.path.join(coco, "train_split.txt")
    test_list = os.path.join(coco, "test_split.txt")
    for path, imgs in ((train_list, train_imgs), (test_list, test_imgs)):
        with open(path, "w") as f:
            f.write("\n".join(imgs) + "\n")

    score_split_only(d["devkit"], test_imgs)
    traindict = os.path.join(coco, "traindict_trainsplit.txt")
    write_split_pools(d["cls_lists"], train_imgs, os.path.join(coco, "cocolist"), traindict)

    with open(os.path.join(root, "plain.data"), "w") as f:
        f.write("metayolo=0\ndata=coco\nneg=0\nrand=0\n"
                f"novel={novel_file()}\nnovelid={NOVELID}\n"
                f"train={train_list}\nvalid={test_list}\n"
                f"names={REPO}/data/coco.names\nbackup={root}/backup_plain\ngpus=0\n")
    with open(os.path.join(root, "base.data"), "w") as f:
        f.write("metayolo=1\nmetain_type=2\ndata=coco\nneg=1\nrand=0\n"
                "tuning=0\nrepeat=1\ndynamic=0\n"
                f"novel={novel_file()}\nnovelid={NOVELID}\n"
                f"meta={traindict}\ntrain={train_list}\nvalid={test_list}\n"
                f"backup={root}/backup\ngpus=0\n")
    # the 80-class plain head: 5 * (5 + 80) = 425 filters
    with open(os.path.join(REPO, "cfg", "yolo-voc.cfg")) as f:
        txt = f.read().replace("filters=125", "filters=425").replace("classes=20", "classes=80")
    plain_cfg = os.path.join(root, "plain.cfg")
    with open(plain_cfg, "w") as f:
        f.write(txt)
    patch_cfg(plain_cfg, plain_cfg, max_batches=PLAIN_BATCHES, batch=DK_BATCH)
    patch_cfg(os.path.join(REPO, "cfg", "darknet_dynamic.cfg"), os.path.join(root, "dk.cfg"),
              max_batches=BASE_BATCHES, batch=DK_BATCH, steps=DK_STEPS)

    pspec = build_spec(parse_cfg(plain_cfg))
    weights_io.save_weights(os.path.join(root, "plain_init.weights"), [pspec],
                            [init_params(pspec, SEED)], seen=0)
    mspec = MetaSpec(build_spec(parse_cfg(os.path.join(root, "dk.cfg"))),
                     build_spec(parse_cfg(os.path.join(REPO, LN_SRC))))
    mp = init_meta_params(mspec, SEED)
    weights_io.save_weights(os.path.join(root, "meta_init.weights"),
                            [mspec.darknet, mspec.learnet], [mp["darknet"], mp["learnet"]],
                            seen=0)
    mark_done(root, "data", {"train": N_TRAIN, "test": N_TEST})
    log("data stage done")


def stage_plain(root):
    from . import train_plain_cli

    bdir = plain_backup_dir(root)
    init_w = resume_from(bdir, os.path.join(root, "plain_init.weights"))
    with stage_context(root, "plain", STAGE_ENV):
        train_plain_cli.main(os.path.join(root, "plain.data"), os.path.join(root, "plain.cfg"),
                             init_w, device=DEVICE)
    ckpt = latest_weights(bdir)
    if not ckpt:
        raise RuntimeError(f"plain training wrote no checkpoint under {bdir}")
    mark_done(root, "plain", {"ckpt": ckpt})


def stage_part(root):
    from .partial import partial

    ckpt = latest_weights(plain_backup_dir(root))
    out = os.path.join(root, "conv23.weights")
    partial(os.path.join(root, "plain.cfg"), ckpt, out, 23)
    mark_done(root, "part", {"out": out})


def stage_base(root):
    from . import train_meta_cli

    bdir = base_backup_dir(root)
    init_w = resume_from(bdir, os.path.join(root, "conv23.weights"))
    with stage_context(root, "base", STAGE_ENV):
        train_meta_cli.main(os.path.join(root, "base.data"), os.path.join(root, "dk.cfg"),
                            os.path.join(REPO, LN_SRC), init_w, device=DEVICE)
    ckpt = latest_weights(bdir)
    if not ckpt:
        raise RuntimeError(f"base meta training wrote no checkpoint under {bdir}")
    summary = cls_loss_summary(os.path.join(root, "logs", "base.log"), n_cls=N_BASE)
    mark_done(root, "base", {"ckpt": ckpt, "cls": summary})
    log(f"base stage done: {summary}")


def stage_few(root):
    from ..data.coco_prep import get_bbox_fewlist
    from ..data.lists import parse_dict_file
    from ..data.synth import load_coco_names

    names = load_coco_names()
    coco = os.path.join(root, "coco")
    cocolist = os.path.join(coco, "cocolist")
    # per-class candidate pools (train split only) for a short class's top-up
    pools = {}
    for cls, path in parse_dict_file(os.path.join(coco, "traindict_trainsplit.txt")):
        with open(path) as f:
            pools[cls] = f.read().splitlines()
    lists = _fewlists_full_budget(
        lambda seed: get_bbox_fewlist(os.path.join(coco, "train_split.txt"), SHOT, names,
                                      seed=seed),
        names, SHOT, seeds=FEWLIST_SEEDS, class_pools=pools)
    fewdict = os.path.join(coco, f"coco_traindict_bbox_{SHOT}shot.txt")
    with open(fewdict, "w") as df:
        for cname, flist in zip(names, lists):
            out = os.path.join(cocolist, f"box_{SHOT}shot_{cname.replace(' ', '_')}_train.txt")
            with open(out, "w") as f:
                f.writelines(flist)
            df.write(f"{cname} {out}\n")
    with open(os.path.join(root, "tune.data"), "w") as f:
        f.write("metayolo=1\nmetain_type=2\ndata=coco\nneg=0\nrand=0\n"
                f"tuning=1\nmax_epoch={TUNE_MAX_EPOCH}\nrepeat={TUNE_REPEAT}\n"
                "dynamic=1\nscale=1\n"
                f"novel={novel_file()}\nnovelid={NOVELID}\n"
                f"meta={fewdict}\ntrain={root}/coco/train_split.txt\n"
                f"valid={root}/coco/test_split.txt\nbackup={root}/backup_tune\ngpus=0\n")
    mark_done(root, "few", {"dict": fewdict})


def stage_tune(root):
    from . import train_meta_cli

    bdir = tune_backup_dir(root)
    init_w = resume_from(bdir, read_done(root, "base")["ckpt"])
    with stage_context(root, "tune", STAGE_ENV):
        train_meta_cli.main(os.path.join(root, "tune.data"), os.path.join(root, "dk.cfg"),
                            os.path.join(REPO, LN_SRC), init_w, device=DEVICE)
    ckpt = latest_weights(bdir)
    if not ckpt:
        raise RuntimeError(f"tuning wrote no checkpoint under {bdir}")
    summary = cls_loss_summary(os.path.join(root, "logs", "tune.log"), n_cls=N_ALL)
    mark_done(root, "tune", {"ckpt": ckpt, "cls": summary})
    log(f"tune stage done: {summary}")


def _eval(root, name, datacfg, ckpt, base_only):
    """The ensemble sweep of `ckpt` and VOC07 AP over the COCO names:
    base_only scores the 60 base classes (all the base model knows)."""
    from ..cli.common import resolve_configs
    from ..config.settings import get_novels
    from ..data.synth import load_coco_names
    from ..eval.valid import run_valid_ensemble
    from ..eval.voc_eval import do_python_eval

    with stage_context(root, f"eval_{name}", {**STAGE_ENV, **EVAL_ENV}):
        data_options, dk, ln, settings = resolve_configs(
            datacfg, os.path.join(root, "dk.cfg"), os.path.join(REPO, LN_SRC))
        prefix = run_valid_ensemble(data_options, dk, ln, ckpt, settings, device=DEVICE)
        names = load_coco_names()
        if base_only:
            novels = set(get_novels(novel_file(), str(NOVELID)))
            classes = tuple(n for n in names if n not in novels)
        else:
            classes = tuple(names)
        result = do_python_eval(
            prefix + "/comp4_det_test_", devkit_path=os.path.join(root, "coco", "VOCdevkit"),
            novel=True, novel_file=novel_file(), novelid=str(NOVELID), classes=classes)
        out = {
            "stage": name,
            "mean_ap": round(float(result["mean"]), 4),
            "base_mean": round(float(result.get("base_mean", 0.0)), 4),
            "novel_mean": round(float(result.get("novel_mean", 0.0)), 4),
            "n_classes": len(classes),
            "aps": {c: round(float(a), 4) for c, a in result["ap"].items()},
            "checkpoint": ckpt,
        }
        print("EVALJSON " + json.dumps(out))
    return out


def stage_evalb(root):
    res = _eval(root, "base", os.path.join(root, "base.data"), read_done(root, "base")["ckpt"],
                base_only=True)
    mark_done(root, "evalb", res)
    log(f"base eval: {res}")


def stage_evalt(root):
    res = _eval(root, "tune", os.path.join(root, "tune.data"), read_done(root, "tune")["ckpt"],
                base_only=False)
    mark_done(root, "evalt", res)
    log(f"tuned eval: {res}")


STAGES = [
    ("data", stage_data), ("plain", stage_plain), ("part", stage_part),
    ("base", stage_base), ("few", stage_few), ("tune", stage_tune),
    ("evalb", stage_evalb), ("evalt", stage_evalt),
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="The paper's COCO protocol on the port.")
    ap.add_argument("--root", default=None,
                    help="workflow root (default: fsd_coco under the system's temporary "
                    "directory)")
    ap.add_argument("--stage", default=None, help="run only this stage (default: all remaining)")
    ap.add_argument("--device", default="cuda",
                    help="the device the stages train and sweep on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    global DEVICE
    args = parse_args(argv)
    DEVICE = args.device
    if args.root is None:
        import tempfile

        args.root = os.path.join(tempfile.gettempdir(), "fsd_coco")
    os.makedirs(args.root, exist_ok=True)
    for name, fn in STAGES:
        if args.stage and name != args.stage:
            continue
        if is_done(args.root, name) and not args.stage:
            log(f"{name}: already done, skipping")
            continue
        log(f"=== stage {name} ===")
        fn(args.root)
    summary = {name: read_done(args.root, name) for name, _ in STAGES
               if is_done(args.root, name)}
    print("WORKFLOW " + json.dumps(summary), flush=True)
    return summary
