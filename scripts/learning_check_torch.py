"""End-to-end learning smoke check on synthetic VOC-like data, on the
PyTorch port.

Drives the REAL pipeline at chosen scale — train_meta CLI driver ->
.weights checkpoints -> run_valid_ensemble sweep -> VOC07 mAP scoring — on
a generated dataset of class-colored rectangles (data/synth.py), so
learning (episodic meta-training, learnet class codes, decode, the scoring
protocol) is demonstrated on real hardware without the real VOC data this
container lacks. Mirrors the reference workflow README.md:84-152 (base
training -> evaluation) end to end.

Usage:
  python scripts/learning_check_torch.py [--full] [--images N] [--max-batches N]
                                         [--root DIR] [--device cpu]

--full uses the flagship cfg/darknet_dynamic.cfg + cfg/reweighting_net.cfg
at 416px; default uses the tiny test cfgs for a CPU-speed check. Prints one
JSON line with the mAP summary.
"""

# The counterpart of scripts/learning_check.py: the same argv, cfg patching
# (text for text), data options, prints and JSON line, with a --device
# (default cuda). Its initial weights are the port's numpy init of --seed,
# not jax.random's, so the two tools start from different weights.

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def patch_dk_cfg(src_dk, dk_cfg, max_batches, batch=None, warmup=None, steps=None):
    """The schedule length (and batch, warm-up, steps) patched into a copy
    of the darknet cfg; the shipped LR curve (warmup at 500) is kept."""
    txt = open(src_dk).read()
    txt = re.sub(r"max_batches\s*=\s*\d+", f"max_batches={max_batches}", txt)
    if batch:
        txt = re.sub(r"(?m)^batch\s*=\s*\d+", f"batch={batch}", txt)
    if warmup is not None:
        # shipped schedule: steps=-1,500,... — replace the warmup boundary
        txt = re.sub(r"(?m)^steps\s*=\s*-1,\s*\d+",
                     f"steps=-1,{warmup}", txt)
    if steps is not None:
        n = len(steps.split(","))
        txt = re.sub(r"(?m)^steps\s*=.*$", f"steps={steps}", txt)
        txt = re.sub(r"(?m)^scales\s*=[^\n]*$",
                     "scales=" + ",".join(["0.1", "10", ".1", ".1"][:n]), txt)
    open(dk_cfg, "w").write(txt)


def write_datacfg(datacfg, root, d, multiscale):
    with open(datacfg, "w") as f:
        # scale=0 for tiny probes: the multiscale schedule's hardcoded
        # 320-608 range (dataset.py:223-245) would train far above the tiny
        # cfg's 128px EVAL size; the flagship cfg evals at 416 inside the
        # range, the tiny one does not
        f.write(
            "metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
            "tuning=0\nrepeat=1\ndynamic=0\n"
            + ("" if multiscale else "scale=0\n")
            + f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
            f"meta={d['traindict']}\ntrain={d['train_list']}\n"
            f"valid={d['train_list']}\nbackup={root}/backup\ngpus=0\n"
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="flagship 416px cfgs (TPU-sized) instead of tiny")
    ap.add_argument("--images", type=int, default=None)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="override the cfg batch size")
    ap.add_argument("--warmup", type=int, default=None,
                    help="override the LR warmup length (first steps= entry)")
    ap.add_argument("--steps", default=None,
                    help="replace the whole steps= schedule (e.g. '-1,20' "
                    "to keep full LR after warmup; the shipped tiny cfg "
                    "decays x100 by batch 80, starving short probes)")
    ap.add_argument("--root", default=None,
                    help="workspace dir (default: a fresh tempdir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--style", default="color",
                    help="synthetic class style: color|shape|huebin")
    ap.add_argument("--multiscale", action="store_true",
                    help="keep the 320-608 multiscale schedule on for tiny "
                    "probes too (default: tiny probes pin scale=0)")
    ap.add_argument("--size", type=int, default=None,
                    help="source image size (square); default 64x48")
    ap.add_argument("--device", default="cuda",
                    help="the device the training and the sweep run on (default cuda)")
    args = ap.parse_args(argv)

    from fewshot_detection_tpu_torch.cli.common import resolve_configs
    from fewshot_detection_tpu_torch.cli.train_meta_cli import main as train_main
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.data.synth import make_voc_like
    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.eval.valid import run_valid_ensemble
    from fewshot_detection_tpu_torch.eval.voc_eval import do_python_eval
    from fewshot_detection_tpu_torch.models import weights_io
    from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
    from fewshot_detection_tpu_torch.models.spec import build_spec

    resolve_device(args.device)  # no card: refused before anything is written
    seconds = {}
    t0 = time.perf_counter()
    root = args.root or tempfile.mkdtemp(prefix="fsd_learn_")
    os.makedirs(root, exist_ok=True)
    n_images = args.images or (512 if args.full else 40)
    kw = {}
    if args.size:
        kw["size"] = (args.size, args.size)
        kw["box_range"] = (0.15, 0.45)
    d = make_voc_like(os.path.join(root, "voc"), n_images=n_images,
                      seed=args.seed, style=args.style, **kw)

    if args.full:
        src_dk = os.path.join(REPO, "cfg/darknet_dynamic.cfg")
        ln_cfg = os.path.join(REPO, "cfg/reweighting_net.cfg")
        max_batches = args.max_batches or 800
    else:
        src_dk = os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg")
        ln_cfg = os.path.join(REPO, "cfg/tiny_reweighting.cfg")
        max_batches = args.max_batches or 100

    dk_cfg = os.path.join(root, "dk.cfg")
    patch_dk_cfg(src_dk, dk_cfg, max_batches, args.batch, args.warmup, args.steps)
    datacfg = os.path.join(root, "meta.data")
    write_datacfg(datacfg, root, d, args.full or args.multiscale)

    spec = MetaSpec(build_spec(parse_cfg(dk_cfg)), build_spec(parse_cfg(ln_cfg)))
    params = init_meta_params(spec, args.seed)
    init_w = os.path.join(root, "init.weights")
    weights_io.save_weights(
        init_w, [spec.darknet, spec.learnet],
        [params["darknet"], params["learnet"]], seen=0,
    )
    seconds["data"] = time.perf_counter() - t0

    print(f"[learning_check] workspace {root}: {n_images} images, "
          f"{max_batches} batches of {parse_cfg(dk_cfg)[0]['batch']}")
    t0 = time.perf_counter()
    train_main(datacfg, dk_cfg, ln_cfg, init_w, device=args.device)
    seconds["train"] = time.perf_counter() - t0

    # the backup dir name encodes the config (cfg.py:130-147 mangling:
    # e.g. 'fix' when multiscale is off) — discover it
    cands = [d for d in os.listdir(root) if d.startswith("backup")]
    assert len(cands) == 1, cands
    backupdir = os.path.join(root, cands[0])
    ckpts = sorted(f for f in os.listdir(backupdir) if f.endswith(".weights"))
    assert ckpts, f"no checkpoints in {backupdir}"
    ckpt = os.path.join(backupdir, ckpts[-1])
    print(f"[learning_check] evaluating {ckpt}")

    cwd = os.getcwd()
    os.chdir(root)
    try:
        data_options, darknet, learnet, settings = resolve_configs(
            datacfg, dk_cfg, ln_cfg
        )
        t0 = time.perf_counter()
        prefix = run_valid_ensemble(data_options, darknet, learnet, ckpt,
                                    settings, device=args.device)
        seconds["sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = do_python_eval(
            prefix + "/comp4_det_test_",
            devkit_path=d["devkit"],
            novel=True,
            novel_file=os.path.join(REPO, "data/voc_novels.txt"),
            novelid="0",
        )
        seconds["score"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)

    out = {
        "metric": "synthetic_voc_map",
        "mean_ap": round(float(result["mean"]), 4),
        "base_mean": round(float(result.get("base_mean", 0.0)), 4),
        "novel_mean": round(float(result.get("novel_mean", 0.0)), 4),
        "images": n_images,
        "max_batches": max_batches,
        "full_scale": bool(args.full),
        "checkpoint": ckpt,
    }
    print(json.dumps(out))
    if not args.root:
        shutil.rmtree(root, ignore_errors=True)
    # what the caller may also want: the seconds of each part (not printed,
    # so the line stays the reference's)
    return {**out, "seconds": seconds}


if __name__ == "__main__":
    main()
