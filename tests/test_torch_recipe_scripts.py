"""The port's data-recipe command lines against the JAX package's, on the CPU.

Each pair (`scripts/voc_label_torch.py` and `scripts/voc_label.py`,
`voc_label_1c`, `gen_fewlist`, `convert_fewlist`, `gen_traindict`,
`voc_eval`, and `coco/process_data_torch.py` with each of its six tasks
beside `coco/process_data.py`) runs with the same argv on the same tree,
painted by the port's `data/synth.py`; every file it writes must be
BYTE-IDENTICAL, and what it prints equal. Each script runs in this process
as `__main__` (`runpy`), one after the other, the tree put back between."""

import os
import runpy
import shutil
import sys

import numpy as np
import pytest

from fewshot_detection_tpu.data import prep as j_prep
from fewshot_detection_tpu_torch.data import synth as tsynth

from torch_port_util import REPO, same_outputs

PAIRS = {
    "voc_label": ("scripts/voc_label_torch.py", "scripts/voc_label.py"),
    "voc_label_1c": ("scripts/voc_label_1c_torch.py", "scripts/voc_label_1c.py"),
    "gen_fewlist": ("scripts/gen_fewlist_torch.py", "scripts/gen_fewlist.py"),
    "convert_fewlist": ("scripts/convert_fewlist_torch.py", "scripts/convert_fewlist.py"),
    "gen_traindict": ("scripts/gen_traindict_torch.py", "scripts/gen_traindict.py"),
    "voc_eval": ("scripts/voc_eval_torch.py", "scripts/voc_eval.py"),
    "process_data": ("coco/process_data_torch.py", "coco/process_data.py"),
}


def _run(script, argv):
    """The script as `__main__` with `argv`: None, SystemExit's code, or
    the assertion it failed (the reference's samplers assert)."""
    old = sys.argv
    sys.argv = [script, *argv]
    try:
        runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    except SystemExit as e:
        return e.code
    except AssertionError as e:
        return f"AssertionError: {e}"
    finally:
        sys.argv = old
    return None


def _same(name, argv, roots):
    port, jax_script = PAIRS[name]
    return same_outputs(roots, lambda: _run(port, argv), lambda: _run(jax_script, argv))


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A painted VOC devkit, and the JAX package's labels, labels_1c and
    lists under it for the steps that read them."""
    root = str(tmp_path_factory.mktemp("recipe_voc"))
    d = tsynth.make_voc_like(os.path.join(root, "voc"), n_images=40, seed=1)
    droot = os.path.join(root, "droot")
    os.makedirs(droot)
    lists = j_prep.write_voc_labels(d["devkit"], droot)
    j_prep.write_voc_labels_1c(d["devkit"], os.path.join(droot, "voclist"))
    with open(os.path.join(droot, "voc_train.txt"), "w") as f:
        for lst in lists:
            if not lst.endswith("test.txt"):
                with open(lst) as src:
                    f.write(src.read())
    return {"root": root, "devkit": d["devkit"], "droot": droot,
            "voclist": os.path.join(droot, "voclist")}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_usage_is_the_same(name, capsys):
    port, jax_script = PAIRS[name]
    assert _run(port, ["--help"]) == 0
    got = capsys.readouterr().out
    assert _run(jax_script, ["--help"]) == 0
    want = capsys.readouterr().out
    assert want.startswith(f"usage: {os.path.basename(jax_script)} ")
    # the same options and help; argparse wraps the lines by the name's length
    assert got.split() == want.replace(os.path.basename(jax_script),
                                       os.path.basename(port), 1).split()


def test_voc_label(voc, tmp_path):
    out = str(tmp_path / "out")
    os.makedirs(out)
    got = _same("voc_label", ["--devkit", voc["devkit"], "--out", out], [voc["devkit"], out])
    assert "WARNING: skipping missing set 2012/train" in got[1]
    assert sum(p.startswith(out) for p in got[0]) == 3  # 2007 train, val, test


def test_voc_label_1c(voc, tmp_path):
    vl = str(tmp_path / "vl")
    got = _same("voc_label_1c", ["--devkit", voc["devkit"], "--voclist", vl],
                [voc["devkit"], str(tmp_path)])
    assert sum(p.endswith("_train.txt") and "/vl/" in p for p in got[0]) >= 20
    assert "wrote labels_1c dirs" in got[1]


@pytest.mark.parametrize("kind", ["box", "img", "both"])
def test_gen_fewlist(voc, kind):
    got = _same("gen_fewlist", ["--droot", voc["droot"], "--type", kind], [voc["voclist"]])
    per_kind = 20 * 5  # 20 classes x shots 1, 2, 3, 5, 10
    assert len(got[0]) == per_kind * (2 if kind == "both" else 1)


def test_convert_fewlist(tmp_path, monkeypatch):
    """It reads data/vocsplit and rewrites data/voc_traindict_*.txt relative
    to the working directory: run from a copy of those files."""
    work = tmp_path / "work"
    (work / "data").mkdir(parents=True)
    shutil.copytree(os.path.join(REPO, "data", "vocsplit"), work / "data" / "vocsplit")
    for n in ("voc_traindict_full.txt", "voc_traindict_bbox_1shot.txt",
              "voc_traindict_bbox_5shot.txt"):
        shutil.copy(os.path.join(REPO, "data", n), work / "data" / n)
    monkeypatch.chdir(work)
    got = _same("convert_fewlist", ["--droot", str(tmp_path / "voc") + "/"], [str(tmp_path)])
    assert any(p.endswith("voc_traindict_full.txt") for p in got[0]) and len(got[0]) > 100
    assert got[1] == "===> Converting few-shot name lists..\n===> Finished!\n"


def test_gen_traindict(voc, tmp_path):
    got = _same("gen_traindict", ["--voclist", voc["voclist"], "--data", str(tmp_path / "d"),
                                  "--cfg", str(tmp_path / "c")], [str(tmp_path)])
    assert len(got[0]) == 2 * 2 * 5  # dicts and .data cfgs, mix and few, 5 shots


def _results(devkit, prefix, seed):
    """comp4 result files near the devkit's boxes, with misses and strays."""
    import xml.etree.ElementTree as ET

    rng = np.random.RandomState(seed)
    main = os.path.join(devkit, "VOC2007", "ImageSets", "Main", "test.txt")
    rows = {c: [] for c in tsynth.VOC}
    with open(main) as f:
        ids = f.read().split()
    for imgid in ids:
        tree = ET.parse(os.path.join(devkit, "VOC2007", "Annotations", imgid + ".xml"))
        for obj in tree.findall("object"):
            box = np.array([float(obj.find("bndbox").find(k).text)
                            for k in ("xmin", "ymin", "xmax", "ymax")])
            if rng.rand() < 0.8:
                box = box + rng.randn(4) * 2
                rows[obj.find("name").text].append((imgid, rng.rand(), *box))
            stray = rng.choice(tsynth.VOC)
            rows[stray].append((imgid, rng.rand() * 0.5, *(rng.rand(4) * 30)))
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    for c, lines in rows.items():
        with open(f"{prefix}{c}.txt", "w") as f:
            for r in lines:
                f.write("%s %.6f %.1f %.1f %.1f %.1f\n" % r)


@pytest.mark.parametrize("extra", [[], ["--single"]])
def test_voc_eval(voc, tmp_path, monkeypatch, extra):
    prefix = str(tmp_path / "results" / "comp4_det_test_")
    _results(voc["devkit"], prefix, seed=len(extra))
    monkeypatch.chdir(tmp_path)  # output/ is written here
    got = _same("voc_eval", [prefix, "--devkit", os.path.join(voc["root"], "voc", "VOCdevkit"),
                             *extra], [voc["devkit"], str(tmp_path)])
    assert sum(p.endswith("_pr.pkl") for p in got[0]) == 20
    assert "Mean AP = " in got[1]
    aps = [float(ln.split("=")[1]) for ln in got[1].splitlines() if ln.startswith("AP for")]
    assert len(aps) == 20 and 0 < np.mean(aps) < 1


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A painted COCO tree, one box an image, two images a class."""
    root = str(tmp_path_factory.mktemp("recipe_coco"))
    d = tsynth.make_coco_rich(os.path.join(root, "coco"), n_images=160, size=(16, 16), seed=3,
                              classes_per_image=1)
    return {"root": root, "tree": d["root"], "train_list": d["train_list"],
            "img_dir": os.path.dirname(d["img_paths"][0])}


TASKS = {
    "fewlist": lambda c, out: ["--root", out, "--train-dir", c["img_dir"], "--shots", "1", "2"],
    "fewlist-full": lambda c, out: ["--root", out, "--train-file", c["train_list"],
                                    "--shots", "1", "2"],
    "validlists": lambda c, out: ["--root", out, "--valid-dir", c["img_dir"]],
    "label1c": lambda c, out: ["--root", out, "--train-dir", c["img_dir"]],
    "traindict": lambda c, out: ["--root", out, "--train-dir", c["img_dir"]],
    "trainvaldict": lambda c, out: ["--root", out, "--train-file", c["train_list"]],
}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_process_data(coco, tmp_path, monkeypatch, task):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "cocolist")
    got = _same("process_data", ["--task", task, *TASKS[task](coco, out)], [coco["tree"], out])
    wrote = {os.path.relpath(p, coco["root"]).split(os.sep)[1] for p in got[0]
             if p.startswith(coco["tree"])}
    if task == "label1c":  # rewrites labels_1c/train2014/<class>/ in place
        assert wrote == {"labels_1c"} and len(got[0]) == 160
    else:
        assert not wrote and all(p.startswith(out) for p in got[0])
    if task == "fewlist":
        # the last split's 20 novel classes are VOC's: `voc + novel` names
        # each twice, its second copies never fill, and both samplers give
        # up there, after the lists of the first three splits
        assert got[2].startswith("AssertionError: No enough data")
        assert len(got[0]) == sum(2 * (20 + n) for n in (5, 10, 20))
    else:
        assert got[2] is None
    if task in ("fewlist-full", "traindict", "trainvaldict"):
        assert len(got[0]) == (160 if task == "fewlist-full" else 80)
