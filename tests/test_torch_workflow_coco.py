"""The port's COCO workflow (`cli/workflow_coco.py`,
`scripts/full_workflow_coco_torch.py`) against the JAX package's
`scripts/full_workflow_coco.py`, on the CPU.

- The `data` stage writes the same tree (PNG compared as pixels), split
  lists, per-class pools, devkit image sets, `.data` files and cfgs (the
  80-class 425-filter plain head) as the JAX stage, at a cut image count
  and size. The initial `.weights` files have the same size: both are the
  plain and meta graphs' full parameter streams, but the port's `init_params`
  draws from numpy, the JAX package's from `jax.random`.
- The `few` stage then writes the same 10-shot lists, dict and tune.data.
- The stages run in the JAX script's order, each once, a finished one
  skipped and `--stage` running one alone; the backup directories are
  those the port's settings mangle the `.data` files' backups into."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu_torch.cli import workflow_coco as tcw
from fewshot_detection_tpu_torch.config.darkcfg import read_data_cfg
from fewshot_detection_tpu_torch.config.settings import Settings
from fewshot_detection_tpu_torch.data.datasets import get_labpath
from fewshot_detection_tpu_torch.data.synth import load_coco_names

from torch_port_util import REPO

sys.path.insert(0, os.path.join(REPO, "scripts"))
import full_workflow as jwf  # noqa: E402
import full_workflow_coco as jcw  # noqa: E402

N_TRAIN, N_TEST, SIZE = 760, 40, (24, 24)


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def _text(path, root):
    with open(path) as f:
        return f.read().replace(root, "ROOT")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Both data stages, then both few stages, each on a root of its own."""
    mp = pytest.MonkeyPatch()
    try:
        for mod in (tcw, jcw):
            mp.setattr(mod, "N_TRAIN", N_TRAIN)
            mp.setattr(mod, "N_TEST", N_TEST)
            mp.setattr(mod, "IMG_SIZE", SIZE)
        mp.setattr(jwf, "SEED", 7)  # the JAX helper's sampler seeds
        base = tmp_path_factory.mktemp("coco_wf")
        t, j = str(base / "t"), str(base / "j")
        tcw.stage_data(t)
        jcw.stage_data(j)
        trees = {"t": _tree(t), "j": _tree(j)}
        tcw.stage_few(t)
        jcw.stage_few(j)
    finally:
        mp.undo()
    return t, j, trees


def test_data_stage_equals_jax(roots):
    t, j, trees = roots
    assert trees["t"] == trees["j"]
    rels = trees["j"]
    assert "coco/VOCdevkit/VOC2007/ImageSets/Main/zebra_test.txt" in rels
    assert sum(r.endswith(".png") for r in rels) == N_TRAIN + N_TEST
    for rel in rels:
        pt, pj = os.path.join(t, rel), os.path.join(j, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pt)), np.asarray(Image.open(pj)))
        elif rel.endswith(".weights"):
            assert os.path.getsize(pt) == os.path.getsize(pj), rel
        elif not rel.startswith(("state/", "coco/cocolist/box_")) and "10shot" not in rel \
                and rel != "tune.data":
            assert _text(pt, t) == _text(pj, j), rel
    with open(os.path.join(t, "plain.cfg")) as f:
        cfg = f.read()
    assert "filters=425" in cfg and "classes=80" in cfg and "max_batches=900" in cfg
    with open(os.path.join(t, "coco", "VOCdevkit", "VOC2007", "ImageSets", "Main",
                           "test.txt")) as f:
        assert len(f.read().split()) == N_TEST
    with open(os.path.join(t, "state", "data.done")) as f:
        assert json.load(f) == {"train": N_TRAIN, "test": N_TEST}


def test_few_stage_equals_jax(roots):
    t, j, _ = roots
    shot = [r for r in _tree(t) if "10shot" in r or r == "tune.data"]
    assert shot == [r for r in _tree(j) if "10shot" in r or r == "tune.data"]
    assert len(shot) == 80 + 2  # a list a class, the dict, tune.data
    for rel in shot:
        assert _text(os.path.join(t, rel), t) == _text(os.path.join(j, rel), j), rel
    for ci, name in enumerate(load_coco_names()):  # every class has its 10 boxes
        path = os.path.join(t, "coco", "cocolist",
                            f"box_10shot_{name.replace(' ', '_')}_train.txt")
        with open(path) as f:
            boxes = sum(int((np.loadtxt(get_labpath(p.strip())).reshape(-1, 5)[:, 0] == ci).sum())
                        for p in f)
        assert boxes >= 10, name
    with open(os.path.join(t, "tune.data")) as f:
        text = f.read()
    assert "max_epoch=4\nrepeat=2\ndynamic=1\nscale=1\n" in text and "novelid=2" in text


def test_backup_dirs_follow_the_settings_mangle(roots):
    t, _, _ = roots
    for data, want in (("plain.data", tcw.plain_backup_dir(t)),
                       ("base.data", tcw.base_backup_dir(t)),
                       ("tune.data", tcw.tune_backup_dir(t))):
        opts = read_data_cfg(os.path.join(t, data))
        assert Settings.configure(opts).backup == want, data


def test_stages_run_in_order_once_each(tmp_path, monkeypatch, capsys):
    assert [n for n, _ in tcw.STAGES] == [n for n, _ in jcw.STAGES]
    ran = []

    def stub(name):
        def fn(root):
            ran.append(name)
            tcw.mark_done(root, name, {"stage": name, "device": tcw.DEVICE})
        return fn

    monkeypatch.setattr(tcw, "STAGES", [(n, stub(n)) for n, _ in tcw.STAGES])
    monkeypatch.setattr(tcw, "DEVICE", tcw.DEVICE)  # main() sets it
    root = str(tmp_path / "wf")
    tcw.mark_done(root, "data", {"train": 1})  # done before: skipped
    summary = tcw.main(["--root", root, "--device", "cpu"])
    assert ran == ["plain", "part", "base", "few", "tune", "evalb", "evalt"]
    assert list(summary) == [n for n, _ in tcw.STAGES] and summary["data"] == {"train": 1}
    assert summary["evalt"]["device"] == "cpu"
    out = capsys.readouterr().out
    assert "data: already done, skipping" in out
    line = [ln for ln in out.splitlines() if ln.startswith("WORKFLOW ")][-1]
    assert json.loads(line[len("WORKFLOW "):]) == summary
    ran.clear()
    assert tcw.main(["--root", root, "--device", "cpu"]) == summary and ran == []
    tcw.main(["--root", root, "--device", "cpu", "--stage", "few"])  # alone, though done
    assert ran == ["few"]
    assert sorted(os.listdir(os.path.join(root, "state"))) == sorted(
        f"{n}.done" for n, _ in tcw.STAGES)


def test_entry_script_help_runs_without_a_card():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "full_workflow_coco_torch.py"), "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--root", "--stage", "--device"):
        assert flag in proc.stdout, flag


def test_the_stages_ask_for_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(tcw, "STAGES", [("data", lambda root: tcw.mark_done(
        root, "data", {"device": tcw.DEVICE}))])
    monkeypatch.setattr(tcw, "DEVICE", tcw.DEVICE)
    assert tcw.main(["--root", str(tmp_path)])["data"] == {"device": "cuda"}
