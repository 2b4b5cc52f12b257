"""The port's workflow (`cli/workflow.py`, `data/synth.py`,
`scripts/full_workflow_torch.py`) against the JAX package's
`scripts/full_workflow.py` and `tests/synth.py`, on the CPU.

- `data/synth.py:make_voc_like` writes the same images (PNG, compared as
  pixels), labels, per-class lists and devkit as `tests/synth.py`.
- The directory and mode bookkeeping answers the cases of
  `tests/test_workflow_dirs.py` exactly as the JAX workflow script does.
- `stage_few` writes the JAX `stage_few`'s lists on the same root.
- One `--tiny --device cpu` run at the smallest counts that fill the 10-shot
  budget goes through every stage to the WORKFLOW line with finite mAPs. To
  keep it near half a minute here, the base stage runs at batch 16 (not
  tiny's 4) with 100 batches (the ten epochs before base training's first
  checkpoint), in float32 and without remat (bfloat16 convolutions and
  recomputation are slow on this CPU); the stage logic is unchanged."""

import filecmp
import gzip
import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu_torch.cli import workflow as twf
from fewshot_detection_tpu_torch.data import synth as tsynth
from torch_port_util import REPO

sys.path.insert(0, os.path.join(REPO, "scripts"))
import full_workflow as jwf  # noqa: E402
import synth as jsynth  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_workflow_settings(monkeypatch):
    """main() sets the workflows' module settings; each test gets them back."""
    for name, value in twf.DEFAULTS.items():
        monkeypatch.setattr(twf, name, value)
        if hasattr(jwf, name):
            monkeypatch.setattr(jwf, name, getattr(jwf, name))


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


@pytest.mark.parametrize("style", ["huebin", "shape", "color"])
def test_synth_equals_the_reference(tmp_path, style):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(n_images=27, size=(72, 56), seed=5, style=style, box_range=(0.15, 0.45))
    da, db = jsynth.make_voc_like(a, **kw), tsynth.make_voc_like(b, **kw)
    assert _tree(a) == _tree(b)
    assert [os.path.relpath(p, a) for p in da["img_paths"]] == \
        [os.path.relpath(p, b) for p in db["img_paths"]]
    assert sorted(da["cls_lists"]) == sorted(db["cls_lists"])
    for rel in _tree(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)))
        else:  # labels, labels_1c, lists, traindict, devkit: root-relative text
            with open(pa) as fa, open(pb) as fb:
                assert fa.read().replace(a, "ROOT") == fb.read().replace(b, "ROOT"), rel


@pytest.fixture(params=["jax", "torch"])
def wf(request):
    return jwf if request.param == "jax" else twf


def test_backup_dirs_follow_scale_mangle(monkeypatch, wf):
    monkeypatch.setattr(wf, "TINY", False)
    monkeypatch.setattr(wf, "TUNE_SCALE", 1)
    assert wf.base_backup_dir("/r") == "/r/backup_novel0_neg1"
    assert wf.tune_backup_dir("/r") == "/r/backup_tune_novel0_neg0"
    monkeypatch.setattr(wf, "TINY", True)
    monkeypatch.setattr(wf, "TUNE_SCALE", 0)
    assert wf.base_backup_dir("/r") == "/r/backupfix_novel0_neg1"
    assert wf.tune_backup_dir("/r") == "/r/backup_tunefix_novel0_neg0"
    monkeypatch.setattr(wf, "NOVELID", 3)
    assert wf.base_backup_dir("/r") == "/r/backupfix_novel3_neg1"


def test_tune_dir_matches_the_ports_settings_mangle(monkeypatch, tmp_path):
    from fewshot_detection_tpu_torch.config.settings import Settings

    opts = {"metayolo": "1", "data": "voc", "neg": "0", "rand": "0", "tuning": "1",
            "max_epoch": "10", "repeat": "20", "scale": "0", "meta": "box_10shot.txt",
            "novelid": "0", "backup": str(tmp_path / "backup_tune"), "gpus": "0"}
    monkeypatch.setattr(twf, "TUNE_SCALE", 0)
    assert Settings.configure(opts).backup == twf.tune_backup_dir(str(tmp_path))


def test_artifact_snapshot_restore_roundtrip(tmp_path, monkeypatch, wf):
    monkeypatch.setattr(wf, "TINY", False)
    monkeypatch.setattr(wf, "ARTIFACTS", str(tmp_path / "artifacts"))
    if wf is twf:  # the port's read-only seed: none here
        monkeypatch.setattr(wf, "SEED_ARTIFACTS", str(tmp_path / "no_seed"))
    root = str(tmp_path / "root")
    bdir = wf.base_backup_dir(root)
    os.makedirs(bdir)
    header = np.array([0, 2, 0, 12345], np.int32)
    payload = np.random.RandomState(0).randn(100).astype(np.float32)
    with open(os.path.join(bdir, "000040.weights"), "wb") as f:
        header.tofile(f)
        payload.tofile(f)
    dst = wf.snapshot_base_artifact(root)
    manifest = json.load(open(os.path.join(wf.artifact_dir(), "manifest.json")))
    assert manifest["seen"] == 12345 and manifest["src_name"] == "000040.weights"
    # the bf16 codec: both workflows store the same bytes
    with gzip.open(dst) as f:
        stored = f.read()
    assert stored[:16] == header.tobytes()
    assert stored[16:] == jwf._f32_to_bf16_bytes(payload.tobytes())
    root2 = str(tmp_path / "root2")
    os.makedirs(root2)
    got = wf.restore_base_artifact(root2)
    assert got and got.endswith("000040.weights")
    restored = np.fromfile(got, np.float32)[4:]
    assert np.array_equal(restored.view(np.uint32) >> 16, np.frombuffer(
        stored[16:], np.uint16).astype(np.uint32))
    assert wf.restore_base_artifact(root2) is None  # live checkpoints win
    root3 = str(tmp_path / "root3")
    os.makedirs(root3)
    monkeypatch.setattr(wf, "SEED", wf.SEED + 1)
    assert wf.restore_base_artifact(root3) is None  # recipe mismatch
    monkeypatch.setattr(wf, "TINY", True)
    assert wf.snapshot_base_artifact(root) is None


def _digests(folder):
    import hashlib

    out = {}
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        with open(path, "rb") as f:
            out[name] = (hashlib.sha256(f.read()).hexdigest(), os.stat(path).st_mtime_ns)
    return out


def test_flagship_base_stage_leaves_the_tracked_artifact_unchanged(tmp_path, monkeypatch):
    """A default flagship `stage_base` (seed, style and n_train those of the
    tracked artifacts/flagship_base_novel0) restores from the tracked
    artifact, trains (stood in for here) and snapshots into the port's own
    directory, which git ignores: the tracked files stay byte for byte."""
    from fewshot_detection_tpu_torch.cli import train_meta_cli

    tracked = os.path.join(REPO, "artifacts", "flagship_base_novel0")
    assert twf.artifact_dir(twf.SEED_ARTIFACTS) == tracked
    assert not twf.artifact_dir().startswith(os.path.join(REPO, "artifacts") + os.sep)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert os.path.relpath(twf.ARTIFACTS, REPO) + "/" in f.read().split()
    before = _digests(tracked)
    # the default location is the port's own; here it is the test's
    monkeypatch.setattr(twf, "ARTIFACTS", str(tmp_path / "artifacts_torch"))
    root = str(tmp_path / "root")
    os.makedirs(root)
    seen = []

    def train(datacfg, darknetcfg, learnetcfg, weightfile, device):
        seen.append(weightfile)
        shutil.copyfile(weightfile, os.path.join(os.path.dirname(weightfile), "000150.weights"))

    monkeypatch.setattr(train_meta_cli, "main", train)
    twf.stage_base(root)
    bdir = twf.base_backup_dir(root)
    assert seen == [os.path.join(bdir, "000140.weights")]  # restored from the tracked one
    manifest = json.load(open(os.path.join(twf.artifact_dir(), "manifest.json")))
    assert manifest["src_name"] == "000150.weights"
    assert _digests(tracked) == before


def test_recorded_mode_roundtrip(tmp_path, wf):
    root = str(tmp_path)
    assert wf.recorded_mode(root) is None
    os.makedirs(os.path.join(root, "state"))
    with open(wf.done_marker(root, "data"), "w") as f:
        json.dump({"mode": "tiny"}, f)
    assert wf.recorded_mode(root) == "tiny"
    with open(wf.done_marker(root, "data"), "w") as f:
        json.dump({}, f)
    with open(os.path.join(root, "base.data"), "w") as f:
        f.write("metayolo=1\nscale=0\n")
    assert wf.recorded_mode(root) == "tiny"
    with open(os.path.join(root, "base.data"), "w") as f:
        f.write("metayolo=1\n")
    assert wf.recorded_mode(root) == "flagship"


def test_patch_cfg_and_latest_weights_equal_jax(tmp_path):
    src = os.path.join(REPO, "cfg", "darknet_dynamic.cfg")
    a = jwf.patch_cfg(src, str(tmp_path / "a.cfg"), max_batches=70, batch=32, steps="-1,3,9")
    b = twf.patch_cfg(src, str(tmp_path / "b.cfg"), max_batches=70, batch=32, steps="-1,3,9")
    assert filecmp.cmp(a, b, shallow=False)
    bdir = tmp_path / "backup"
    bdir.mkdir()
    for name, size in (("000010.weights", 64), ("000020.weights", 64), ("000030.weights", 10)):
        (bdir / name).write_bytes(b"\0" * size)
    assert twf.latest_weights(str(bdir)) == jwf.latest_weights(str(bdir)) \
        == str(bdir / "000020.weights")
    assert twf.latest_weights(str(tmp_path / "none")) is None


def test_mode_and_novelid_guards(tmp_path):
    root = str(tmp_path)
    twf.mark_done(root, "data", {"mode": "flagship", "novelid": 0})
    with pytest.raises(SystemExit, match="flagship mode"):
        twf.main(["--tiny", "--root", root, "--device", "cpu", "--stage", "few"])
    with pytest.raises(SystemExit, match="novelid"):
        twf.main(["--root", root, "--device", "cpu", "--novelid", "2", "--stage", "few"])


def test_stage_few_equals_jax(tmp_path, monkeypatch):
    root = str(tmp_path / "t")
    d = tsynth.make_voc_like(os.path.join(root, "voc"), n_images=240, size=(24, 24), seed=7,
                             style="huebin", box_range=(0.15, 0.45))
    with open(os.path.join(root, "voc", "train_split.txt"), "w") as f:
        f.write("\n".join(d["img_paths"][:220]) + "\n")
    os.makedirs(os.path.join(root, "voc", "voclist"))
    jroot = str(tmp_path / "j")
    shutil.copytree(root, jroot)
    with open(os.path.join(jroot, "voc", "train_split.txt"), "w") as f:
        f.write("\n".join(p.replace(root, jroot) for p in d["img_paths"][:220]) + "\n")
    for mod in (twf, jwf):
        monkeypatch.setattr(mod, "SEED", 7)
        monkeypatch.setattr(mod, "TUNE_SCALE", 1)
    twf.stage_few(root)
    jwf.stage_few(jroot)
    lists = sorted(os.listdir(os.path.join(root, "voc", "voclist")))
    assert lists == sorted(os.listdir(os.path.join(jroot, "voc", "voclist")))
    assert len(lists) == 20
    for name in lists + ["../voc_traindict_bbox_10shot.txt", "../../tune.data"]:
        with open(os.path.join(root, "voc", "voclist", name)) as fa, \
                open(os.path.join(jroot, "voc", "voclist", name)) as fb:
            assert fa.read().replace(root, "R") == fb.read().replace(jroot, "R"), name


def test_tiny_cpu_run_goes_through_every_stage(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(twf, "STAGE_ENV", {k: v for k, v in twf.STAGE_ENV.items()
                                           if k not in ("FSD_DTYPE", "FSD_REMAT")})
    configure = twf.configure

    def at_batch_16(args):
        configure(args)
        twf.DK_BATCH = 16

    monkeypatch.setattr(twf, "configure", at_batch_16)
    root = str(tmp_path / "wf")
    env_before = {k: os.environ.get(k) for k in (*twf.STAGE_ENV, *twf.EVAL_ENV)}
    summary = twf.main(["--tiny", "--device", "cpu", "--root", root, "--seed", "2",
                        "--n-train", "200", "--n-test", "8", "--base-batches", "100",
                        "--tune-max-epoch", "1", "--tune-repeat", "1"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("WORKFLOW ")][-1]
    assert json.loads(line[len("WORKFLOW "):]) == summary
    assert list(summary) == ["data", "base", "few", "tune", "evalb", "evalt"]
    for stage in ("evalb", "evalt"):
        assert math.isfinite(summary[stage]["mean_ap"])
        assert len(summary[stage]["aps"]) == 20
    assert summary["base"]["ckpt"].endswith("backupfix_novel0_neg1/000010.weights")
    assert summary["tune"]["ckpt"].endswith("backup_tunefix_novel0_neg0/000001.weights")
    for name in ("base", "tune", "eval_base", "eval_tune"):
        with open(os.path.join(root, "logs", f"{name}.log")) as f:
            text = f.read()
        assert text.strip(), name
        if name in ("base", "tune"):
            assert re.search(r"^\d+: nGT \d+, .* total \S+$", text, re.M), name
    # the stages' switches are put back
    assert {k: os.environ.get(k) for k in env_before} == env_before
    # a rerun skips every finished stage
    again = twf.main(["--tiny", "--device", "cpu", "--root", root, "--seed", "2",
                      "--n-train", "200", "--n-test", "8"])
    assert again == summary
    assert "already done, skipping" in capsys.readouterr().out


def test_entry_script_help_runs_without_a_card():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "full_workflow_torch.py"),
                           "--help"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--tiny", "--root", "--stage", "--reset-from", "--style", "--n-train",
                 "--n-test", "--plain-batches", "--base-batches", "--tune-max-epoch",
                 "--tune-repeat", "--snapshot-artifact", "--novelid", "--seed", "--device"):
        assert flag in proc.stdout, flag
