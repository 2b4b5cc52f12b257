"""`scripts/shot_sweep_torch.py` against the JAX package's
`scripts/shot_sweep.py`, on the CPU.

- `build_fewdict` writes BYTE-IDENTICAL k-shot lists and dict (the per-k
  directory's path replaced) on one painted root, with both workflows'
  seeds at their defaults.
- On one tiny CPU workflow root (`cli/workflow.py --tiny --device cpu`:
  the data stage at the smallest counts that fill a 1-shot budget, and a
  base stage cut to its first checkpoint, float32 without remat as in
  tests/test_torch_workflow.py), the sweep at one shot, the tuning cut to
  one epoch of one repeat (its tiny overrides set so on the script's
  module), prints a finite SHOTSWEEP line; the workflow's settings are put
  back afterwards. The JAX sweep is not run here: it tunes through a
  train_meta.py subprocess.
- The guards: a flagship root and a tiny root without a base stage are
  refused by both tools with the same assertion."""

import json
import math
import os
import runpy
import sys

import pytest

from fewshot_detection_tpu_torch.cli import workflow as twf
from fewshot_detection_tpu_torch.data import synth as tsynth

from torch_port_util import REPO

PORT = runpy.run_path(os.path.join(REPO, "scripts", "shot_sweep_torch.py"), run_name="port")
_path = list(sys.path)
JAX = runpy.run_path(os.path.join(REPO, "scripts", "shot_sweep.py"), run_name="jax")
sys.path[:] = _path
jwf = JAX["wf"]
JWF_SETTINGS = ("TINY", "DK_SRC", "LN_SRC", "TUNE_SCALE", "TUNE_MAX_EPOCH", "TUNE_REPEAT", "SEED")


@pytest.fixture(autouse=True)
def _restore_workflow_settings(monkeypatch):
    """Both tools set their workflow module's settings; each test gets them
    back."""
    for name, value in twf.DEFAULTS.items():
        monkeypatch.setattr(twf, name, value)
    for name in JWF_SETTINGS:
        monkeypatch.setattr(jwf, name, getattr(jwf, name))


@pytest.mark.parametrize("shot", [1, 3])
def test_build_fewdict_writes_the_jax_tools_lists(tmp_path, shot):
    root = str(tmp_path / "root")
    d = tsynth.make_voc_like(os.path.join(root, "voc"), n_images=120, size=(24, 24), seed=7,
                             style="huebin", box_range=(0.15, 0.45))
    with open(os.path.join(root, "voc", "train_split.txt"), "w") as f:
        f.write("\n".join(d["img_paths"][:110]) + "\n")
    assert twf.SEED == jwf.SEED == 7
    kdirs = {"port": str(tmp_path / "kp"), "jax": str(tmp_path / "kj")}
    dicts = {"port": PORT["build_fewdict"](root, kdirs["port"], shot),
             "jax": JAX["build_fewdict"](root, kdirs["jax"], shot)}
    assert os.path.basename(dicts["port"]) == f"voc_traindict_bbox_{shot}shot.txt"

    def files(tool):
        k = kdirs[tool]
        out = {os.path.relpath(dicts[tool], k): open(dicts[tool]).read().replace(k, "K")}
        for name in os.listdir(os.path.join(k, "voclist")):
            with open(os.path.join(k, "voclist", name)) as f:
                out[name] = f.read()
        return out

    got, want = files("port"), files("jax")
    assert got == want and len(got) == 21
    assert all(v for v in got.values())


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A tiny workflow root through its data stage and a base stage cut to
    the first checkpoint (10 epochs)."""
    root = str(tmp_path_factory.mktemp("sweep") / "wf")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(twf, "STAGE_ENV", {k: v for k, v in twf.STAGE_ENV.items()
                                      if k not in ("FSD_DTYPE", "FSD_REMAT")})
        configure = twf.configure

        def at_batch_16(args):
            configure(args)
            twf.DK_BATCH = 16

        mp.setattr(twf, "configure", at_batch_16)
        for stage in ("data", "base"):
            twf.main(["--tiny", "--device", "cpu", "--root", root, "--seed", "2",
                      "--n-train", "48", "--n-test", "8", "--base-batches", "30",
                      "--stage", stage])
    finally:
        mp.undo()
        twf.configure(twf.parse_args([]))  # the module's defaults again
    return root


def test_one_shot_sweep_on_a_tiny_root(tiny_root, monkeypatch, capsys):
    monkeypatch.setattr(twf, "STAGE_ENV", {k: v for k, v in twf.STAGE_ENV.items()
                                           if k not in ("FSD_DTYPE", "FSD_REMAT")})
    monkeypatch.setitem(PORT["TINY_OVERRIDES"], "TUNE_MAX_EPOCH", 1)
    monkeypatch.setitem(PORT["TINY_OVERRIDES"], "TUNE_REPEAT", 1)
    before = {k: getattr(twf, k) for k in twf.DEFAULTS}
    table = PORT["main"](["--root", tiny_root, "--shots", "1", "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("SHOTSWEEP ")]
    assert json.loads(line[-1][len("SHOTSWEEP "):]) == table
    assert {k: getattr(twf, k) for k in twf.DEFAULTS} == before
    assert table["root"] == tiny_root and table["base_checkpoint_novel"] is None
    (row,) = table["per_shot"]
    assert row["shot"] == 1
    assert all(math.isfinite(row[k]) for k in ("novel", "base", "mean"))
    kdir = os.path.join(tiny_root, "shot1")
    assert os.path.isfile(os.path.join(kdir, "result.json"))
    assert os.listdir(os.path.join(kdir, "backup_tunefix_novel0_neg0")) == ["000001.weights"]
    with open(os.path.join(tiny_root, "logs", "tune_shot1.log")) as f:
        assert "nGT" in f.read()
    # a rerun finds the marker and tunes nothing
    again = PORT["main"](["--root", tiny_root, "--shots", "1", "--device", "cpu"])
    assert again == table and "shot1: already done" in capsys.readouterr().out


def _decision(tool, root):
    old, path = sys.argv, list(sys.path)
    sys.argv = ["shot_sweep.py", "--root", root, "--shots", "1"]
    try:
        if tool == "jax":
            JAX["main"]()
        else:
            PORT["main"](sys.argv[1:] + ["--device", "cpu"])
    except AssertionError as e:
        return str(e)
    finally:
        sys.argv, sys.path[:] = old, path
    return None


@pytest.mark.parametrize("case", ["flagship", "no_base", "no_data"])
def test_guards_decide_as_the_jax_tool(tmp_path, case):
    root = str(tmp_path / case)
    if case != "no_data":
        twf.mark_done(root, "data", {"mode": "flagship" if case == "flagship" else "tiny"})
    got, want = _decision("port", root), _decision("jax", root)
    assert got == want
    assert want == {"flagship": "shot_sweep expects a tiny root, got 'flagship'",
                    "no_base": "root has no finished base stage",
                    "no_data": "shot_sweep expects a tiny root, got None"}[case]
    assert {k: getattr(twf, k) for k in twf.DEFAULTS} == twf.DEFAULTS
