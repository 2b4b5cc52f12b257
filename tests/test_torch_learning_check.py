"""`scripts/learning_check_torch.py` against the JAX package's
`scripts/learning_check.py`, on the CPU.

- Up to the training call, both write the same `dk.cfg` and `meta.data`
  (text for text, the workspace's path replaced) and print the same
  workspace line, for the tiny cfgs with the schedule flags and for the
  flagship cfg (`--full`). Each tool's training call is stood in for, so
  neither trains; their initial weights differ by design (numpy's init
  against jax.random's).
- The port's whole run at a few batches prints the JAX tool's JSON line,
  with a finite mAP."""

import json
import math
import os
import runpy
import sys

import pytest

import fewshot_detection_tpu.cli.train_meta_cli as j_cli
import fewshot_detection_tpu_torch.cli.train_meta_cli as t_cli

from torch_port_util import REPO

PORT = runpy.run_path(os.path.join(REPO, "scripts", "learning_check_torch.py"), run_name="port")


class _Trained(Exception):
    """Raised where a tool would start training."""


def _stop(*args, **kw):
    raise _Trained(args)


@pytest.mark.parametrize("argv", [
    [],
    ["--batch", "8", "--warmup", "3", "--max-batches", "40", "--seed", "2"],
    ["--steps=-1,20", "--multiscale", "--style", "shape", "--size", "72"],
    ["--full", "--images", "24", "--max-batches", "30"],
], ids=["defaults", "batch_warmup", "steps_multiscale", "full"])
def test_patched_cfg_and_data_equal_the_jax_tools(tmp_path, monkeypatch, capsys, argv):
    monkeypatch.setattr(j_cli, "main", _stop)
    monkeypatch.setattr(t_cli, "main", _stop)
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    files, prints = {}, {}
    for tool, root in roots.items():
        old, path = sys.argv, list(sys.path)
        sys.argv = [f"learning_check_{tool}.py", "--root", root, *argv]
        try:
            with pytest.raises(_Trained):
                if tool == "jax":
                    runpy.run_path(os.path.join(REPO, "scripts", "learning_check.py"),
                                   run_name="__main__")
                else:
                    PORT["main"]([*sys.argv[1:], "--device", "cpu"])
        finally:
            sys.argv, sys.path[:] = old, path
        prints[tool] = capsys.readouterr().out.replace(root, "ROOT")
        files[tool] = {n: open(os.path.join(root, n)).read().replace(root, "ROOT")
                       for n in ("dk.cfg", "meta.data")}
    assert files["port"] == files["jax"]
    assert prints["port"] == prints["jax"] and prints["port"].startswith(
        "[learning_check] workspace ROOT:")
    if "--steps=-1,20" in argv:
        assert "steps=-1,20\n" in files["port"]["dk.cfg"]
    if "--full" not in argv:
        assert "scale=0" in files["port"]["meta.data"] or "--multiscale" in argv


def test_a_short_run_prints_a_finite_map(tmp_path, capsys):
    root = str(tmp_path / "run")
    # 25 batches of 8 over the 18 images of base classes: 11 epochs, past the
    # CLI's first checkpoint (every 10 epochs)
    out = PORT["main"](["--root", root, "--images", "20", "--max-batches", "25",
                        "--batch", "8", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "mean_ap", "base_mean", "novel_mean", "images",
                         "max_batches", "full_scale", "checkpoint"}
    assert line["metric"] == "synthetic_voc_map" and line["max_batches"] == 25
    assert math.isfinite(line["mean_ap"]) and line["checkpoint"].endswith(".weights")
    assert {k: out[k] for k in line} == line
    assert set(out["seconds"]) == {"data", "train", "sweep", "score"}
