"""The port's analysis tools that read workflow roots and logs
(`scripts/cls_curve_torch.py`, `tuning_delta_torch.py`,
`seed_stats_torch.py`) against the JAX package's, on the CPU: the same
roots and logs, identical stdout (and the same exit). And `--help` of all
eight analysis tools against their JAX counterparts: the same text but for
the script's name and, for the five that run a model, the `--device` option
the port adds. Each script runs in this process as `__main__` (`runpy`)."""

import contextlib
import io
import json
import math
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from fewshot_detection_tpu_torch.utils.logging import format_loss_line

from torch_port_util import REPO

PAIRS = {n: (f"scripts/{n}_torch.py", f"scripts/{n}.py") for n in (
    "cls_curve", "tuning_delta", "seed_stats", "shot_sweep", "learning_check",
    "support_snr", "eval_widerface", "multiscale_epoch")}
RUNS_A_MODEL = {"shot_sweep", "learning_check", "support_snr", "eval_widerface",
                "multiscale_epoch"}
VOC = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair", "cow",
       "diningtable", "dog", "horse", "motorbike", "person", "pottedplant", "sheep", "sofa",
       "train", "tvmonitor"]


def _run(script, argv):
    """(stdout, exit code or None) of the script as `__main__` with `argv`;
    sys.path and the JAX workflow's settings are the caller's to restore."""
    old = sys.argv
    sys.argv = [script, *argv]
    out = io.StringIO()
    code = None
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = old
    return out.getvalue(), code


def _both(name, argv):
    port, jax_script = PAIRS[name]
    path = list(sys.path)
    try:
        return _run(port, argv), _run(jax_script, argv)
    finally:
        sys.path[:] = path


def _without_device(text):
    """The words of a help text without the port's `--device` option: its
    `[--device DEVICE]` in the usage, and its entry among the options."""
    toks, out, i = text.split(), [], 0
    while i < len(toks):
        if toks[i] == "[--device" and toks[i + 1] == "DEVICE]":
            i += 2
        elif toks[i] == "--device" and toks[i + 1] == "DEVICE":
            i += 2
            while i < len(toks) and not toks[i].startswith("-"):
                i += 1
        else:
            out.append(toks[i])
            i += 1
    return out


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_help_is_the_same(name, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import full_workflow as jwf  # what the JAX shot_sweep imports

    for k in ("TINY", "DK_SRC", "LN_SRC", "TUNE_SCALE", "TUNE_MAX_EPOCH", "TUNE_REPEAT"):
        monkeypatch.setattr(jwf, k, getattr(jwf, k))
    (got, got_code), (want, want_code) = _both(name, ["--help"])
    assert got_code == want_code  # argparse exits 0; support_snr prints its usage, exits 1
    port, jax_script = (os.path.basename(p) for p in PAIRS[name])
    assert jax_script in want
    want_words = want.replace(jax_script, port).split()
    if name in RUNS_A_MODEL:
        assert "--device" in got.split() or "[--device" in got.split()
        assert _without_device(got) == want_words
    else:
        assert got.split() == want_words


# ----------------------------------------------------------------- cls_curve


def _loss_log(path, rng, n=60, restart=25):
    """A train log as the port writes it: loss lines of
    utils/logging.format_loss_line (a resumed run's restart at `restart`),
    other lines between them."""
    metrics_keys = ("nGT", "nCorrect", "nProposals", "loss_x", "loss_y", "loss_w", "loss_h",
                    "loss_conf", "loss_cls", "loss")
    lines, seen = [], 0
    for i in range(n):
        if i == restart:
            seen -= 5 * 64  # resumed from an older checkpoint
            lines.append("resuming from backup/000005.weights")
        seen += 64
        m = {k: torch.tensor(float(rng.integers(1, 90)) if k.startswith("n")
                             else float(rng.uniform(0, 3 if k != "loss_cls" else 300)))
             for k in metrics_keys}
        if i % 17 == 3:
            m["nGT"] = torch.tensor(0.0)  # max(ngt, 1) in the curve
        lines.append(format_loss_line(seen, m))
        if i % 10 == 0:
            lines.append(f"{seen} images, epoch {i // 10}: lr 0.001")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines


def test_cls_curve_matches_every_loss_line_of_the_port():
    """The tool's pattern must match each finite loss line the port logs:
    a line it does not match is dropped without a word."""
    cls_curve = runpy.run_path(os.path.join(REPO, PAIRS["cls_curve"][0]), run_name="x")
    rng = np.random.default_rng(0)
    keys = ("nGT", "nCorrect", "nProposals", "loss_x", "loss_y", "loss_w", "loss_h",
            "loss_conf", "loss_cls", "loss")
    for value in (0.0, 1e-9, 0.5, 4.094, 123456.789, 3.4e38):
        m = {k: torch.tensor(float(rng.uniform(0, 5))) for k in keys}
        m["loss_cls"] = torch.tensor(value, dtype=torch.float64)
        line = format_loss_line(int(rng.integers(0, 10 ** 7)), m)
        match = cls_curve["LOSS_LINE"].match(line)
        assert match, line
        assert math.isclose(float(match.group(3)), value, rel_tol=1e-6, abs_tol=1e-6)


@pytest.mark.parametrize("argv", [[], ["--bucket", "640", "--n-cls", "20"],
                                  ["--bucket", "100000"]])
def test_cls_curve_prints_what_the_jax_tool_prints(tmp_path, argv):
    log = str(tmp_path / "base.log")
    _loss_log(log, np.random.default_rng(1))
    (got, gc), (want, wc) = _both("cls_curve", [log, *argv])
    assert got == want and gc == wc is None
    assert len(got.splitlines()) >= 3


# -------------------------------------------------- tuning_delta, seed_stats


def _marker(root, stage, payload):
    os.makedirs(os.path.join(root, "state"), exist_ok=True)
    with open(os.path.join(root, "state", f"{stage}.done"), "w") as f:
        json.dump(payload, f)


def _eval_payload(rng, stage, with_aps=True, missing=()):
    aps = {c: round(float(rng.uniform(0, 1)), 4) for c in VOC if c not in missing}
    novel = [aps[c] for c in ("bird", "bus", "cow", "motorbike", "sofa") if c in aps]
    base = [v for c, v in aps.items() if c not in ("bird", "bus", "cow", "motorbike", "sofa")]
    out = {"stage": stage, "mean_ap": round(float(np.mean(list(aps.values()))), 4),
           "base_mean": round(float(np.mean(base)), 4),
           "novel_mean": round(float(np.mean(novel)), 4),
           "checkpoint": f"/w/{stage}/000010.weights"}
    if with_aps:
        out["aps"] = aps
    return out, aps


def _root(tmp_path, name, seed, with_aps=True, base_missing=("sofa",)):
    root = str(tmp_path / name)
    rng = np.random.default_rng(seed)
    _marker(root, "data", {"train": 200, "test": 8, "mode": "tiny", "novelid": 0, "seed": seed})
    for stage, log, missing in (("evalb", "eval_base", base_missing), ("evalt", "eval_tune", ())):
        payload, aps = _eval_payload(rng, stage, with_aps, missing)
        _marker(root, stage, payload)
        os.makedirs(os.path.join(root, "logs"), exist_ok=True)
        with open(os.path.join(root, "logs", f"{log}.log"), "w") as f:
            f.write("\n===== eval =====\nReading annotation for 1/8\n")
            for c, ap in aps.items():
                f.write(f"AP for {c} = {ap:.4f}\n")
            f.write(f"Mean AP = {np.mean(list(aps.values())):.4f}\n")
    return root


@pytest.mark.parametrize("with_aps", [True, False], ids=["markers", "log_scrape"])
def test_tuning_delta_prints_what_the_jax_tool_prints(tmp_path, with_aps):
    root = _root(tmp_path, "r", 3, with_aps)
    for argv in (["--root", root], ["--root", root, "--novelid", "2"],
                 ["--root", root, "--novel-file", "bird,cat,dog"]):
        (got, gc), (want, wc) = _both("tuning_delta", argv)
        assert got == want and gc == wc is None
        if argv == ["--root", root]:
            assert "| mean novel |" in got and "| sofa (novel) | -- |" in got
        assert "tuned ckpt: /w/evalt/000010.weights" in got


def test_tuning_delta_refuses_a_root_without_aps_as_the_jax_tool_does(tmp_path):
    root = str(tmp_path / "empty")
    _marker(root, "evalb", {"checkpoint": "x"})
    (got, gc), (want, wc) = _both("tuning_delta", ["--root", root])
    assert (got, gc) == (want, wc)
    assert gc.startswith("missing eval APs under")


def test_seed_stats_prints_what_the_jax_tool_prints(tmp_path):
    roots = ",".join(_root(tmp_path, f"s{s}", s, base_missing=()) for s in (2, 7, 13))
    for argv in (["--roots", roots], ["--roots", roots, "--novelid", "1"]):
        (got, gc), (want, wc) = _both("seed_stats", argv)
        assert got == want and gc == wc is None
        summary = json.loads(got[len("SEEDSTATS "):])
        assert summary["n_seeds"] == 3 and len(summary["novel_class_deltas"]) == 5
