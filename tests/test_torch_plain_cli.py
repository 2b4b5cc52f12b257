"""The port's plain training CLI (`train_torch.py` ->
`cli/train_plain_cli.py`) on files, on the CPU, beside the JAX package's,
and the new root scripts' argv.

Both CLIs run on one synthetic VOC-like set from one starting `.weights`
file with their clocks pinned, so they seed their generators alike, draw
the same augmented batches and take the same eight steps. Stated bounds, as
for the meta CLI (tests/test_torch_train_cli.py): rtol 1e-4 on the
printed losses of the first epoch and 1e-2 on the second's (a float32
rounding difference grows from step to step on a run from random weights);
rtol 1e-3 with a floor of 1e-3 of the leaf's largest value on the parameters
saved after the first epoch."""

import contextlib
import dataclasses
import io
import os
import re
import runpy
import shutil
import sys
import types

import numpy as np
import pytest

from fewshot_detection_tpu.cli import train_plain_cli as j_cli
from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import weights_io as j_weights_io
from fewshot_detection_tpu.models.darknet import init_params as j_init_params
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu_torch.cli import train_meta_cli as t_meta_cli
from fewshot_detection_tpu_torch.cli import train_plain_cli as t_cli

from synth import make_voc_like
from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import REPO

LOSS_LINE = re.compile(
    r"^(\d+): nGT (\d+), recall (\d+), proposals (\d+), loss: x ([\d.]+), y ([\d.]+), "
    r"w ([\d.]+), h ([\d.]+), conf ([\d.]+), cls ([\d.]+), total ([\d.]+)$")
N_IMAGES = 20
SWITCHES = ("FSD_NOAUG", "FSD_DTYPE", "FSD_INPUT_U8", "FSD_REMAT", "FSD_BN_DARKNET",
            "FSD_CLIP_NORM", "FSD_WORKERS", "FSD_NATIVE", "FSD_ORBAX_DIR")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("plaincli")
    d = make_voc_like(str(root / "voc"), n_images=N_IMAGES, seed=4)
    netcfg = str(root / "tiny_plain.cfg")
    with open(netcfg, "w") as f:
        f.write(TINY_PLAIN_CFG)
    shot_dict = str(root / "traindict_3shot.txt")
    shutil.copy(d["traindict"], shot_dict)

    def datacfg(name, backup, extra=""):
        path = str(root / name)
        with open(path, "w") as f:
            f.write(
                "metayolo=0\ndata=voc\nneg=1\nrand=0\nscale=0\n" + extra +
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={shot_dict}\ntrain={d['train_list']}\nvalid={d['train_list']}\n"
                f"backup={root}/{backup}\ngpus=0\n")
        return path

    spec = j_build_spec(j_parse_cfg(netcfg))
    params = j_init_params(spec, 0)
    init_w = str(root / "init.weights")
    j_weights_io.save_weights(init_w, [spec], [params], seen=0)
    return {"root": str(root), "cfg": netcfg, "init_w": init_w, "spec": spec, "params": params,
            "torch_cfg": datacfg("torch.data", "tbackup"),
            "jax_cfg": datacfg("jax.data", "jbackup"),
            "joint_cfg": datacfg("joint.data", "jointbackup", "joint=1\n")}


def _pin(monkeypatch, mod):
    """Pin the CLI's clock and save a checkpoint after every epoch."""
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1234.0))
    resolve = mod.resolve_configs

    def every_epoch(*args):
        data_options, blocks, learnet, settings = resolve(*args)
        return data_options, blocks, learnet, dataclasses.replace(settings, save_interval=1)

    monkeypatch.setattr(mod, "resolve_configs", every_epoch)


def _loss_lines(text):
    return [m for m in (LOSS_LINE.match(l) for l in text.splitlines()) if m]


def _load(ws, path):
    (p,), header = j_weights_io.load_weights(path, [ws["spec"]], [ws["params"]])
    return p, header


@pytest.fixture(scope="module")
def torch_run(ws):
    """Two epochs through the port's CLI; (stdout, backup dir)."""
    mp = pytest.MonkeyPatch()
    buf = io.StringIO()
    try:
        _pin(mp, t_cli)
        for name in SWITCHES:
            mp.delenv(name, raising=False)
        with contextlib.redirect_stdout(buf):
            t_cli.main(ws["torch_cfg"], ws["cfg"], ws["init_w"], device="cpu")
    finally:
        mp.undo()
    return buf.getvalue(), os.path.join(ws["root"], "tbackupfix_novel0")


def _nsamples(out):
    """Images an epoch holds, from the CLI's second epoch line."""
    return int(re.search(r"epoch 1/\d+, processed (\d+) samples", out).group(1))


def test_main_runs_epochs_prints_loss_lines_and_saves_weights(ws, torch_run):
    out, backup = torch_run
    nsamples = _nsamples(out)
    assert 16 < nsamples < N_IMAGES  # images that hold a novel class are left out
    lines = _loss_lines(out)
    assert [int(m.group(1)) for m in lines] == [4 * (i + 1) for i in range(8)]
    assert all(np.isfinite(float(m.group(11))) for m in lines)
    # max_batches 8 of 4 images: two epochs; steps=-1,5 scales=0.1,10
    assert "epoch 0/2, processed 0 samples, lr 0.000050" in out
    assert sorted(os.listdir(backup)) == ["000001.weights", "000002.weights"]
    for epoch in (1, 2):
        p, header = _load(ws, os.path.join(backup, f"{epoch:06d}.weights"))
        assert header.seen == epoch * nsamples
        assert all(np.isfinite(q["w"]).all() for q in p if q and "w" in q)
    assert np.abs(p[0]["w"] - ws["params"][0]["w"]).max() > 0  # it trained


def test_loss_lines_and_checkpoint_match_the_jax_cli(ws, torch_run, monkeypatch, capsys):
    out, backup = torch_run
    _pin(monkeypatch, j_cli)
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(j_cli, "replica_layout", lambda batch_size: (1, batch_size))
    capsys.readouterr()
    j_cli.main(ws["jax_cfg"], ws["cfg"], ws["init_w"])
    want = _loss_lines(capsys.readouterr().out)
    got = _loss_lines(out)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.group(1, 2) == w.group(1, 2)  # seen, nGT
        np.testing.assert_allclose([float(v) for v in g.groups()[4:]],
                                   [float(v) for v in w.groups()[4:]],
                                   rtol=1e-4 if i < 4 else 1e-2, atol=2e-6, err_msg=g.group(0))
    tp, th = _load(ws, os.path.join(backup, "000001.weights"))
    jp, jh = _load(ws, os.path.join(ws["root"], "jbackupfix_novel0", "000001.weights"))
    assert th.seen == jh.seen
    n = 0
    for a, b in zip(tp, jp):
        if a is None:
            continue
        for k, v in [(k, a[k]) for k in ("w", "b") if k in a] + [
                ("bn." + k, a["bn"][k]) for k in a.get("bn", {})]:
            w = b[k] if "." not in k else b["bn"][k[3:]]
            np.testing.assert_allclose(v, w, rtol=1e-3, atol=1e-3 * np.abs(w).max(), err_msg=k)
            n += 1
    assert n == 5 * 5 + 2  # five conv+BN layers (w + four BN leaves), the head's w and b


def test_yolo_joint_merges_the_support_lists_like_the_jax_cli(ws, monkeypatch, capsys):
    """joint=1: the few-shot support list joins the training list
    (reference train.py:94-103), so an epoch holds more samples; both
    CLIs log the same epochs and take the same steps."""
    runs = []
    for mod, args in ((t_cli, {"device": "cpu"}), (j_cli, {})):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1234.0))
        for name in SWITCHES:
            monkeypatch.delenv(name, raising=False)
        capsys.readouterr()
        mod.main(ws["joint_cfg"], ws["cfg"], ws["init_w"], **args)
        out = capsys.readouterr().out
        runs.append((re.findall(r"epoch \d+/\d+, processed \d+ samples, lr \S+", out),
                     [int(m.group(1)) for m in _loss_lines(out)]))
    assert runs[0] == runs[1]
    epochs, seens = runs[0]
    nsamples = 4 * len(seens) // len(epochs)
    assert nsamples > N_IMAGES and seens == [4 * (i + 1) for i in range(len(seens))]


def test_bfloat16_remat_and_two_groups_run(ws, monkeypatch, capsys):
    """FSD_DTYPE=bfloat16 with FSD_CLIP_NORM, and a batch of 4 split into
    two groups of 2, run one after another. (The port reads no FSD_REMAT:
    training BN keeps only what the JAX package's remat keeps.)"""
    monkeypatch.setattr(t_cli, "time", types.SimpleNamespace(time=lambda: 1234.0))
    monkeypatch.setenv("FSD_DTYPE", "bfloat16")
    monkeypatch.setenv("FSD_CLIP_NORM", "10")
    capsys.readouterr()
    t_cli.main(ws["torch_cfg"], ws["cfg"], ws["init_w"], device="cpu", n_groups=2)
    lines = _loss_lines(capsys.readouterr().out)
    assert len(lines) == 8
    assert all(np.isfinite(float(m.group(11))) and int(m.group(2)) > 0 for m in lines)


@pytest.mark.parametrize("name", ["FSD_NATIVE", "FSD_NATIVE_BATCH", "FSD_WORKERS", "FSD_ORBAX_DIR"])
def test_waiting_switch_raises_not_implemented(ws, monkeypatch, name):
    """These switches waited for their parts, and the CLI refused them; the
    parts are ported now (their runs: test_torch_native_cli.py,
    test_torch_checkpoint.py), so none is refused any more: the CLI goes on
    to read its data cfg."""
    monkeypatch.setenv(name, "/tmp/x" if name == "FSD_ORBAX_DIR" else "1")
    t_meta_cli.refuse_device_list("cpu")
    with pytest.raises(FileNotFoundError, match="no_such.data"):
        t_cli.main(os.path.join(ws["root"], "no_such.data"), ws["cfg"], ws["init_w"], device="cpu")


def test_plain_batch_layout_matches_the_jax_cli(monkeypatch):
    import torch

    from fewshot_detection_tpu.cli.train_meta_cli import _image_host_dtype
    from fewshot_detection_tpu.ops.region_loss import sample_neg_keep

    rng = np.random.RandomState(0)
    imgs = rng.rand(4, 8, 8, 3).astype(np.float32)
    labels = np.zeros((4, 250), np.float32)
    labels[0, :5] = [1, 0.5, 0.5, 0.2, 0.2]
    monkeypatch.setenv("FSD_INPUT_U8", "1")
    b = t_cli.make_plain_batch(imgs, labels, 2, 1, np.random.RandomState(1))
    assert b["x"].shape == (2, 2, 8, 8, 3) and b["x"].dtype == torch.uint8
    assert b["target"].shape == (2, 2, 50, 5) and b["keep"].shape == (2, 2)
    _, enc = _image_host_dtype("float32")  # the JAX CLI's uint8 encoding
    np.testing.assert_array_equal(b["x"].numpy(), enc(imgs).reshape(2, 2, 8, 8, 3))
    np.testing.assert_array_equal(
        b["keep"], sample_neg_keep(labels, 1, np.random.RandomState(1)).reshape(2, 2))
    monkeypatch.delenv("FSD_INPUT_U8")
    f = t_cli.make_plain_batch(imgs, labels, 1, "full", None, dtype="bfloat16")
    assert f["x"].dtype == torch.bfloat16 and f["keep"].tolist() == [[1.0] * 4]


@pytest.mark.parametrize("cfgname", ["yolo-voc.cfg", "tiny-yolo-voc.cfg"])
def test_plain_schedule_is_the_jax_clis(cfgname):
    """`plain_schedule_from_cfg` (which the CLI and the smoke script use)
    gives what the JAX CLI computes inline: momentum, decay * batch, and the
    step-LR schedule handed to SGD / batch, at every step change."""
    from fewshot_detection_tpu.train import lr_schedule as j_lr_schedule

    net = j_parse_cfg(os.path.join(REPO, "cfg", cfgname))[0]
    sched = t_cli.plain_schedule_from_cfg(net)
    batch = int(net["batch"])
    steps = [float(s) for s in net["steps"].split(",")]
    scales = [float(s) for s in net["scales"].split(",")]
    assert (sched.batch_size, sched.max_batches) == (batch, int(net["max_batches"]))
    assert sched.momentum == float(net["momentum"])
    assert sched.weight_decay == float(net["decay"]) * batch
    for i in sorted({0, 1, *(int(s) + d for s in steps if s >= 0 for d in (-1, 0, 1))}):
        want = j_lr_schedule(i, float(net["learning_rate"]), steps, scales) / batch
        assert sched.lr(i) == pytest.approx(want, rel=1e-12), i


SCRIPTS = ("valid_torch.py", "valid_meta_torch.py", "detect_torch.py", "eval_torch.py",
           "recall_torch.py", "train_torch.py")


def _run_script(monkeypatch, script, argv):
    monkeypatch.setattr(sys, "argv", [script, *argv])
    runpy.run_path(os.path.join(REPO, script), run_name="__main__")


@pytest.mark.parametrize("script", SCRIPTS)
def test_root_script_takes_its_counterparts_argv_and_needs_a_card(ws, script, monkeypatch,
                                                                   capsys):
    """With a wrong number of arguments the script prints its usage, like
    its JAX counterpart; with the counterpart's argv it runs on `cuda` and,
    with no card here, raises before it reads an image or writes a result."""
    import torch

    with contextlib.suppress(SystemExit):
        _run_script(monkeypatch, script, ["x"])
    assert "Usage" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    argv = {
        "valid_meta_torch.py": [ws["torch_cfg"], os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg"),
                                os.path.join(REPO, "cfg/tiny_reweighting.cfg"), ws["init_w"]],
        "detect_torch.py": [ws["cfg"], ws["init_w"], "none.png"],
        "recall_torch.py": [ws["cfg"], ws["init_w"], "none.txt"],
    }.get(script, [ws["torch_cfg"], ws["cfg"], ws["init_w"]])
    monkeypatch.chdir(ws["root"])
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _run_script(monkeypatch, script, argv)
    assert not os.path.exists(os.path.join(ws["root"], "results"))
