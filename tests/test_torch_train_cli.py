"""The port's training CLI on files, on the CPU, beside the JAX package's.

Both CLIs are run on one synthetic VOC-like set from one starting
`.weights` file with their clocks pinned, so both seed their generators
alike, draw the same augmented episodes and the same negative-copy samples,
and take the same twelve steps. The loss lines and the first saved checkpoint
are then compared. The run starts from random weights at a loss of 3400 and
falls to 600 in twelve steps, so a float32 rounding difference grows from
step to step (measured: 2e-7 on the first line, 7e-6 on the sixth, 3e-3 on
the twelfth, ten times that at the cfg's own learning rate). Stated bounds:
rtol 1e-4 on the printed losses of the first epoch and 1e-2 on the second's;
rtol 1e-3 with a floor of 1e-3 of the leaf's largest value on the parameters
saved after the first epoch (a BN beta starts at 0, so its value after six
steps IS the accumulated difference-prone update)."""

import os
import re
import shutil
import types

import numpy as np
import pytest

from fewshot_detection_tpu.cli import train_meta_cli as j_cli
from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import weights_io as j_weights_io
from fewshot_detection_tpu.models.meta import MetaSpec as JMetaSpec
from fewshot_detection_tpu.models.meta import init_meta_params as j_init_meta_params
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu_torch.cli import common as t_common
from fewshot_detection_tpu_torch.cli import train_meta_cli as t_cli

from synth import make_voc_like
from torch_port_util import REPO

LOSS_LINE = re.compile(
    r"^(\d+): nGT (\d+), recall (\d+), proposals (\d+), loss: x ([\d.]+), y ([\d.]+), "
    r"w ([\d.]+), h ([\d.]+), conf ([\d.]+), cls ([\d.]+), total ([\d.]+)$")
N_IMAGES = 24


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("traincli")
    d = make_voc_like(str(root / "voc"), n_images=N_IMAGES, seed=0)
    dk = str(root / "tiny_dd.cfg")
    with open(os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg")) as f:
        txt = f.read().replace("max_batches=100", "max_batches=8")
        txt = txt.replace("learning_rate=0.001", "learning_rate=0.0001")
    with open(dk, "w") as f:
        f.write(txt)
    dk_base = str(root / "tiny_dd_base.cfg")
    with open(dk_base, "w") as f:
        f.write(txt.replace("max_batches=8", "max_batches=20"))
    ln = os.path.join(REPO, "cfg/tiny_reweighting.cfg")
    # tuning derives the shot count from the meta file's name
    shot_dict = str(root / "traindict_3shot.txt")
    shutil.copy(d["traindict"], shot_dict)

    def datacfg(name, backup, extra):
        path = str(root / name)
        with open(path, "w") as f:
            f.write(
                "metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\nscale=0\n" + extra +
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={shot_dict}\ntrain={d['train_list']}\nvalid={d['train_list']}\n"
                f"backup={root}/{backup}\ngpus=0\n")
        return path

    spec = JMetaSpec(j_build_spec(j_parse_cfg(dk)), j_build_spec(j_parse_cfg(ln)))
    params = j_init_meta_params(spec, 0)
    init_w = str(root / "init.weights")
    j_weights_io.save_weights(init_w, [spec.darknet, spec.learnet],
                              [params["darknet"], params["learnet"]], seen=0)
    tune = "tuning=1\nmax_epoch=2\nrepeat=1\ndynamic=0\n"
    return {"root": str(root), "dk": dk, "dk_base": dk_base, "ln": ln, "init_w": init_w, "spec": spec,
            "params": params,
            "torch_cfg": datacfg("torch.data", "tbackup", tune),
            "jax_cfg": datacfg("jax.data", "jbackup", tune),
            "base_cfg": datacfg("base.data", "bbackup", "")}


def _pin_clock(monkeypatch):
    for mod in (t_cli, j_cli):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1234.0))


def _loss_lines(text):
    return [m for m in (LOSS_LINE.match(l) for l in text.splitlines()) if m]


def _load(ws, path):
    (dp, lp), header = j_weights_io.load_weights(
        path, [ws["spec"].darknet, ws["spec"].learnet],
        [ws["params"]["darknet"], ws["params"]["learnet"]])
    return dp, lp, header


@pytest.fixture(scope="module")
def torch_run(ws):
    """Two tuning epochs through the port's CLI; (stdout, backup dir)."""
    mp = pytest.MonkeyPatch()
    import contextlib
    import io

    buf = io.StringIO()
    try:
        _pin_clock(mp)
        for name in ("FSD_NOAUG", "FSD_DTYPE", "FSD_INPUT_U8", "FSD_REMAT", "FSD_BN_DARKNET"):
            mp.delenv(name, raising=False)
        with contextlib.redirect_stdout(buf):
            t_cli.main(ws["torch_cfg"], ws["dk"], ws["ln"], ws["init_w"], device="cpu")
    finally:
        mp.undo()
    return buf.getvalue(), os.path.join(ws["root"], "tbackupfix_novel0_neg1")


def test_main_runs_epochs_prints_loss_lines_and_saves_weights(ws, torch_run):
    out, backup = torch_run
    lines = _loss_lines(out)
    per_epoch = N_IMAGES // 4
    assert len(lines) == 2 * per_epoch
    assert [int(m.group(1)) for m in lines] == [4 * (i + 1) for i in range(2 * per_epoch)]
    assert all(np.isfinite(float(m.group(11))) for m in lines)
    assert "epoch 0/2, processed 0 samples, lr 0.000003" in out  # 0.0001 * 0.1 / factor 3
    assert "factor: 3.0" in out
    assert sorted(os.listdir(backup)) == ["000001.weights", "000002.weights"]
    for epoch in (1, 2):
        dp, lp, header = _load(ws, os.path.join(backup, f"{epoch:06d}.weights"))
        assert header.seen == epoch * N_IMAGES
        assert all(np.isfinite(p["w"]).all() for p in dp + lp if p and "w" in p)
    start = ws["params"]["darknet"][0]["w"]
    assert np.abs(np.asarray(dp[0]["w"]) - np.asarray(start)).max() > 0  # it trained


def test_loss_lines_and_checkpoint_match_the_jax_cli(ws, torch_run, monkeypatch, capsys):
    out, backup = torch_run
    _pin_clock(monkeypatch)
    for name in ("FSD_NOAUG", "FSD_DTYPE", "FSD_INPUT_U8", "FSD_REMAT", "FSD_WORKERS",
                 "FSD_NATIVE", "FSD_ORBAX_DIR", "FSD_WARM", "FSD_OVERLAP_METRICS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(j_cli, "replica_layout", lambda batch_size: (1, batch_size))
    capsys.readouterr()
    j_cli.main(ws["jax_cfg"], ws["dk"], ws["ln"], ws["init_w"])
    want = _loss_lines(capsys.readouterr().out)
    got = _loss_lines(out)
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.group(1, 2) == w.group(1, 2)  # seen, nGT
        np.testing.assert_allclose([float(v) for v in g.groups()[4:]],
                                   [float(v) for v in w.groups()[4:]],
                                   rtol=1e-4 if i < 6 else 1e-2, atol=2e-6, err_msg=g.group(0))
    jbackup = os.path.join(ws["root"], "jbackupfix_novel0_neg1")
    ta, tb, th = _load(ws, os.path.join(backup, "000001.weights"))
    ja, jb, jh = _load(ws, os.path.join(jbackup, "000001.weights"))
    assert th.seen == jh.seen
    n = 0
    for tp, jp in zip(ta + tb, ja + jb):
        if tp is None:
            continue
        for k in ("w", "b"):
            if k in tp:
                a, b = np.asarray(tp[k]), np.asarray(jp[k])
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max())
                n += 1
        for k in tp.get("bn", {}):
            a, b = np.asarray(tp["bn"][k]), np.asarray(jp["bn"][k])
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max(), err_msg=k)
            n += 1
    assert n > 30


def test_second_run_resumes_from_the_saved_seen(ws, torch_run, capsys):
    """Base training (no tuning) restores the schedule from the header:
    epoch and batch counters start at seen // nsamples and seen // batch."""
    _, backup = torch_run
    capsys.readouterr()
    t_cli.main(ws["base_cfg"], ws["dk_base"], ws["ln"], os.path.join(backup, "000002.weights"),
               device="cpu")
    out = capsys.readouterr().out
    nsamples = int(re.search(r"^\S+ \S+ 1 (\d+) 20 4$", out, re.M).group(1))
    assert 0 < nsamples < N_IMAGES  # images with novel classes only are filtered
    seen = 2 * N_IMAGES
    max_epochs = 20 * 4 // nsamples + 1
    assert max_epochs > seen // nsamples
    assert f"epoch {seen // nsamples}/{max_epochs}, processed" in out
    assert f"epoch {seen // nsamples - 1}/" not in out
    lines = _loss_lines(out)
    assert len(lines) == (max_epochs - seen // nsamples) * (nsamples // 4)
    assert int(lines[0].group(1)) == seen + 4
    # processed_batches = 48 // 4 = 12 is past step 5 of the tiny schedule: lr 0.0001 / 3
    assert ", lr 0.000033" in out


def test_overlap_metrics_prints_the_same_lines_one_step_late(ws, torch_run, monkeypatch, capsys):
    _pin_clock(monkeypatch)
    monkeypatch.setenv("FSD_OVERLAP_METRICS", "1")
    capsys.readouterr()
    t_cli.main(ws["torch_cfg"], ws["dk"], ws["ln"], ws["init_w"], device="cpu")
    got = [m.group(0) for m in _loss_lines(capsys.readouterr().out)]
    assert got == [m.group(0) for m in _loss_lines(torch_run[0])]


def test_two_replica_groups_run_on_one_device(ws, capsys):
    """`main(..., n_groups=2)`: the batch of 4 becomes two groups of 2, each
    with its own support set, run one after another."""
    capsys.readouterr()
    t_cli.main(ws["torch_cfg"], ws["dk"], ws["ln"], ws["init_w"], device="cpu", n_groups=2)
    lines = _loss_lines(capsys.readouterr().out)
    assert len(lines) == 12
    assert all(np.isfinite(float(m.group(11))) and int(m.group(2)) > 0 for m in lines)


@pytest.mark.parametrize("name", ["FSD_NATIVE", "FSD_NATIVE_BATCH", "FSD_WORKERS", "FSD_ORBAX_DIR"])
def test_waiting_switch_raises_not_implemented(ws, monkeypatch, name):
    """These switches waited for their parts, and the CLI refused them; the
    parts are ported now (their runs: test_torch_native_cli.py,
    test_torch_checkpoint.py), so none is refused any more: the CLI goes on
    to read its data cfg."""
    monkeypatch.setenv(name, "/tmp/x" if name == "FSD_ORBAX_DIR" else "1")
    t_cli.refuse_device_list("cpu")
    with pytest.raises(FileNotFoundError, match="no_such.data"):
        t_cli.main(os.path.join(ws["root"], "no_such.data"), ws["dk"], ws["ln"], ws["init_w"], device="cpu")


def test_more_than_one_device_raises_not_implemented(ws):
    with pytest.raises(NotImplementedError, match="more than one device"):
        t_cli.main(ws["torch_cfg"], ws["dk"], ws["ln"], ws["init_w"], device=["cuda:0", "cuda:1"])


def test_episode_batch_layout_and_dtypes(monkeypatch):
    import torch

    rng = np.random.RandomState(0)
    imgs = rng.rand(4, 8, 8, 3).astype(np.float32)
    labels = np.zeros((4, 3, 250), np.float32)
    labels[0, 1, :5] = [1, 0.5, 0.5, 0.2, 0.2]
    metax = rng.rand(6, 8, 8, 3).astype(np.float32)
    mask = (rng.rand(6, 8, 8, 1) > 0.5).astype(np.float32)
    monkeypatch.delenv("FSD_INPUT_U8", raising=False)
    b = t_cli.make_episode_batch(imgs, labels, metax, mask, 2, "full", None, dtype="bfloat16")
    assert b["x"].shape == (2, 2, 8, 8, 3) and b["x"].dtype == torch.bfloat16
    assert b["metax"].shape == (2, 3, 8, 8, 3) and b["mask"].shape == (2, 3, 8, 8, 1)
    assert b["target"].shape == (2, 2, 3, 50, 5) and b["keep"].shape == (2, 6)
    jb = j_cli.make_episode_batch(imgs, labels, metax, mask, 2, "full", None, dtype="bfloat16")
    np.testing.assert_array_equal(b["x"].float().numpy(), np.asarray(jb["x"]).astype(np.float32))
    monkeypatch.setenv("FSD_INPUT_U8", "1")
    u = t_cli.make_episode_batch(imgs, labels, metax[:3], mask[:3], 1, 1, np.random.RandomState(1))
    ju = j_cli.make_episode_batch(imgs, labels, metax[:3], mask[:3], 1, 1, np.random.RandomState(1))
    assert u["x"].dtype == torch.uint8
    np.testing.assert_array_equal(u["x"].numpy(), np.asarray(ju["x"]))
    np.testing.assert_array_equal(u["keep"], ju["keep"])


def test_schedule_and_replica_layout():
    net = {"batch": "64", "max_batches": "80000", "learning_rate": "0.001", "momentum": "0.9",
           "decay": "0.0005", "steps": "-1,500,40000,60000", "scales": "0.1,10,.1,.1"}
    s = t_cli.schedule_from_cfg(net, 1, 15)
    assert s.factor == 3.0 and s.weight_decay == pytest.approx(0.0005 * 64 * 3)
    assert s.lr(0) == pytest.approx(0.001 / 3 * 0.1 / 64)
    assert s.lr(925) == pytest.approx(0.001 / 3 / 64)
    assert t_cli.schedule_from_cfg(net, 2, 15).factor == 15.0
    assert t_common.replica_layout(64) == (1, 64)
    assert t_common.replica_layout(64, 4) == (4, 16)
    # a group count that does not divide the batch raises: the JAX
    # package's fallback to one group means nothing for N processes
    with pytest.raises(ValueError, match="divide the batch"):
        t_common.replica_layout(6, 4)
    # in a world of N ranks: N groups by default, or a multiple of N
    world = types.SimpleNamespace(size=2)
    assert t_common.replica_layout(64, mesh=world) == (2, 32)
    assert t_common.replica_layout(64, 4, world) == (4, 16)
    with pytest.raises(ValueError, match="split over 2 ranks"):
        t_common.replica_layout(63, 3, world)
    with pytest.raises(ValueError, match="divide the batch"):
        t_common.replica_layout(6, 4, world)
