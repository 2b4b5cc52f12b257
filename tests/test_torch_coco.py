"""The COCO protocol of the port against the JAX package's, on the CPU: the
counterparts of tests/test_coco_layout.py, test_coco_rich.py and
test_e2e_coco.py.

- `Settings.configure` on `data=coco` (80 names, save interval 2, the
  novel splits, base classes at training, eval and tuning) and the
  `labels_1c/train2014/<class>/` label paths are EQUAL.
- `MetaDataset` on a COCO tree gives EQUAL arrays for one `random.Random`,
  at training (factor-4 support sampling) and at eval.
- `data/synth.py`'s `make_coco_like` and `make_coco_rich` write the trees
  of tests/synth.py (PNG compared as pixels, text byte for byte).
- `models/weights_io.load_conv_from_coco` gives EQUAL arrays.
- The tiny COCO meta training at 64 px (test_e2e_coco.py's cfgs: 60 base
  classes of novel split 2) through both CLIs with pinned clocks: the loss
  lines within tests/test_torch_train_cli.py's bounds (rtol 1e-4 on the
  first epoch's, 1e-2 after; atol 2e-6; measured: 4.4e-7 to 1.2e-6 of each
  value over the run's four lines). Then both `run_valid_ensemble`
  sweeps from the JAX run's checkpoint write 60 result files, the same
  lines with the printed floats within 1e-4 (both compute in float32; as
  tests/test_torch_valid_ensemble.py)."""

import os
import random
import re
import types

import numpy as np
import pytest
from PIL import Image

from fewshot_detection_tpu.cli import train_meta_cli as j_cli
from fewshot_detection_tpu.cli.common import resolve_configs as j_resolve
from fewshot_detection_tpu.config import Settings as JSettings
from fewshot_detection_tpu.data.datasets import MetaDataset as JMeta
from fewshot_detection_tpu.data.datasets import get_labpath_1c as j_labpath_1c
from fewshot_detection_tpu.eval import valid as j_valid
from fewshot_detection_tpu.models import weights_io as j_weights_io
from fewshot_detection_tpu.models.spec import LayerSpec as JLayerSpec
from fewshot_detection_tpu_torch.cli import train_meta_cli as t_cli
from fewshot_detection_tpu_torch.cli.common import resolve_configs
from fewshot_detection_tpu_torch.config.settings import Settings, get_novels, load_class_names
from fewshot_detection_tpu_torch.data import synth as tsynth
from fewshot_detection_tpu_torch.data.datasets import MetaDataset, get_labpath_1c
from fewshot_detection_tpu_torch.eval import valid as t_valid
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
from fewshot_detection_tpu_torch.models.spec import LayerSpec, build_spec

import synth as jsynth
from torch_port_util import REPO, assert_results_close, in_env, read_results

SWEEP_TOL = 1e-4
LOSS_LINE = re.compile(
    r"^(\d+): nGT (\d+), recall (\d+), proposals (\d+), loss: x ([\d.]+), y ([\d.]+), "
    r"w ([\d.]+), h ([\d.]+), conf ([\d.]+), cls ([\d.]+), total ([\d.]+)$")
CLEAN_ENV = ("FSD_NOAUG", "FSD_DTYPE", "FSD_INPUT_U8", "FSD_REMAT", "FSD_WORKERS", "FSD_NATIVE",
             "FSD_NATIVE_BATCH", "FSD_ORBAX_DIR", "FSD_WARM", "FSD_OVERLAP_METRICS",
             "FSD_BN_DARKNET", "FSD_EVAL_BATCH", "FSD_WARMUP_SEEN")


def _coco_opts(**kw):
    opts = {"metayolo": "1", "metain_type": "2", "data": "coco", "neg": "1", "rand": "0",
            "novel": "data/coco_novels.txt", "novelid": "0",
            "meta": "data/coco_traindict_full.txt", "train": "x", "backup": "b", "gpus": "0"}
    opts.update(kw)
    return opts


NET = {"height": "416", "width": "416", "batch": "64"}
META = {"height": "416", "width": "416", "feat_layer": "0", "channels": "4"}


@pytest.mark.parametrize("kw", [
    {}, {"novelid": "2"}, {"novelid": "3"},
    {"novelid": "2", "tuning": "1", "max_epoch": "4", "repeat": "2",
     "meta": "coco_traindict_bbox_10shot.txt", "neg": "0"},
    {"novelid": "1", "tuning": "1", "max_epoch": "500", "repeat": "1",
     "meta": "x_30shot.txt", "scale": "0"},
], ids=["split0", "split2", "split3", "tune2", "tune1_fix"])
def test_coco_settings_equal(kw, monkeypatch):
    monkeypatch.chdir(REPO)  # data/coco_novels.txt, as the JAX test reads it
    monkeypatch.delenv("FSD_WARMUP_SEEN", raising=False)
    got = vars(Settings.configure(_coco_opts(**kw), NET, META))
    want = vars(JSettings.configure(_coco_opts(**kw), NET, META))
    assert got == {k: want[k] for k in got}
    assert got["classes"] == load_class_names("coco") and got["save_interval"] == 2
    n_base = 80 if kw.get("tuning") else 80 - len(got["novel_classes"])
    assert len(got["base_classes"]) == n_base
    if kw.get("novelid") == "2":
        assert len(got["novel_classes"]) == 20


@pytest.mark.parametrize("path,cls", [
    ("/d/images/train2014/COCO_x_1.jpg", "zebra"),
    ("/d/images/val2014/COCO_y_2.jpg", "cake"),
    ("/d/images/train2014/COCO_z_3.png", "traffic light"),
])
def test_coco_labpath_1c_equal(path, cls):
    assert get_labpath_1c(path, cls, "coco") == j_labpath_1c(path, cls, "coco")
    assert "/labels_1c/" in get_labpath_1c(path, cls, "coco")


def test_coco_labpath_1c_refuses_other_trees():
    for fn in (get_labpath_1c, j_labpath_1c):
        with pytest.raises(ValueError):
            fn("/d/other/x.jpg", "cake", "coco")


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


@pytest.mark.parametrize("fn,kw", [
    ("make_coco_rich", dict(n_images=170, size=(48, 40), seed=5)),
    ("make_coco_rich", dict(n_images=90, size=(32, 32), seed=2, classes_per_image=3,
                            box_range=(0.1, 0.3))),
    ("make_coco_like", dict(class_ids=[3, 7, 79, 0, 5, 41], size=(64, 48), seed=2, n_train=4)),
], ids=["rich", "rich3", "like"])
def test_synth_trees_equal_the_reference(tmp_path, fn, kw):
    a, b = str(tmp_path / "j"), str(tmp_path / "t")
    da, db = getattr(jsynth, fn)(a, **kw), getattr(tsynth, fn)(b, **kw)
    assert _tree(a) == _tree(b) and len(_tree(a)) > 10
    assert [os.path.relpath(p, a) for p in da["img_paths"]] == \
        [os.path.relpath(p, b) for p in db["img_paths"]]
    for rel in _tree(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)))
        else:  # labels, labels_1c, lists, traindict, devkit: root-relative text
            with open(pa) as fa, open(pb) as fb:
                assert fa.read().replace(a, "ROOT") == fb.read().replace(b, "ROOT"), rel
    if fn == "make_coco_rich":
        assert da["names"] == db["names"] == list(load_class_names("coco"))
        assert len({tsynth.coco_identity(c) for c in range(80)}) == 80


def test_load_conv_from_coco_equal():
    coco, voc = list(load_class_names("coco")), list(load_class_names("voc"))
    vocids = [coco.index(c) for c in voc]
    rng = np.random.RandomState(0)
    lead = rng.randn(7).astype(np.float32)  # the head starts mid-buffer
    buf = np.concatenate([lead, rng.randn(425).astype(np.float32),
                          rng.randn(425 * 1024).astype(np.float32), lead])
    layer = LayerSpec(index=0, kind="conv", in_channels=1024, out_channels=125, size=1)
    jlayer = JLayerSpec(index=0, kind="conv", in_channels=1024, out_channels=125, size=1)
    p, end = weights_io.load_conv_from_coco(buf, 7, layer, vocids)
    jp, jend = j_weights_io.load_conv_from_coco(buf, 7, jlayer, vocids)
    assert end == jend == 7 + 425 + 425 * 1024
    assert p["w"].shape == (1, 1, 1024, 125) and p["b"].shape == (125,)
    np.testing.assert_array_equal(p["w"], jp["w"])
    np.testing.assert_array_equal(p["b"], jp["b"])
    # anchor 1's first class channel is COCO channel 85 + 5 + vocids[0]
    np.testing.assert_array_equal(p["b"][25 + 5], buf[7 + 85 + 5 + vocids[0]])


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """test_e2e_coco.py's workspace: one image a base class of split 2 in
    the COCO layout (painted by the port's synth), tiny cfgs at 64 px with
    max_batches 3, one starting `.weights` file."""
    root = tmp_path_factory.mktemp("e2e_coco_torch")
    names = tsynth.load_coco_names()
    novels = get_novels(os.path.join(REPO, "data/coco_novels.txt"), "2")
    base_ids = [i for i, n in enumerate(names) if n not in novels]
    assert len(base_ids) == 60
    d = tsynth.make_coco_like(str(root / "coco"), base_ids, seed=0, n_train=8)
    dk = str(root / "tiny_dd.cfg")
    with open(os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg")) as f:
        txt = (f.read().replace("max_batches=100", "max_batches=3")
               .replace("height=128", "height=64").replace("width=128", "width=64"))
    with open(dk, "w") as f:
        f.write(txt)
    ln = str(root / "tiny_rw.cfg")
    with open(os.path.join(REPO, "cfg/tiny_reweighting.cfg")) as f:
        txt = f.read().replace("height=128", "height=64").replace("width=128", "width=64")
    with open(ln, "w") as f:
        f.write(txt)

    def datacfg(name, backup):
        path = str(root / name)
        with open(path, "w") as f:
            f.write("metayolo=1\nmetain_type=2\ndata=coco\nneg=1\nrand=0\n"
                    f"novel={REPO}/data/coco_novels.txt\nnovelid=2\n"
                    f"meta={d['traindict']}\ntrain={d['train_list']}\n"
                    f"valid={d['valid_list']}\nbackup={root}/{backup}\ngpus=0\n")
        return path

    _, darknet, learnet, _ = resolve_configs(datacfg("probe.data", "probe"), dk, ln)
    spec = MetaSpec(build_spec(darknet), build_spec(learnet))
    params = init_meta_params(spec, 0)
    init_w = str(root / "init.weights")
    weights_io.save_weights(init_w, [spec.darknet, spec.learnet],
                            [params["darknet"], params["learnet"]], seen=0)
    return {"root": str(root), "data": d, "dk": dk, "ln": ln, "init_w": init_w,
            "base": [names[i] for i in base_ids],
            "torch_cfg": datacfg("torch.data", "tbackup"),
            "jax_cfg": datacfg("jax.data", "jbackup")}


def _settings(ws, which):
    return resolve_configs(ws[f"{which}_cfg"], ws["dk"], ws["ln"])[3], \
        j_resolve(ws[f"{which}_cfg"], ws["dk"], ws["ln"])[3]


def test_coco_protocol_settings(ws):
    t, j = _settings(ws, "torch")
    assert vars(t) == {k: vars(j)[k] for k in vars(t)}
    assert t.data == "coco" and len(t.classes) == 80 and len(t.base_classes) == 60
    assert t.save_interval == 2 and list(t.base_classes) == ws["base"]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_meta_dataset_support_sets_equal(ws, monkeypatch, train):
    """One random.Random a side: the same support lines (factor 4 at
    training: 60 classes x 4 * 500 * 64 / batch), the same images and masks."""
    for name in CLEAN_ENV:
        monkeypatch.delenv(name, raising=False)
    t_set, j_set = _settings(ws, "torch")
    td = MetaDataset(ws["data"]["traindict"], t_set, train=train, num_replicas=1,
                     rng=random.Random(3))
    jd = JMeta(ws["data"]["traindict"], j_set, train=train, num_replicas=1, rng=random.Random(3))
    assert list(td.classes) == list(jd.classes) == ws["base"]
    factor = 4 if train else 10
    assert len(td.inds) == len(jd.inds) == 60 * (factor * 500 * 64 // t_set.batch_size)
    assert td.inds == jd.inds
    for ds in (td, jd):
        ds.meta_shape = ds.mask_shape = (64, 64)
    for i in (0, 1, 7, len(td) - 1):
        got, want = td[i], jd[i]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert got[1].sum() > 0  # the mask covers the box


def _pin_clock(monkeypatch):
    for mod in (t_cli, j_cli):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1234.0))


def _loss_lines(text):
    return [m for m in (LOSS_LINE.match(line) for line in text.splitlines()) if m]


@pytest.fixture(scope="module")
def trained(ws):
    """Both CLIs on the same start; (port lines, JAX lines, JAX checkpoint)."""
    import contextlib
    import io

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        _pin_clock(mp)
        for name in CLEAN_ENV:
            mp.delenv(name, raising=False)
        mp.setattr(j_cli, "replica_layout", lambda batch_size: (1, batch_size))
        for which, run in (("torch", lambda: t_cli.main(ws["torch_cfg"], ws["dk"], ws["ln"],
                                                         ws["init_w"], device="cpu")),
                           ("jax", lambda: j_cli.main(ws["jax_cfg"], ws["dk"], ws["ln"],
                                                      ws["init_w"]))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run()
            out[which] = _loss_lines(buf.getvalue())
    finally:
        mp.undo()
    backups = {w: os.path.join(ws["root"], f"{w[0]}backup_novel2_neg1") for w in ("torch", "jax")}
    ckpts = {w: sorted(f for f in os.listdir(b) if f.endswith(".weights"))
             for w, b in backups.items()}
    assert ckpts["torch"] == ckpts["jax"] and ckpts["jax"]
    return out["torch"], out["jax"], os.path.join(backups["jax"], ckpts["jax"][-1])


def test_coco_training_loss_lines_match_the_jax_cli(trained):
    got, want, _ = trained
    assert len(got) == len(want) >= 4
    per_epoch = len(want) // 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.group(1, 2) == w.group(1, 2)  # seen, nGT
        np.testing.assert_allclose([float(v) for v in g.groups()[4:]],
                                   [float(v) for v in w.groups()[4:]],
                                   rtol=1e-4 if i < per_epoch else 1e-2, atol=2e-6,
                                   err_msg=g.group(0))


def test_coco_sweep_over_60_classes_matches_the_jax_sweep(ws, trained):
    _, _, ckpt = trained
    env = {"FSD_EVAL_BATCH": "4", **{k: None for k in CLEAN_ENV if k != "FSD_EVAL_BATCH"}}
    t_opts, t_dk, t_ln, t_set = resolve_configs(ws["torch_cfg"], ws["dk"], ws["ln"])
    j_opts, j_dk, j_ln, j_set = j_resolve(ws["torch_cfg"], ws["dk"], ws["ln"])
    got = in_env(ws["root"], env, lambda: os.path.abspath(t_valid.run_valid_ensemble(
        t_opts, t_dk, t_ln, ckpt, t_set, outfile="torch_det_", device="cpu")))
    want = in_env(ws["root"], env, lambda: os.path.abspath(j_valid.run_valid_ensemble(
        j_opts, j_dk, j_ln, ckpt, j_set, outfile="jax_det_")))
    t_files, j_files = read_results(got, "torch_det_"), read_results(want, "jax_det_")
    assert len(j_files) == 60 and sorted(j_files) == sorted(f"{c}.txt" for c in ws["base"])
    n = assert_results_close(t_files, j_files, SWEEP_TOL)
    assert n > 0
