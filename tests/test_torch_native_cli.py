"""Both training CLIs of the port on image files through the native loader
in worker processes (FSD_NATIVE=1, FSD_NATIVE_BATCH=1, FSD_WORKERS=2),
beside the JAX package's CLIs under the same switches.

Both draw the same batches (the same C++ decode and augmentation, the same
per-worker random streams), so the loss lines must agree within the bounds
that tests/test_torch_train_cli.py and tests/test_torch_plain_cli.py state
for the PIL path: rtol 1e-4 (atol 2e-6) on the first epoch's lines and 1e-2
on the second's, a float32 rounding difference that grows from step to
step on a run from random weights. The meta run's learning rate is a tenth
of test_torch_train_cli.py's: on these images the drift at that file's rate
grows to 1.3e-2 by the tenth line and 3e-2 by the twelfth (measured on the
CPU), while at this rate it is 3e-7 on the first line and 3e-3 on the
twelfth, as that file measured for its own images."""

import contextlib
import dataclasses
import io
import os
import re
import shutil
import types

import numpy as np
import pytest

from fewshot_detection_tpu.cli import train_meta_cli as j_meta
from fewshot_detection_tpu.cli import train_plain_cli as j_plain
from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import weights_io as j_weights_io
from fewshot_detection_tpu.models.darknet import init_params as j_init_params
from fewshot_detection_tpu.models.meta import MetaSpec as JMetaSpec
from fewshot_detection_tpu.models.meta import init_meta_params as j_init_meta_params
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu_torch.cli import train_meta_cli as t_meta
from fewshot_detection_tpu_torch.cli import train_plain_cli as t_plain

from synth import make_voc_like
from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import REPO, jax_native_loader

LOSS_LINE = re.compile(
    r"^(\d+): nGT (\d+), recall (\d+), proposals (\d+), loss: x ([\d.]+), y ([\d.]+), "
    r"w ([\d.]+), h ([\d.]+), conf ([\d.]+), cls ([\d.]+), total ([\d.]+)$")
NATIVE = {"FSD_NATIVE": "1", "FSD_NATIVE_BATCH": "1", "FSD_WORKERS": "2"}
CLEARED = ("FSD_NOAUG", "FSD_DTYPE", "FSD_INPUT_U8", "FSD_REMAT", "FSD_BN_DARKNET",
           "FSD_CLIP_NORM", "FSD_ORBAX_DIR", "FSD_PROFILE_DIR", "FSD_WARM",
           "FSD_OVERLAP_METRICS", "FSD_ASYNC_CKPT")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    jax_native_loader()
    root = tmp_path_factory.mktemp("nativecli")
    d = make_voc_like(str(root / "voc"), n_images=24, seed=0)
    shot_dict = str(root / "traindict_3shot.txt")
    shutil.copy(d["traindict"], shot_dict)
    dk = str(root / "tiny_dd.cfg")
    with open(os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg")) as f:
        txt = f.read().replace("max_batches=100", "max_batches=8")
    with open(dk, "w") as f:
        f.write(txt.replace("learning_rate=0.001", "learning_rate=0.00001"))
    ln = os.path.join(REPO, "cfg/tiny_reweighting.cfg")
    plain = str(root / "tiny_plain.cfg")
    with open(plain, "w") as f:
        f.write(TINY_PLAIN_CFG)

    def datacfg(name, extra):
        path = str(root / f"{name}.data")
        with open(path, "w") as f:
            f.write(
                "data=voc\nneg=1\nrand=0\nscale=0\n" + extra +
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={shot_dict}\ntrain={d['train_list']}\nvalid={d['train_list']}\n"
                f"backup={root}/{name}\ngpus=0\n")
        return path

    mspec = JMetaSpec(j_build_spec(j_parse_cfg(dk)), j_build_spec(j_parse_cfg(ln)))
    mparams = j_init_meta_params(mspec, 0)
    meta_w = str(root / "meta.weights")
    j_weights_io.save_weights(meta_w, [mspec.darknet, mspec.learnet],
                              [mparams["darknet"], mparams["learnet"]], seen=0)
    pspec = j_build_spec(j_parse_cfg(plain))
    plain_w = str(root / "plain.weights")
    j_weights_io.save_weights(plain_w, [pspec], [j_init_params(pspec, 0)], seen=0)
    tune = "metayolo=1\nmetain_type=2\ntuning=1\nmax_epoch=2\nrepeat=1\ndynamic=0\n"
    return {"root": str(root), "dk": dk, "ln": ln, "plain": plain, "meta_w": meta_w,
            "plain_w": plain_w,
            "meta": {m: datacfg(f"meta_{m}", tune) for m in ("torch", "jax")},
            "plain_cfg": {m: datacfg(f"plain_{m}", "metayolo=0\n") for m in ("torch", "jax")}}


def _losses(text):
    return [m for m in (LOSS_LINE.match(l) for l in text.splitlines()) if m]


def _run(monkeypatch, mod, call, env):
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1234.0))
    for name in CLEARED:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        call()
    return buf.getvalue()


def _assert_close(got, want, n, first_epoch):
    assert len(got) == len(want) == n
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.group(1, 2) == w.group(1, 2)  # seen, nGT
        np.testing.assert_allclose([float(v) for v in g.groups()[4:]],
                                   [float(v) for v in w.groups()[4:]],
                                   rtol=1e-4 if i < first_epoch else 1e-2, atol=2e-6,
                                   err_msg=g.group(0))


def test_meta_cli_on_native_workers_matches_the_jax_cli(ws, monkeypatch):
    got = _run(monkeypatch, t_meta, lambda: t_meta.main(
        ws["meta"]["torch"], ws["dk"], ws["ln"], ws["meta_w"], device="cpu"), NATIVE)
    monkeypatch.setattr(j_meta, "replica_layout", lambda batch_size: (1, batch_size))
    want = _run(monkeypatch, j_meta, lambda: j_meta.main(
        ws["meta"]["jax"], ws["dk"], ws["ln"], ws["meta_w"]), NATIVE)
    _assert_close(_losses(got), _losses(want), 12, 6)
    # the epoch's phase line, as the JAX CLI prints it
    timer = re.compile(r" data [\d.]+s .* \| step .* \| sync .* \| [\d.]+ images/s$")
    assert sum(bool(timer.search(l)) for l in got.splitlines()) == 2
    assert sum(bool(timer.search(l)) for l in want.splitlines()) == 2


def test_plain_cli_on_native_workers_matches_the_jax_cli(ws, monkeypatch):
    def every_epoch(mod):
        resolve = mod.resolve_configs

        def wrapped(*args):
            opts, blocks, learnet, settings = resolve(*args)
            return opts, blocks, learnet, dataclasses.replace(settings, save_interval=1)
        monkeypatch.setattr(mod, "resolve_configs", wrapped)

    every_epoch(t_plain)
    got = _run(monkeypatch, t_plain, lambda: t_plain.main(
        ws["plain_cfg"]["torch"], ws["plain"], ws["plain_w"], device="cpu"), NATIVE)
    every_epoch(j_plain)
    monkeypatch.setattr(j_plain, "replica_layout", lambda batch_size: (1, batch_size))
    want = _run(monkeypatch, j_plain, lambda: j_plain.main(
        ws["plain_cfg"]["jax"], ws["plain"], ws["plain_w"]), NATIVE)
    n = len(_losses(want))
    assert n >= 8
    _assert_close(_losses(got), _losses(want), n, n // 2)
    assert sorted(os.listdir(os.path.join(ws["root"], "plain_torchfix_novel0"))) == \
        sorted(os.listdir(os.path.join(ws["root"], "plain_jaxfix_novel0")))

