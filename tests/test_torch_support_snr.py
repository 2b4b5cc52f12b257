"""`scripts/support_snr_torch.py` against the JAX package's
`scripts/support_snr.py`, on the CPU: one datacfg (a painted VOC tree, 15
base classes), the tiny cfgs, and one `.weights` file of seeded parameters
(BN statistics randomised) through both `measure`s.

- The codes of every draw (recorded from the JAX tool's `meta_forward`)
  within 1e-4 of the largest absolute code: the same augmented support
  batches (one `random.Random(99)` through both datasets), float32
  training-mode BatchNorm in both (the port's through the plain `bn_sums`).
- The summary: `nn_acc`, `n_cls`, `n_draws` and `chance` equal; `within`,
  `across` and `ratio` within 2e-3 (each is rounded to 3 decimals, so one
  side may round the other way).
- The port's `main` prints `measure`'s JSON line; the CLI's argv is the JAX
  tool's with `--device`."""

import json
import os
import runpy

import numpy as np
import pytest

import fewshot_detection_tpu.models.meta as j_meta
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.data.synth import make_voc_like
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
from fewshot_detection_tpu_torch.models.spec import build_spec

from torch_port_util import REPO, cfg, randomize_bn

PORT = runpy.run_path(os.path.join(REPO, "scripts", "support_snr_torch.py"), run_name="port")
JAX = runpy.run_path(os.path.join(REPO, "scripts", "support_snr.py"), run_name="jax")
DK, LN = cfg("tiny_darknet_dynamic.cfg"), cfg("tiny_reweighting.cfg")
N_DRAWS = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("snr"))
    d = make_voc_like(os.path.join(root, "voc"), n_images=40, size=(80, 64), seed=3,
                      style="huebin", box_range=(0.2, 0.5))
    datacfg = os.path.join(root, "meta.data")
    with open(datacfg, "w") as f:
        f.write("metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={d['traindict']}\ntrain={d['train_list']}\nbackup={root}/backup\n"
                "gpus=0\n")
    spec = MetaSpec(build_spec(parse_cfg(DK)), build_spec(parse_cfg(LN)))
    params = init_meta_params(spec, 3)
    rng = np.random.default_rng(4)
    randomize_bn(params["darknet"], rng)
    randomize_bn(params["learnet"], rng)
    wpath = os.path.join(root, "init.weights")
    weights_io.save_weights(wpath, [spec.darknet, spec.learnet],
                            [params["darknet"], params["learnet"]])
    return datacfg, wpath


def test_codes_and_summary_equal_the_jax_tools(setup, monkeypatch):
    datacfg, wpath = setup
    recorded = []
    forward = j_meta.meta_forward

    def record(*args, **kw):
        dw, aux = forward(*args, **kw)
        recorded.append([np.asarray(w, np.float32) for w in dw])
        return dw, aux

    monkeypatch.setattr(j_meta, "meta_forward", record)
    want = JAX["measure"](datacfg, DK, LN, wpath, n_draws=N_DRAWS)
    codes = PORT["draw_codes"](datacfg, DK, LN, wpath, n_draws=N_DRAWS, device="cpu")
    got = PORT["summarize"](codes)

    n_cls = want["n_cls"]
    want_codes = np.stack([np.concatenate([w.reshape(n_cls, -1) for w in dw], axis=1)
                           for dw in recorded])
    assert codes.shape == want_codes.shape == (N_DRAWS, n_cls, codes.shape[-1])
    scale = float(np.abs(want_codes).max())
    assert scale > 0
    assert float(np.abs(codes - want_codes).max()) <= 1e-4 * scale
    for key in ("n_cls", "n_draws", "chance", "nn_acc"):
        assert got[key] == want[key], key
    for key in ("within", "across", "ratio"):
        assert abs(got[key] - want[key]) <= 2e-3, key
    assert got["within"] > 0 and got["across"] > 0


def test_main_prints_the_measure(setup, capsys):
    datacfg, wpath = setup
    PORT["main"](["support_snr_torch.py", datacfg, DK, LN, wpath, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == PORT["measure"](datacfg, DK, LN, wpath, device="cpu")
    assert line["n_draws"] == 6
