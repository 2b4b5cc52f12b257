"""`scripts/multiscale_epoch_torch.py` against the JAX package's
`scripts/multiscale_epoch.py`, on the CPU.

- Phase B's stream: the port's `episodes` and the JAX tool's generator (the
  same lines, on the JAX package's datasets) over one painted tree with
  `seen` past the multi-scale threshold give the same sequence of image
  shapes, and the same arrays, batch for batch: the sizes drawn every 64
  samples follow the order of the `random.Random(9)` draws in both
  datasets. Data only.
- The whole tool on the CPU, with the tiny cfgs and two sizes in phase A (a
  batch of 2, 3 batches of phase B): its MSJSON line has the JAX tool's
  keys (read from that script's source: its result dicts), every number
  finite, and no peak memory on the CPU."""

import ast
import json
import math
import os
import random
import runpy

import numpy as np

from fewshot_detection_tpu.config import Settings as JSettings
from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.config import read_data_cfg as j_read_data_cfg
from fewshot_detection_tpu.data import datasets as jds
from fewshot_detection_tpu_torch.config import Settings, parse_cfg, read_data_cfg
from fewshot_detection_tpu_torch.data.synth import make_voc_like

from torch_port_util import REPO, cfg

PORT_PATH = os.path.join(REPO, "scripts", "multiscale_epoch_torch.py")
JAX_PATH = os.path.join(REPO, "scripts", "multiscale_epoch.py")
PORT = runpy.run_path(PORT_PATH, run_name="port")


def _jax_episodes(train_list, traindict, settings, batch):
    """scripts/multiscale_epoch.py's `episodes`, line for line."""
    prng = random.Random(9)
    while True:
        ds = jds.DetectionDataset(
            open(train_list).read().split(), settings,
            train=True, seen=PORT["SEEN0"], shuffle=False, rng=prng,
            filter_valid=False,
        )
        metaset = jds.MetaDataset(traindict, settings, train=True,
                                  num_replicas=1, rng=prng)
        meta_iter = metaset.batches(PORT["N_CLS"])
        for imgs, labels in ds.batches(batch):
            yield imgs, labels, next(meta_iter)


def test_phase_b_stream_equals_the_jax_tools(tmp_path):
    d = make_voc_like(str(tmp_path / "voc"), n_images=40, size=(48, 40), seed=5, style="shape")
    datacfg = str(tmp_path / "m.data")
    with open(datacfg, "w") as f:
        f.write(f"metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={d['traindict']}\ntrain={d['train_list']}\n"
                f"backup={tmp_path}/backup\ngpus=0\n")
    dk = cfg("darknet_dynamic.cfg")
    settings = Settings.configure(read_data_cfg(datacfg), parse_cfg(dk)[0], None)
    jsettings = JSettings.configure(j_read_data_cfg(datacfg), j_parse_cfg(dk)[0], None)
    port = PORT["episodes"](d["train_list"], d["traindict"], settings, 8)
    jax = _jax_episodes(d["train_list"], d["traindict"], jsettings, 8)
    shapes = []
    for _ in range(13):  # 104 samples: into the second block of 64
        (imgs, labels, (metax, mask)), (j_imgs, j_labels, (j_metax, j_mask)) = next(port), next(jax)
        assert imgs.shape == j_imgs.shape and metax.shape == j_metax.shape
        for a, b in ((imgs, j_imgs), (labels, j_labels), (metax, j_metax), (mask, j_mask)):
            np.testing.assert_array_equal(a, b)
        shapes.append(imgs.shape[1:3])
    assert len(set(shapes)) >= 2, shapes
    assert {s[0] for s in shapes} <= set(PORT["SIZES"])


def _jax_result_keys():
    """The keys of the JAX tool's result dicts, from its source: the
    bucket's, the result's (with "epoch") and the epoch's."""
    tree = ast.parse(open(JAX_PATH).read())
    keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = ast.unparse(node.targets[0])
            keys[target] = {k.value for k in node.value.keys}
    return keys["buckets[size]"], keys["result"] | {"epoch"}, keys["result['epoch']"]


def test_msjson_has_the_jax_tools_keys(tmp_path, monkeypatch, capsys):
    main = PORT["main"]
    glb = main.__globals__
    monkeypatch.setitem(glb, "DARKNET_CFG", cfg("tiny_darknet_dynamic.cfg"))
    monkeypatch.setitem(glb, "LEARNET_CFG", cfg("tiny_reweighting.cfg"))
    monkeypatch.setitem(glb, "SIZES", [64, 96])
    result = main(["--batch", "2", "--batches", "3", "--root", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu cpu"
    assert json.loads(out[-1][len("MSJSON "):]) == json.loads(json.dumps(result))
    bucket_keys, result_keys, epoch_keys = _jax_result_keys()
    assert set(result) == result_keys
    assert list(result["buckets"]) == [64, 96]
    for b in result["buckets"].values():
        assert set(b) == bucket_keys and b["peak_hbm_gib"] is None
        assert all(math.isfinite(b[k]) for k in ("first_step_s", "cached_step_ms", "img_per_s"))
    assert set(result["epoch"]) == epoch_keys
    assert result["epoch"]["batches"] == 3 and result["epoch"]["steady_img_per_s"] > 0
    assert set(result["epoch"]["sizes_crossed"]) <= set(range(320, 609, 32))
