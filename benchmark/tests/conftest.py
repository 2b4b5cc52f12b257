"""Fixtures of the benchmark's CPU tests: a checkout in miniature.

`tiny_root` copies the benchmark's BENCHMARK.json, limits and metric
readers into a temporary directory and gives its cells tiny cfgs (32 px
inputs, the same kinds of layer as the published ones) and a tiny mix,
under the SAME cell names, so that the cells' own limits and readers judge
the tiny runs. Tests that need the card carry the `card` marker and skip
inside the `card` fixture when there is none.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

NET = """[net]
batch=4
width=32
height=32
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.001
steps=-1,500,40000,60000
scales=0.1,10,.1,.1

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-3

[convolutional]
batch_normalize=1
filters=4
size=1
stride=1
pad=1
activation=leaky

[reorg]
stride=2

[route]
layers=-1,-4

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky
"""

META_HEAD = """
[convolutional]
dynamic=1
batch_normalize=0
size=1
stride=1
pad=1
filters=32
activation=linear

[convolutional]
size=1
stride=1
pad=1
filters=30
activation=linear

[region]
anchors = 0.66, 0.87, 1.60, 2.00, 2.53, 4.05, 4.74, 2.42, 5.62, 5.00
classes=1
coords=4
num=5
object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1
thresh = .6
"""

PLAIN_HEAD = """
[convolutional]
size=1
stride=1
pad=1
filters=40
activation=linear

[region]
anchors = 0.66, 0.87, 1.60, 2.00, 2.53, 4.05, 4.74, 2.42, 5.62, 5.00
classes=3
coords=4
num=5
object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1
thresh = .6
"""

LEARNET = """[learnet]
feat_layer=0
channels=4
width=32
height=32

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[globalmax]
"""

TRAIN = {"driver": "train", "batch": 4, "size": 32, "remat": False, "pool": 3, "max_objects": 3,
         "start_batches": 200, "background_noise": [0.235, 0.235], "checked_steps": 3,
         "warmup_steps": 1, "profiled_steps": 2}
def make_tiny_root(root: str) -> str:
    """The miniature checkout under `root` (see the module's docstring)."""
    bdir = os.path.join(root, "benchmark")
    for sub in ("limits", "metrics"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub), os.path.join(bdir, sub))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(root, "BENCHMARK.json"))
    os.makedirs(os.path.join(bdir, "configs", "cfg"))
    os.makedirs(os.path.join(bdir, "traffic"))
    cfgs = {"darknet.cfg": NET + META_HEAD, "learnet.cfg": LEARNET, "plain.cfg": NET + PLAIN_HEAD}
    for name, text in cfgs.items():
        with open(os.path.join(bdir, "configs", "cfg", name), "w") as f:
            f.write(text)
    with open(os.path.join(REPO, "benchmark", "configs", "meta_voc15.json")) as f:
        meta = json.load(f)
    meta.update(darknet_cfg="benchmark/configs/cfg/darknet.cfg",
                learnet_cfg="benchmark/configs/cfg/learnet.cfg", train_classes=3)
    with open(os.path.join(REPO, "benchmark", "configs", "yolov2_voc.json")) as f:
        plain = json.load(f)
    plain.update(darknet_cfg="benchmark/configs/cfg/plain.cfg", classes=3)
    for name, data in (("configs/meta_voc15.json", meta), ("configs/yolov2_voc.json", plain),
                       ("traffic/train_b64.json", TRAIN),
                       ("traffic/train_b384.json", dict(TRAIN, remat=True, batch=6))):
        with open(os.path.join(bdir, name), "w") as f:
            json.dump(data, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
