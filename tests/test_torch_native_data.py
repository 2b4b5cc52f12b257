"""The port's datasets on the native C++ pipeline (FSD_NATIVE=1, and
FSD_NATIVE_BATCH=1 for whole batches) against the JAX package's.

Both packages draw the augmentation from one `random.Random` stream in the
same order and decode/augment through the same C++ code, so for one seed
the arrays, labels and masks must be EQUAL (no tolerance), with the decoded
RAM cache on (the augment-only path) and off (decode from the file each
time)."""

import os
import random

import numpy as np
import pytest

from fewshot_detection_tpu.config import Settings as JSettings
from fewshot_detection_tpu.data import datasets as jds
from fewshot_detection_tpu_torch.config import Settings
from fewshot_detection_tpu_torch.data import datasets as tds

from synth import make_voc_like
from torch_port_util import REPO, jax_native_loader


@pytest.fixture(scope="module")
def voc_dir(tmp_path_factory):
    jax_native_loader()
    return make_voc_like(str(tmp_path_factory.mktemp("voc")), n_images=24, seed=5,
                         size=(80, 60))


def _both(**kw):
    opts = {
        "metayolo": "1", "metain_type": "2", "data": "voc", "neg": "1",
        "rand": "0", "scale": "0", "novel": os.path.join(REPO, "data/voc_novels.txt"),
        "novelid": "0", "meta": "data/voc_traindict_full.txt", "train": "x", "backup": "b",
        "gpus": "0",
    }
    opts.update(kw)
    net = {"height": "64", "width": "64", "batch": "4"}
    meta = {"height": "64", "width": "64", "feat_layer": "0", "channels": "4"}
    return Settings.configure(opts, net, meta), JSettings.configure(opts, net, meta)


@pytest.fixture(params=["cache", "no_cache"])
def native(request, monkeypatch):
    """FSD_NATIVE=1, and a fresh decoded-image cache in both packages (or
    none)."""
    monkeypatch.setenv("FSD_NATIVE", "1")
    monkeypatch.delenv("FSD_NATIVE_BATCH", raising=False)
    monkeypatch.delenv("FSD_NOAUG", raising=False)
    for mod in (tds, jds):
        cache = mod.DecodedCache(1 << 30) if request.param == "cache" else None
        monkeypatch.setattr(mod, "_ram_cache", cache)
        monkeypatch.setattr(mod, "_ram_cache_init", True)
    return request.param


def _assert_batches_equal(ba, bb):
    assert len(ba) == len(bb) > 0
    for xa, xb in zip(ba, bb):
        for u, v in zip(xa, xb):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("train", [True, False])
def test_detection_dataset_equals_jax(voc_dir, native, train):
    s, js = _both()
    kw = dict(train=train, seen=0, shuffle=True, filter_valid=train, shape=(64, 64))
    a = tds.DetectionDataset(voc_dir["train_list"], s, rng=random.Random(3), **kw)
    b = jds.DetectionDataset(voc_dir["train_list"], js, rng=random.Random(3), **kw)
    assert a.native is not None and b.native is not None
    assert a.lines == b.lines
    ba, bb = list(a.batches(4)), list(b.batches(4))
    _assert_batches_equal(ba, bb)
    assert ba[0][0].shape == (4, 64, 64, 3)
    assert a.rng.random() == b.rng.random()  # the streams were consumed alike
    # eval: sizes from the header, no PIL
    assert a.image_size(0) == b.native.image_size(b.lines[0]) == (80, 60)


@pytest.mark.parametrize("train", [True, False])
def test_native_batches_equal_jax_and_the_per_image_path(voc_dir, native, monkeypatch, train):
    s, js = _both(metayolo="0")
    kw = dict(train=train, seen=0, shuffle=False, filter_valid=False, shape=(48, 56))
    per_image = list(tds.DetectionDataset(voc_dir["train_list"], s, rng=random.Random(9),
                                          **kw).batches(5))
    monkeypatch.setenv("FSD_NATIVE_BATCH", "1")
    a = tds.DetectionDataset(voc_dir["train_list"], s, rng=random.Random(9), **kw)
    b = jds.DetectionDataset(voc_dir["train_list"], js, rng=random.Random(9), **kw)
    ba, bb = list(a.batches(5)), list(b.batches(5))
    _assert_batches_equal(ba, bb)
    _assert_batches_equal(ba, per_image)
    assert ba[0][1].shape == (5, 250)
    assert a.seen == b.seen == 20


def test_native_batch_raises_on_a_failed_decode(voc_dir, native, monkeypatch, tmp_path):
    monkeypatch.setenv("FSD_NATIVE_BATCH", "1")
    lines = open(voc_dir["train_list"]).read().split()[:3]
    bad = str(tmp_path / "images" / "broken.png")
    os.makedirs(os.path.dirname(bad))
    with open(lines[0], "rb") as f, open(bad, "wb") as g:
        g.write(f.read()[:120])  # the header is whole, the pixel data is cut
    lines.append(bad)
    s, js = _both()
    for mod, st in ((tds, s), (jds, js)):
        ds = mod.DetectionDataset(lines, st, train=True, shuffle=False,
                                  filter_valid=False, rng=random.Random(0), shape=(32, 32))
        with pytest.raises(IOError, match="native batch decode failed for 1 images"):
            list(ds.batches(4))


def test_multiscale_native_batches_equal_jax(voc_dir, native, monkeypatch):
    monkeypatch.setenv("FSD_NATIVE_BATCH", "1")
    s, js = _both(scale="1")
    lines = [l for l in open(voc_dir["train_list"]).read().split("\n") if l] * 3
    kw = dict(train=True, seen=5 * 4000 * 64, shuffle=False, filter_valid=False)
    a = tds.DetectionDataset(lines, s, rng=random.Random(7), **kw)
    b = jds.DetectionDataset(lines, js, rng=random.Random(7), **kw)
    ba, bb = list(a.batches(36)), list(b.batches(36))
    _assert_batches_equal(ba, bb)
    assert {x.shape[1] for x, _ in ba} <= set(range(320, 609, 32))


@pytest.mark.parametrize("noaug", ["augment", "all"])
def test_meta_support_sets_equal_jax(voc_dir, native, monkeypatch, noaug):
    if noaug == "all":
        monkeypatch.setenv("FSD_NOAUG", "all")
    s, js = _both(tuning="1", max_epoch="10", repeat="1",
                  meta="data/voc_traindict_bbox_5shot.txt")
    a = tds.MetaDataset(voc_dir["traindict"], s, train=True, num_replicas=2,
                        rng=random.Random(11))
    b = jds.MetaDataset(voc_dir["traindict"], js, train=True, num_replicas=2,
                        rng=random.Random(11))
    assert a.native is not None and b.native is not None
    ita, itb = a.batches(), b.batches()
    for _ in range(2):
        (xa, ma), (xb, mb) = next(ita), next(itb)
        assert xa.shape == (40, 64, 64, 3)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ma, mb)
    assert a.rng.random() == b.rng.random()


def test_meta_ensemble_support_sets_equal_jax(voc_dir, native):
    s, js = _both()
    kw = dict(train=False, ensemble=True, with_ids=True)
    a = list(tds.MetaDataset(voc_dir["traindict"], s, **kw).batches(16))
    b = list(jds.MetaDataset(voc_dir["traindict"], js, **kw).batches(16))
    _assert_batches_equal(a, b)


def test_cropped_object_channels_keep_the_pil_path(voc_dir, native):
    """metain_type 3/4 append a cropped object made from the PIL image, so
    the support set takes the PIL path there, as in the JAX package."""
    s, js = _both(metain_type="3")
    a = tds.MetaDataset(voc_dir["traindict"], s, train=True, num_replicas=1, rng=random.Random(2))
    b = jds.MetaDataset(voc_dir["traindict"], js, train=True, num_replicas=1, rng=random.Random(2))
    assert a.native is None and b.native is None
    (xa, ma), (xb, mb) = next(a.batches()), next(b.batches())
    assert xa.shape[-1] == 6
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ma, mb)


def test_dataset_pickles_without_its_native_handle(voc_dir, native):
    import pickle

    s, _ = _both()
    ds = tds.DetectionDataset(voc_dir["train_list"], s, train=False, shuffle=False,
                              shape=(32, 32))
    assert ds.native is not None
    copy = pickle.loads(pickle.dumps(ds))
    assert copy._native is None and not copy._native_init
    np.testing.assert_array_equal(copy[0][0], ds[0][0])  # rebuilt on first use
    assert copy.native is not None
