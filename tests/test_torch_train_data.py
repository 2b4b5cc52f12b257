"""Training-mode data code of the PyTorch port against the JAX package's.

Both packages hold their own copy of the same numpy/PIL code and consume one
`random.Random` stream in the same order, so for one seed the arrays, labels
and lists must be EQUAL (no tolerance)."""

import os
import random

import numpy as np
import pytest

from fewshot_detection_tpu.config import Settings as JSettings
from fewshot_detection_tpu.data import datasets as jds
from fewshot_detection_tpu.data import lists as jlists
from fewshot_detection_tpu.data.loader import prefetch as j_prefetch
from fewshot_detection_tpu_torch.config import Settings
from fewshot_detection_tpu_torch.data import datasets as tds
from fewshot_detection_tpu_torch.data import lists as tlists
from fewshot_detection_tpu_torch.data.loader import prefetch

from synth import VOC, make_voc_like
from torch_port_util import REPO


@pytest.fixture(scope="module")
def voc_dir(tmp_path_factory):
    return make_voc_like(str(tmp_path_factory.mktemp("voc")), n_images=24, seed=0)


def _settings(cls, **kw):
    opts = {
        "metayolo": "1", "metain_type": "2", "data": "voc", "neg": "1",
        "rand": "0", "novel": os.path.join(REPO, "data/voc_novels.txt"), "novelid": "0",
        "meta": "data/voc_traindict_full.txt", "train": "x", "backup": "b",
        "gpus": "0",
    }
    opts.update(kw)
    net = {"height": "64", "width": "64", "batch": "4"}
    meta = {"height": "64", "width": "64", "feat_layer": "0", "channels": "4"}
    return cls.configure(opts, net, meta)


def _both(**kw):
    return _settings(Settings, **kw), _settings(JSettings, **kw)


@pytest.fixture(params=["augment", "noaug_all"])
def noaug(request, monkeypatch):
    if request.param == "noaug_all":
        monkeypatch.setenv("FSD_NOAUG", "all")
    else:
        monkeypatch.delenv("FSD_NOAUG", raising=False)
    return request.param


def test_detection_dataset_train_equals_jax(voc_dir, noaug):
    s, js = _both()
    kw = dict(train=True, seen=0, shuffle=True, filter_valid=True)
    a = tds.DetectionDataset(voc_dir["train_list"], s, rng=random.Random(3), **kw)
    b = jds.DetectionDataset(voc_dir["train_list"], js, rng=random.Random(3), **kw)
    assert a.lines == b.lines and 0 < len(a) < 24  # novel-only images filtered
    assert a.augment == b.augment == (noaug == "augment")
    ba, bb = list(a.batches(4)), list(b.batches(4))
    assert len(ba) == len(bb) == len(a) // 4
    for (ia, la), (ib, lb) in zip(ba, bb):
        assert ia.shape == (4, 416, 416, 3) and la.shape == (4, 15, 250)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
    assert a.seen == b.seen == len(ba) * 4
    assert a.rng.random() == b.rng.random()  # the streams were consumed alike


def test_plain_labels_with_joint_keep_equal_jax(voc_dir):
    s, js = _both(metayolo="0")
    kw = dict(train=True, shuffle=False, filter_valid=False, shape=(64, 64))
    a = tds.DetectionDataset(voc_dir["train_list"], s, rng=random.Random(5), **kw)
    b = jds.DetectionDataset(voc_dir["train_list"], js, rng=random.Random(5), **kw)
    for i in range(6):
        (ia, la), (ib, lb) = a[i], b[i]
        assert la.shape == (250,)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


def test_multiscale_schedule_switches_on_batch_boundaries(voc_dir):
    """Past the first 4000*64 samples the size is drawn anew every
    `_rescale_every` samples (the smallest multiple of the batch size that
    is >= 64): here batch 3 -> every 66 samples = 22 batches, with 24
    images repeated to 72 lines."""
    for seen in (0, 5 * 4000 * 64):
        for r in range(3):
            assert (tds.multiscale_size(seen, random.Random(r), True)
                    == jds.multiscale_size(seen, random.Random(r), True))
    assert tds.multiscale_size(10 ** 9, random.Random(0), False) == 416
    s, js = _both(multiscale="1")
    assert s.multiscale and js.multiscale
    lines = [l for l in open(voc_dir["train_list"]).read().split("\n") if l] * 3
    kw = dict(train=True, seen=5 * 4000 * 64, shuffle=False, filter_valid=False)
    a = tds.DetectionDataset(lines, s, rng=random.Random(7), **kw)
    b = jds.DetectionDataset(lines, js, rng=random.Random(7), **kw)
    sizes = []
    for (ia, la), (ib, lb) in zip(a.batches(3), b.batches(3)):
        assert ia.shape[1] == ia.shape[2] and ia.shape[1] % 32 == 0
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
        sizes.append(ia.shape[1])
    assert a._rescale_every == b._rescale_every == 66
    assert len(sizes) == 24
    assert len(set(sizes[:22])) == 1 and len(set(sizes[22:])) == 1
    assert all(320 <= z <= 608 for z in sizes)


def test_meta_dataset_train_equals_jax(voc_dir, noaug):
    s, js = _both(tuning="1", max_epoch="10", repeat="1",
                  meta="data/voc_traindict_bbox_5shot.txt")
    kw = dict(train=True, num_replicas=2)
    a = tds.MetaDataset(voc_dir["traindict"], s, rng=random.Random(11), **kw)
    b = jds.MetaDataset(voc_dir["traindict"], js, rng=random.Random(11), **kw)
    assert a.classes == b.classes and a.inds == b.inds and a.batch_size == b.batch_size
    n_cls = len(a.classes)
    n = 2 * n_cls
    assert a.batch_size == n == 40  # tuning: all 20 classes, two replica groups
    # each block of n_cls holds one sample per class, in class order
    assert [c for c, _ in a.inds[:2 * n_cls]] == list(range(n_cls)) * 2
    ita, itb = a.batches(), b.batches()
    for _ in range(2):
        (xa, ma), (xb, mb) = next(ita), next(itb)
        assert xa.shape == (n, 64, 64, 3) and ma.shape == (n, 64, 64, 1)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ma, mb)
        assert ma.reshape(n, -1).max(axis=1).min() == 1.0  # no empty mask
    assert a.rng.random() == b.rng.random()


def test_meta_dataset_cropped_object_channels_equal_jax(voc_dir):
    s, js = _both(metain_type="3")
    a = tds.MetaDataset(voc_dir["traindict"], s, train=True, num_replicas=1, rng=random.Random(2))
    b = jds.MetaDataset(voc_dir["traindict"], js, train=True, num_replicas=1, rng=random.Random(2))
    (xa, ma), (xb, mb) = next(a.batches()), next(b.batches())
    assert xa.shape[-1] == 6
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ma, mb)


def test_ram_cache_serves_decoded_images(voc_dir, monkeypatch):
    cache = tds.DecodedCache(1 << 20)
    monkeypatch.setattr(tds, "_ram_cache", cache)
    monkeypatch.setattr(tds, "_ram_cache_init", True)
    s, _ = _both()
    ds = tds.DetectionDataset(voc_dir["train_list"], s, train=False, shuffle=False, shape=(32, 32))
    first = ds[0][0]
    assert (cache.hits, cache.misses) == (0, 1) and cache.bytes == 64 * 48 * 3
    np.testing.assert_array_equal(ds[0][0], first)
    assert cache.hits == 1
    full = tds.DecodedCache(0)  # no budget: every lookup misses, nothing is kept
    assert full.get(ds.lines[0]) is None and not full.map
    monkeypatch.setattr(tds, "_ram_cache", None)
    monkeypatch.setattr(tds, "_ram_cache_init", False)
    monkeypatch.setenv("FSD_RAM_CACHE", "0")
    assert tds.ram_cache() is None


def test_training_lists_equal_jax(voc_dir, tmp_path):
    s, js = _both()
    assert tlists.load_lines(voc_dir["train_list"], s) == jlists.load_lines(voc_dir["train_list"], js)
    assert tlists.load_lines(voc_dir["traindict"], s) == jlists.load_lines(voc_dir["traindict"], js)
    assert (tlists.load_lines(voc_dir["traindict"], s, checkvalid=False)
            == jlists.load_lines(voc_dir["traindict"], js, checkvalid=False))
    assert (tlists.load_metadict(voc_dir["traindict"], s, repeat=2)
            == jlists.load_metadict(voc_dir["traindict"], js, repeat=2))

    d = make_voc_like(str(tmp_path / "few"), n_images=60, classes_per_image=1, seed=3)

    def fewset(mod, st):
        metacnt = {c: (1 if c in st.novel_classes else 0) for c in VOC}
        out = mod.build_fewset(d["train_list"], [], metacnt, shot=1, settings=st,
                               rng=random.Random(0))
        return out, metacnt

    assert fewset(tlists, s) == fewset(jlists, js)

    base = {"train": voc_dir["train_list"], "meta": voc_dir["traindict"]}
    assert tlists.build_dataset(base, s) == jlists.build_dataset(base, js)
    for kw, opts in (
        (dict(tuning="1", repeat="1", meta="m_3shot.txt"), base),
        (dict(tuning="1", repeat="3", meta="m_3shot.txt"), {**base, "dynamic": "0"}),
    ):
        st, jst = _both(**kw)
        got = tlists.build_dataset(opts, st)
        assert got == jlists.build_dataset(opts, jst) and len(got) > 0
    st, jst = _both(tuning="1", repeat="2", meta="m_1shot.txt")
    dyn = {"train": d["train_list"], "meta": d["traindict"], "dynamic": "1"}
    assert (tlists.build_dataset(dyn, st, random.Random(4))
            == jlists.build_dataset(dyn, jst, random.Random(4)))


def test_prefetch_keeps_order_and_passes_errors_on():
    assert list(prefetch(iter(range(7)), depth=2)) == list(j_prefetch(iter(range(7)))) == list(range(7))

    def broken():
        yield 1
        raise KeyError("boom")

    it = prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
