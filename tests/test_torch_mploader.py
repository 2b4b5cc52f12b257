"""The port's multi-process loader (`data/mploader.py`) against the direct
streams and against the JAX package's streams.

MPLoader spawns worker processes that each yield every W-th batch of the
sequential stream; the parent interleaves them back into order. For one
seed the batches must be EQUAL to the direct stream's and to the JAX
package's `episode_stream` / `detection_stream` (no tolerance)."""

import os
import random

import numpy as np
import pytest

from fewshot_detection_tpu.config import Settings as JSettings
from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.config import read_data_cfg as j_read_data_cfg
from fewshot_detection_tpu.data import mploader as j_mp
from fewshot_detection_tpu_torch.config import Settings, parse_cfg, read_data_cfg
from fewshot_detection_tpu_torch.data import mploader as t_mp

from synth import make_voc_like
from torch_port_util import REPO, jax_native_loader


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    jax_native_loader()
    root = str(tmp_path_factory.mktemp("mpl") / "voc")
    d = make_voc_like(root, n_images=20, seed=2, style="shape", size=(72, 56))
    datacfg = os.path.join(d["root"], "m.data")
    with open(datacfg, "w") as f:
        f.write(
            f"metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
            f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
            f"meta={d['traindict']}\ntrain={d['train_list']}\n"
            f"backup={d['root']}/backup\ngpus=0\n"
        )
    net = os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg")
    d["opts"] = read_data_cfg(datacfg)
    d["settings"] = Settings.configure(read_data_cfg(datacfg), parse_cfg(net)[0], None)
    d["jsettings"] = JSettings.configure(j_read_data_cfg(datacfg), j_parse_cfg(net)[0], None)
    d["lines"] = open(d["train_list"]).read().split()
    return d


def _assert_same(xs, ys):
    assert len(xs) == len(ys) > 0
    for x, y in zip(xs, ys):
        assert len(x) == len(y)
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)


def _episode_args(d, settings, n_groups=1):
    return (d["lines"], d["opts"]["meta"], settings, 4, 0, n_groups)


def test_single_worker_equals_the_direct_stream(synth):
    args = _episode_args(synth, synth["settings"])
    direct = list(t_mp.episode_stream(*args, worker_id=0, num_workers=1, seed=11))
    loader = t_mp.MPLoader(t_mp.episode_stream, args, num_workers=1, seed=11)
    try:
        via_mp = list(loader)
    finally:
        loader.close()
    _assert_same(via_mp, direct)
    assert not any(p.is_alive() for p in loader.procs)


def test_two_workers_partition_by_stride(synth):
    """Even batches come from worker 0's stream, odd ones from worker 1's."""
    args = _episode_args(synth, synth["settings"])
    w0 = list(t_mp.episode_stream(*args, worker_id=0, num_workers=2, seed=11))
    w1 = list(t_mp.episode_stream(*args, worker_id=1, num_workers=2, seed=11))
    loader = t_mp.MPLoader(t_mp.episode_stream, args, num_workers=2, seed=11)
    try:
        merged = list(loader)
    finally:
        loader.close()
    assert len(merged) == len(w0) + len(w1) == 5
    _assert_same(merged, [w0[i // 2] if i % 2 == 0 else w1[i // 2] for i in range(len(merged))])


@pytest.mark.parametrize("worker", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_episode_stream_equals_jax(synth, worker, n_groups):
    w, n = worker
    got = list(t_mp.episode_stream(*_episode_args(synth, synth["settings"], n_groups),
                                   worker_id=w, num_workers=n, seed=5))
    want = list(j_mp.episode_stream(*_episode_args(synth, synth["jsettings"], n_groups),
                                    worker_id=w, num_workers=n, seed=5))
    _assert_same(got, want)
    imgs, labels, metax, mask = got[0]
    n_cls = labels.shape[1]
    # one support sample per class PER replica group
    assert metax.shape[0] == mask.shape[0] == n_groups * n_cls


@pytest.mark.parametrize("native", ["pil", "native", "native_batch"])
def test_detection_stream_equals_jax(synth, monkeypatch, native):
    monkeypatch.setenv("FSD_NATIVE", "0" if native == "pil" else "1")
    monkeypatch.setenv("FSD_NATIVE_BATCH", "1" if native == "native_batch" else "0")
    for w in (0, 1):
        got = list(t_mp.detection_stream(synth["lines"], synth["settings"], 4, 0,
                                         worker_id=w, num_workers=2, seed=3))
        want = list(j_mp.detection_stream(synth["lines"], synth["jsettings"], 4, 0,
                                          worker_id=w, num_workers=2, seed=3))
        _assert_same(got, want)


def test_native_workers_equal_the_jax_stream(synth, monkeypatch):
    """FSD_NATIVE=1 FSD_NATIVE_BATCH=1 reach the spawned workers through the
    environment; two workers' interleaved batches equal the JAX package's
    streams of the same workers."""
    monkeypatch.setenv("FSD_NATIVE", "1")
    monkeypatch.setenv("FSD_NATIVE_BATCH", "1")
    args = (synth["lines"], synth["settings"], 4, 0)
    loader = t_mp.MPLoader(t_mp.detection_stream, args, num_workers=2, seed=7)
    try:
        merged = list(loader)
    finally:
        loader.close()
    jw = [list(j_mp.detection_stream(synth["lines"], synth["jsettings"], 4, 0,
                                     worker_id=w, num_workers=2, seed=7)) for w in (0, 1)]
    _assert_same(merged, [jw[i % 2][i // 2] for i in range(len(merged))])


def test_worker_errors_propagate():
    s = Settings.configure({"metayolo": "1", "data": "voc", "novelid": "0"}, None, None)
    loader = t_mp.MPLoader(t_mp.episode_stream, (["/nonexistent.png"], "/nope.txt", s, 4, 0),
                           num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="loader worker failed"):
            list(loader)
    finally:
        loader.close()
    assert not any(p.is_alive() for p in loader.procs)


def test_at_least_one_worker():
    with pytest.raises(ValueError):
        t_mp.MPLoader(t_mp.detection_stream, (), num_workers=0)


def test_random_streams_are_per_worker(synth):
    """Worker w draws from random.Random(seed + w), as in the JAX package."""
    s = synth["settings"]
    a = list(t_mp.detection_stream(synth["lines"], s, 4, 0, worker_id=1, num_workers=2, seed=3))
    from fewshot_detection_tpu_torch.data.datasets import DetectionDataset

    ds = DetectionDataset(list(synth["lines"]), s, train=True, seen=0, shuffle=False,
                          rng=random.Random(4), filter_valid=False)
    _assert_same(a, list(ds.batches(4, offset=1, stride=2)))
