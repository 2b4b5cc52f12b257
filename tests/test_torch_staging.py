"""The train step's staged input copy (`train/staging.py`).

On the CPU the ring's chunking and slot discipline run with a stand-in for
the card (`Deferred`): a DMA is only queued, and runs when an event recorded
after it is waited on, so a slot refilled under its DMA gives wrong bytes.
The copies are bit-equal to `.to()` for sizes that are not a multiple of a
slot, smaller than one and exactly k slots, for every dtype the batches ship,
from numpy and from torch, several arrays end to end; the sources the ring
does not take, and batches under MIN_STAGED_BYTES, keep `.to()`; the counts
are exact. On the card (marked `card`; `python -m pytest
tests/test_torch_staging.py -m card --noconftest`): the four benchmark
cells' batches bit-equal to `.to()` through the ring and through
`to_device`, two batches issued back to back behind a busy stream both
intact, and one MetaTrainer and one PlainTrainer step bit-equal with the
ring and with `.to()`."""

import math
import os

import numpy as np
import pytest
import torch

from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import meta as tm
from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.train import MetaTrainer, PlainTrainer
from fewshot_detection_tpu_torch.train import staging
from fewshot_detection_tpu_torch.train import trainer as trainer_mod
from torch_port_util import cfg

SLOT = 4096
CPU = torch.device("cpu")


class Deferred:
    """A stand-in for the card: `dma` queues a copy; an event covers the
    copies queued before its `record`, which run when it is synchronised
    (`query` is False until then)."""

    def __init__(self):
        self.queue, self.done = [], 0

    def dma(self, dst, src):
        self.queue.append((dst, src))

    def run_until(self, n):
        while self.done < n:
            dst, src = self.queue[self.done]
            dst.copy_(src)
            self.done += 1

    def flush(self):
        self.run_until(len(self.queue))

    def event(self):
        return _Event(self)


class _Event:
    def __init__(self, dev):
        self.dev, self.mark = dev, 0

    def record(self):
        self.mark = len(self.dev.queue)

    def query(self):
        return self.dev.done >= self.mark

    def synchronize(self):
        self.dev.run_until(self.mark)


def _ring(dev, slots=3, threads=3):
    return staging.Ring(SLOT, slots, threads, pin=False, dma=dev.dma, new_event=dev.event)


def _random(n, dtype, kind, seed=0):
    """n elements of dtype, as a numpy array (kind "numpy") or a tensor."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        t = torch.rand(n, generator=g) > 0.5
    elif dtype.is_floating_point:
        t = (torch.randn(n, generator=g) * 100).to(dtype)
    else:
        t = torch.randint(0, 2**7 if dtype == torch.uint8 else 2**40, (n,), generator=g,
                          dtype=torch.int64).to(dtype)
    return t.numpy() if kind == "numpy" else t


def _stage(arrays, ring, dev):
    out, counts = staging.stage([torch.as_tensor(a) for a in arrays], CPU, ring)
    dev.flush()
    return out, counts


def _bytes_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


DTYPES = [torch.bfloat16, torch.float32, torch.uint8, torch.int64, torch.bool]


@pytest.mark.parametrize("nbytes", [SLOT * 3 + 17 * 8, SLOT // 3 // 8 * 8, SLOT * 2],
                         ids=["ragged", "under_a_slot", "two_slots"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_a_staged_copy_is_bit_equal_to_to(kind, dtype, nbytes):
    if kind == "numpy" and dtype == torch.bfloat16:
        pytest.skip("numpy has no bfloat16")
    itemsize = torch.empty(0, dtype=dtype).element_size()
    src = _random(nbytes // itemsize, dtype, kind)
    dev = Deferred()
    (got,), counts = _stage([src], _ring(dev), dev)
    assert _bytes_equal(got, torch.as_tensor(src).to(CPU))
    n = torch.as_tensor(src).nbytes
    assert counts == {"staged_bytes": n, "chunks": math.ceil(n / SLOT),
                      "slot_waits": max(0, math.ceil(n / SLOT) - 3)}


def test_several_arrays_are_laid_end_to_end():
    arrays = [_random(1000, torch.bfloat16, "torch", 1).reshape(10, 100),
              _random(777, torch.float32, "numpy", 2),
              _random(5, torch.bool, "numpy", 3),
              _random(SLOT * 2 + 1, torch.uint8, "torch", 4),
              _random(300, torch.int64, "numpy", 5).reshape(3, 100)]
    total = sum(torch.as_tensor(a).nbytes for a in arrays)
    dev = Deferred()
    got, counts = _stage(arrays, _ring(dev, slots=2), dev)
    for g, a in zip(got, arrays):
        assert _bytes_equal(g, torch.as_tensor(a))
    chunks = math.ceil(total / SLOT)
    assert counts == {"staged_bytes": total, "chunks": chunks, "slot_waits": chunks - 2}
    # a chunk holds pieces of several arrays: more DMAs than chunks
    assert len(dev.queue) > chunks


def test_a_slot_is_not_refilled_under_its_dma():
    """Every DMA of a call still queued when the next call starts: the second
    call waits on each slot before it refills it, and both arrive intact."""
    dev = Deferred()
    ring = _ring(dev, slots=2)
    a = _random(SLOT * 3, torch.uint8, "numpy", 6)
    b = _random(SLOT * 3, torch.uint8, "numpy", 7)
    (ga,), ca = staging.stage([torch.as_tensor(a)], CPU, ring)
    (gb,), cb = staging.stage([torch.as_tensor(b)], CPU, ring)
    dev.flush()
    assert np.array_equal(ga.numpy(), a) and np.array_equal(gb.numpy(), b)
    assert ca["slot_waits"] == 1  # the third chunk laps the ring of 2
    assert cb["slot_waits"] == 3  # the first call's DMAs still pending


def test_no_wait_when_the_dmas_are_done():
    class Done(Deferred):
        def dma(self, dst, src):
            dst.copy_(src)

    dev = Done()
    src = _random(SLOT * 7 + 3, torch.uint8, "torch", 8)
    (got,), counts = _stage([src], _ring(dev, slots=2), dev)
    assert torch.equal(got, src)
    assert counts == {"staged_bytes": SLOT * 7 + 3, "chunks": 8, "slot_waits": 0}


@pytest.mark.parametrize("threads", [1, 2, 5])
def test_the_fill_runs_on_at_most_the_rings_threads(threads, monkeypatch):
    """PyTorch's intra-op count is lowered to the ring's for the copy (never
    raised) and put back after it."""
    set_to = []
    monkeypatch.setattr(torch, "get_num_threads", lambda: set_to[-1] if set_to else 4)
    monkeypatch.setattr(torch, "set_num_threads", set_to.append)
    seen = []
    dev = Deferred()
    ring = staging.Ring(SLOT, 3, threads, pin=False, new_event=dev.event,
                        dma=lambda dst, src: seen.append(torch.get_num_threads()) or dev.dma(dst, src))
    src = _random(SLOT * 2 + 100, torch.uint8, "torch", 9)
    (got,), _ = staging.stage([src], CPU, ring)
    dev.flush()
    assert torch.equal(got, src)
    assert seen == [min(threads, 4)] * 3 and torch.get_num_threads() == 4


def _noncontiguous():
    return torch.arange(64, dtype=torch.float32).reshape(8, 8).t()


@pytest.mark.parametrize("which", ["noncontiguous", "pinned", "device", "empty"])
def test_sources_the_ring_does_not_take_keep_to(which, monkeypatch):
    staged = _random(1000, torch.float32, "torch", 10)
    if which == "noncontiguous":
        other = _noncontiguous()
    elif which == "empty":
        other = torch.empty(0, 3)
    elif which == "device":
        other = torch.empty(5, device="meta")
    else:
        other = torch.arange(10.0)
        monkeypatch.setattr(torch.Tensor, "is_pinned",
                            lambda self: self.data_ptr() == other.data_ptr())
    assert staging.engages(staged) and not staging.engages(other)
    if which == "device":
        return  # a meta tensor holds no bytes to compare
    dev = Deferred()
    got, counts = _stage([staged, other], _ring(dev), dev)
    assert _bytes_equal(got[0], staged) and torch.equal(got[1], other.to(CPU))
    assert got[1].stride() == other.stride()  # `.to()`'s layout, as before
    assert counts["staged_bytes"] == staged.nbytes


def test_to_the_cpu_nothing_takes_the_ring():
    arrays = [np.arange(12, dtype=np.float32).reshape(3, 4), _noncontiguous(),
              torch.ones(3, dtype=torch.bfloat16)]
    got, counts = staging.to_device(arrays, CPU)
    assert counts == {"staged_bytes": 0, "chunks": 0, "slot_waits": 0}
    for g, a in zip(got, arrays):
        assert _bytes_equal(g, torch.as_tensor(a).to(CPU))
    assert staging._RINGS == {}


@pytest.mark.parametrize("nbytes, extra, want", [(1000, None, True), (999, None, False),
                                                  (999, "pageable", True), (999, "pinned", False)])
def test_a_batch_takes_the_ring_from_min_staged_bytes(nbytes, extra, want, monkeypatch):
    """Counted over the sources the ring would take (a non-contiguous array
    and a pinned one count nothing), bound for a CUDA device."""
    monkeypatch.setattr(staging, "MIN_STAGED_BYTES", 1000)
    batch = [torch.zeros(nbytes, dtype=torch.uint8), _noncontiguous()]
    if extra:
        batch.append(torch.zeros(5000, dtype=torch.uint8))
    if extra == "pinned":
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: self.numel() == 5000)
    assert staging.takes_ring(batch, torch.device("cuda")) == want
    assert not staging.takes_ring(batch, CPU)


@pytest.mark.parametrize("text, cpus", [("max 100000", None), ("200000 100000", 2.0),
                                        ("150000 100000", 1.5), ("", None)])
def test_the_cgroup_quota_in_cpus(text, cpus, monkeypatch, tmp_path):
    (tmp_path / "cgroup").write_text("0::/box\n")
    (tmp_path / "cpu.max").write_text(text + "\n")
    real = open

    def fake_open(path, *a, **k):
        return real({"/proc/self/cgroup": tmp_path / "cgroup",
                     "/sys/fs/cgroup/box/cpu.max": tmp_path / "cpu.max"}.get(path, path), *a, **k)

    monkeypatch.setattr("builtins.open", fake_open)
    assert staging.cgroup_cpus() == cpus


@pytest.mark.parametrize("torch_threads, quota, want", [(8, None, 4), (2, None, 2),
                                                        (8, 1.5, 1), (8, 0.5, 1), (8, 3.0, 3)])
def test_fill_threads_is_capped_by_what_the_process_may_use(torch_threads, quota, want,
                                                            monkeypatch):
    monkeypatch.setattr(torch, "get_num_threads", lambda: torch_threads)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(4)))
    monkeypatch.setattr(staging, "cgroup_cpus", lambda: quota)
    assert staging.fill_threads() == want


def test_pinned_memory_is_fixed():
    # the ring's pinned bytes, whatever the batch
    assert staging.SLOT_BYTES * staging.SLOTS <= 128 << 20


# --- on the card -------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


def _meta_batch(b):
    return [((1, b, 416, 416, 3), BF16), ((1, 15, 416, 416, 3), BF16),
            ((1, 15, 416, 416, 1), BF16), ((1, b, 15, 50, 5), F32), ((1, b * 15), F32)]


def _plain_batch(b, size):
    return [((1, b, size, size, 3), BF16), ((1, b, 50, 5), F32), ((1, b), F32)]


# the benchmark cells' batches (benchmark/drivers): images and supports as
# host tensors, targets and keep weights as numpy arrays
CELL_BATCHES = {
    "meta_voc15.train_b64": _meta_batch(64),
    "yolov2_voc.train_b64": _plain_batch(64, 416),
    "meta_voc15.train_b384": _meta_batch(384),
    "yolov3_coco.train_b64_608": _plain_batch(64, 608),
}


def _cell_batch(cell, seed):
    g = torch.Generator().manual_seed(seed)
    out = []
    for shape, dtype in CELL_BATCHES[cell]:
        t = torch.rand(shape, generator=g).to(dtype)
        out.append(t.numpy() if dtype == F32 else t)
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CELL_BATCHES))
def test_card_cell_batches_are_bit_equal_to_to(card, cell):
    """Through the ring, and as `to_device` sends them: the batches under
    MIN_STAGED_BYTES (the b64 cells') keep `.to()`."""
    dev = torch.device("cuda")
    arrays = _cell_batch(cell, 1)
    want = [torch.as_tensor(a).to(dev) for a in arrays]
    total = sum(torch.as_tensor(a).nbytes for a in arrays)
    staged, counts = staging.stage([torch.as_tensor(a) for a in arrays], dev,
                                   staging.ring_for(dev))
    sent, sent_counts = staging.to_device(arrays, dev)
    torch.cuda.synchronize()
    for got in (staged, sent):
        for g, w in zip(got, want):
            assert g.device == w.device and _bytes_equal(g, w)
    assert counts["staged_bytes"] == total
    assert counts["chunks"] == math.ceil(total / staging.SLOT_BYTES)
    assert sent_counts == (counts if total >= staging.MIN_STAGED_BYTES
                           else dict.fromkeys(staging.COUNTS, 0))
    print(cell, counts, sent_counts)


@pytest.mark.card
def test_card_two_batches_back_to_back_arrive_intact(card):
    """Behind a stream held busy: the first batch takes no more chunks than
    the ring has slots, so it never waits; the second, issued at once, laps
    the ring, finds the slots' DMAs still queued and must wait on them
    before refilling."""
    dev = torch.device("cuda")
    ring = staging.ring_for(dev)
    a = [torch.as_tensor(x) for x in _cell_batch("yolov2_voc.train_b64", 2)]
    b = [torch.as_tensor(x) for x in _cell_batch("meta_voc15.train_b64", 3)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s on an H100
    ga, ca = staging.stage(a, dev, ring)
    gb, cb = staging.stage(b, dev, ring)
    torch.cuda.synchronize()
    for got, arrays in ((ga, a), (gb, b)):
        for g, x in zip(got, arrays):
            assert _bytes_equal(g, x.to(dev))
    assert ca["chunks"] <= staging.SLOTS < ca["chunks"] + cb["chunks"]
    assert ca["slot_waits"] == 0 and cb["slot_waits"] >= 1
    print(ca, cb)


def _plain_to_device(arrays, device):
    return ([torch.as_tensor(a).to(device, non_blocking=True) for a in arrays],
            dict.fromkeys(staging.COUNTS, 0))


def _ring_to_device(arrays, device):
    # the ring whatever the batch's size (these batches are under MIN_STAGED_BYTES)
    with torch.cuda.device(device):
        return staging.stage([torch.as_tensor(a) for a in arrays], device,
                             staging.ring_for(device))


PLAIN_CFG = """[net]
batch=2
width=64
height=64
channels=3

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


def _trainer(kind, tmp_path, device="cuda"):
    r = np.random.RandomState(5)
    R, b, size, n_cls = 2, 2, 64, 3
    if kind == "meta":
        spec = tm.MetaSpec(*(build_spec(parse_cfg(cfg(n)))
                             for n in ("tiny_darknet_dynamic.cfg", "tiny_reweighting.cfg")))
        params = tm.init_meta_params(spec, 0)
        tp = require_grads({k: from_jax_params(getattr(spec, k), params[k], device)
                            for k in ("darknet", "learnet")})
        target = np.zeros((R, b, n_cls, 50, 5), np.float32)
        target[:, :, 0, 0] = [0, 0.5, 0.5, 0.3, 0.3]
        batch = {"x": r.rand(R, b, size, size, 3).astype(np.float32),
                 "metax": r.rand(R, n_cls, size, size, 3).astype(np.float32),
                 "mask": (r.rand(R, n_cls, size, size, 1) > 0.5).astype(np.float32),
                 "target": target, "keep": np.ones((R, b * n_cls), np.float32)}
        trainer = MetaTrainer(spec, weight_decay=5e-4, device=device)
    else:
        path = os.path.join(tmp_path, "plain.cfg")
        with open(path, "w") as f:
            f.write(PLAIN_CFG)
        spec = build_spec(parse_cfg(path))
        tp = require_grads(from_jax_params(spec, init_params(spec, 0), device))
        target = np.zeros((R, b, 50, 5), np.float32)
        target[:, :, 0] = [1, 0.5, 0.5, 0.3, 0.3]
        batch = {"x": r.rand(R, b, size, size, 3).astype(np.float32), "target": target,
                 "keep": np.ones((R, b), np.float32)}
        trainer = PlainTrainer(spec, weight_decay=5e-4, device=device)
    return trainer, tp, batch


@pytest.fixture
def deterministic():
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


@pytest.mark.card
@pytest.mark.parametrize("kind", ["meta", "plain"])
def test_card_a_step_is_bit_equal_with_the_ring_and_with_to(card, deterministic, kind,
                                                            tmp_path, monkeypatch):
    trainer, tp, batch = _trainer(kind, str(tmp_path))
    got = {}
    for how in ("ring", "to", "ring"):
        monkeypatch.setattr(trainer_mod, "to_device",
                            _plain_to_device if how == "to" else _ring_to_device)
        loss, grads, _, _ = trainer.loss_and_grads(tp, batch, seen=64)
        flat = [loss] + [g for _, g in trainer_mod.tree_leaves_with_path(grads)]
        got.setdefault(how, []).append([t.detach().cpu() for t in flat])
    ring = got["ring"][0]
    assert all(torch.equal(a, b) for a, b in zip(got["ring"][1], ring))  # reproducible
    assert all(torch.equal(a, b) for a, b in zip(got["to"][0], ring))
