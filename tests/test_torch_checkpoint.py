"""Full training-state checkpoints of the port (`train/checkpoint.py`) and
the meta CLI's resume from them (`FSD_ORBAX_DIR`).

Round trips are BIT-EQUAL, synchronous and asynchronous (FSD_ASYNC_CKPT=1);
an async save stages a host copy before it returns, so an in-place SGD step
right after it does not reach the file. A CLI run of 2 epochs plus a run
resumed to 3 gives BIT-EQUAL parameters, momentum, counters and `.weights`
bytes to an uninterrupted 3-epoch run on the CPU (pinned clocks; no
augmentation, every negative copy kept and one support image per class, so
the data of an epoch does not depend on how far the random stream has
run), from starting weights whose header `seen` is past the region loss's
warm-up, as a tuning run's base checkpoint is. The resumed counters follow
the JAX package's rule: the epoch starts at the checkpoint's `step`, `seen`
and `processed_batches` are the checkpoint's. The `seen` saved is the
training loop's own (the JAX package saves epochs * nsamples, from which a
tuning run would resume inside the warm-up)."""

import contextlib
import io
import os
import re
import shutil
import threading
import types

import numpy as np
import pytest
import torch

from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import weights_io as j_weights_io
from fewshot_detection_tpu.models.meta import MetaSpec as JMetaSpec
from fewshot_detection_tpu.models.meta import init_meta_params as j_init_meta_params
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu_torch.cli import train_meta_cli as t_cli
from fewshot_detection_tpu_torch.train import checkpoint as ckpt
from fewshot_detection_tpu_torch.train.optim import sgd_update, tree_leaves_with_path
from fewshot_detection_tpu_torch.utils import trace_summary

from synth import make_voc_like
from torch_port_util import REPO

WARMUP_SEEN = 12800  # the region loss's coordinate warm-up (settings.warmup_seen)
START_SEEN = 20000  # the starting weights' header: past the warm-up
LOSS_LINE = re.compile(r"^(\d+): nGT (\d+), recall (\d+), proposals (\d+), loss: .* total ([\d.]+)$")
STEP_TIMER_LINE = re.compile(
    r"data [\d.]+s \([\d.]+ms/it\) \| step [\d.]+s \([\d.]+ms/it\) \| "
    r"sync [\d.]+s \([\d.]+ms/it\) \| wall [\d.]+s \| [\d.]+ images/s$")


def _tree(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)
    return {"darknet": [{"w": r(3, 3, 2, 4), "bn": {"gamma": r(4), "beta": r(4),
                                                     "mean": r(4), "var": r(4).abs()}},
                        None, {"w": r(1, 1, 4, 6), "b": r(6)}],
            "learnet": [{"w": r(3, 3, 4, 4)}]}


def _assert_trees_equal(a, b):
    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.detach().cpu(), y.detach().cpu()), p


@pytest.fixture(autouse=True)
def _no_writes_left_behind():
    yield
    ckpt.wait_for_saves()


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_is_bit_equal(tmp_path, monkeypatch, mode, dtype):
    monkeypatch.setenv("FSD_ASYNC_CKPT", "1" if mode == "async" else "0")
    params, mom = _tree(0, dtype), _tree(1, dtype)
    d = str(tmp_path / "ckpts")
    assert ckpt.save_train_state(d, 3, _tree(5), _tree(6), seen=192,
                                 processed_batches=3).endswith("ckpt_00000003")
    path = ckpt.save_train_state(d, 7, params, mom, seen=448, processed_batches=7)
    ckpt.wait_for_saves()
    assert ckpt.latest_checkpoint(d) == path == os.path.join(os.path.abspath(d), "ckpt_00000007")
    got = ckpt.restore_train_state(path)
    assert got["counters"] == {"seen": 448, "processed_batches": 7, "step": 7}
    _assert_trees_equal(got["params"], params)
    _assert_trees_equal(got["momentum"], mom)
    assert got["params"]["darknet"][1] is None


def test_restore_onto_a_template_takes_its_dtype_and_grad_flags(tmp_path):
    params = _tree(0)
    ckpt.save_train_state(str(tmp_path), 1, params, _tree(1), seen=4, processed_batches=1)
    template = {"params": _tree(9), "momentum": _tree(9)}
    template["params"]["darknet"][0]["w"].requires_grad_(True)
    got = ckpt.restore_train_state(ckpt.latest_checkpoint(str(tmp_path)), template)
    assert got["params"]["darknet"][0]["w"].requires_grad
    assert not got["params"]["darknet"][0]["bn"]["mean"].requires_grad
    _assert_trees_equal(got["params"], params)
    bad = {"params": _tree(9), "momentum": _tree(9)}
    bad["params"]["learnet"][0]["w"] = torch.zeros(2)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_train_state(ckpt.latest_checkpoint(str(tmp_path)), bad)


def test_async_save_then_an_in_place_step_restores_the_pre_step_values(tmp_path, monkeypatch):
    """The write is held back until after an in-place SGD step has changed
    every parameter and momentum leaf; the checkpoint still holds the values
    at the save."""
    monkeypatch.setenv("FSD_ASYNC_CKPT", "1")
    release = threading.Event()
    write = ckpt._write

    def held_write(state, path):
        assert release.wait(60)
        write(state, path)

    monkeypatch.setattr(ckpt, "_write", held_write)
    params, mom = _tree(0), _tree(1)
    before = (_tree(0), _tree(1))
    ckpt.save_train_state(str(tmp_path), 2, params, mom, seen=8, processed_batches=2)
    grads = _tree(2)
    sgd_update(params, grads, mom, 0.5, momentum=0.9, weight_decay=0.01)
    assert not torch.equal(params["darknet"][0]["w"], before[0]["darknet"][0]["w"])
    assert not torch.equal(mom["learnet"][0]["w"], before[1]["learnet"][0]["w"])
    assert ckpt.latest_checkpoint(str(tmp_path)) is None  # not written yet
    release.set()
    ckpt.wait_for_saves()
    got = ckpt.restore_train_state(ckpt.latest_checkpoint(str(tmp_path)))
    _assert_trees_equal(got["params"], before[0])
    _assert_trees_equal(got["momentum"], before[1])


def test_one_save_in_flight_at_a_time(tmp_path, monkeypatch):
    monkeypatch.setenv("FSD_ASYNC_CKPT", "1")
    lock, live, most = threading.Lock(), [0], [0]
    write = ckpt._write

    def counted(state, path):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        threading.Event().wait(0.05)
        write(state, path)
        with lock:
            live[0] -= 1

    monkeypatch.setattr(ckpt, "_write", counted)
    for step in range(1, 5):
        ckpt.save_train_state(str(tmp_path), step, _tree(step), _tree(0), seen=step,
                              processed_batches=step)
    ckpt.wait_for_saves()
    assert most[0] == 1
    assert sorted(os.listdir(tmp_path)) == [f"ckpt_{s:08d}" for s in range(1, 5)]
    got = ckpt.restore_train_state(ckpt.latest_checkpoint(str(tmp_path)))
    _assert_trees_equal(got["params"], _tree(4))


def test_a_failed_background_write_is_raised_by_wait(tmp_path, monkeypatch):
    monkeypatch.setenv("FSD_ASYNC_CKPT", "1")

    def failing(state, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", failing)
    ckpt.save_train_state(str(tmp_path), 1, _tree(0), _tree(1), seen=1, processed_batches=1)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # reported once


def test_latest_checkpoint_skips_empty_and_partial_directories(tmp_path):
    d = tmp_path / "ckpts"
    assert ckpt.latest_checkpoint(str(d)) is None
    d.mkdir()
    assert ckpt.latest_checkpoint(str(d)) is None
    ckpt.save_train_state(str(d), 4, _tree(0), _tree(1), seen=16, processed_batches=4)
    (d / "ckpt_00000009").mkdir()  # empty: a save that never started writing
    (d / "ckpt_00000007").mkdir()
    (d / "ckpt_00000007" / "state.pt.partial-1-2").write_bytes(b"\x80half")  # cut short
    (d / "ckpt_00000011.tmp").mkdir()
    (d / "ckpt_00000012" ).write_bytes(b"a file, not a checkpoint")
    assert ckpt.latest_checkpoint(str(d)) == str(d / "ckpt_00000004")


# ---------------------------------------------------------------------------
# the meta CLI: FSD_ORBAX_DIR resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckptcli")
    d = make_voc_like(str(root / "voc"), n_images=24, seed=3)
    dk = str(root / "tiny_dd.cfg")
    with open(os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg")) as f:
        txt = f.read().replace("learning_rate=0.001", "learning_rate=0.0001")
    with open(dk, "w") as f:
        f.write(txt)
    ln = os.path.join(REPO, "cfg/tiny_reweighting.cfg")
    # one support image per class: the support draw is the same wherever
    # the random stream stands
    lists = root / "lists"
    lists.mkdir()
    shot_dict = str(root / "traindict_1shot.txt")
    with open(shot_dict, "w") as f:
        for cls, lst in sorted(d["cls_lists"].items()):
            one = lists / f"{cls}.txt"
            one.write_text(open(lst).readline())
            f.write(f"{cls} {one}\n")
    spec = JMetaSpec(j_build_spec(j_parse_cfg(dk)), j_build_spec(j_parse_cfg(ln)))
    params = j_init_meta_params(spec, 0)
    init_w = str(root / "init.weights")
    j_weights_io.save_weights(init_w, [spec.darknet, spec.learnet],
                              [params["darknet"], params["learnet"]], seen=START_SEEN)

    def datacfg(name, epochs):
        path = str(root / f"{name}.data")
        with open(path, "w") as f:
            f.write(
                "metayolo=1\nmetain_type=2\ndata=voc\nrand=0\nscale=0\n"
                f"tuning=1\nmax_epoch={epochs}\nrepeat=1\ndynamic=0\n"
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={shot_dict}\ntrain={d['train_list']}\nvalid={d['train_list']}\n"
                f"backup={root}/{name}\ngpus=0\n")
        return path

    return {"root": str(root), "dk": dk, "ln": ln, "init_w": init_w, "datacfg": datacfg}


def _run(ws, monkeypatch, datacfg, weights, env):
    monkeypatch.setattr(t_cli, "time", types.SimpleNamespace(time=lambda: 1234.0))
    monkeypatch.setenv("FSD_NOAUG", "all")
    for name in ("FSD_DTYPE", "FSD_INPUT_U8", "FSD_REMAT", "FSD_BN_DARKNET", "FSD_WORKERS",
                 "FSD_NATIVE", "FSD_NATIVE_BATCH", "FSD_OVERLAP_METRICS", "FSD_ORBAX_DIR",
                 "FSD_ASYNC_CKPT", "FSD_PROFILE_DIR"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_cli.main(datacfg, ws["dk"], ws["ln"], weights, device="cpu")
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(ws):
    """An uninterrupted 3-epoch run (traced), and a 2-epoch run with async
    saves resumed to 3 epochs."""
    mp = pytest.MonkeyPatch()
    root = ws["root"]
    try:
        out = {
            "whole": _run(ws, mp, ws["datacfg"]("whole", 3), ws["init_w"],
                          {"FSD_ORBAX_DIR": f"{root}/ck_whole",
                           "FSD_PROFILE_DIR": f"{root}/traces"}),
            "first": _run(ws, mp, ws["datacfg"]("parts", 2), ws["init_w"],
                          {"FSD_ORBAX_DIR": f"{root}/ck_parts", "FSD_ASYNC_CKPT": "1"}),
        }
        shutil.copytree(f"{root}/ck_parts", f"{root}/ck_after_first")
        out["resumed"] = _run(ws, mp, ws["datacfg"]("parts", 3), ws["init_w"],
                              {"FSD_ORBAX_DIR": f"{root}/ck_parts"})
    finally:
        mp.undo()
    return out


def _losses(text):
    return [m for m in (LOSS_LINE.match(l) for l in text.splitlines()) if m]


def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(ws, runs):
    root = ws["root"]
    whole = ckpt.restore_train_state(ckpt.latest_checkpoint(f"{root}/ck_whole"))
    parts = ckpt.restore_train_state(ckpt.latest_checkpoint(f"{root}/ck_parts"))
    assert whole["counters"] == parts["counters"]
    assert whole["counters"]["step"] == 3
    _assert_trees_equal(parts["params"], whole["params"])
    _assert_trees_equal(parts["momentum"], whole["momentum"])
    with open(f"{root}/wholefix_novel0_negfull/000003.weights", "rb") as f:
        want = f.read()
    with open(f"{root}/partsfix_novel0_negfull/000003.weights", "rb") as f:
        assert f.read() == want
    # the loss lines of the resumed epoch are the uninterrupted run's
    lines = lambda text: [m.group(0) for m in _losses(text)]
    got = lines(runs["resumed"])
    assert got == lines(runs["whole"])[-len(got):]
    assert lines(runs["first"]) == lines(runs["whole"])[:-len(got)]


def test_resumed_counters_follow_the_jax_rule(ws, runs):
    """init_epoch = the checkpoint's step, seen and processed_batches = its
    counters (JAX cli/train_meta_cli.py:163-181). The run before saved its
    running `seen`: the header's plus the images of its whole batches (the
    last batch of an epoch is dropped when it is not full). The JAX package
    saves epochs * nsamples, as the `.weights` header has it; a tuning run
    resumed from that would be back inside the region loss's warm-up, and
    its losses would not be the uninterrupted run's."""
    root = ws["root"]
    first = ckpt.restore_train_state(ckpt.latest_checkpoint(f"{root}/ck_after_first"))
    c = first["counters"]
    nsamples = int(re.search(r"^\S+ \S+ 1 (\d+) 100 4$", runs["first"], re.M).group(1))
    per_epoch = nsamples // 4
    assert c == {"seen": START_SEEN + 2 * per_epoch * 4, "processed_batches": 2 * per_epoch,
                 "step": 2}
    assert 2 * nsamples < WARMUP_SEEN < c["seen"]  # where the JAX package's value would go
    out = runs["resumed"]
    assert f"resuming train state from {root}/ck_parts/ckpt_00000002" in out
    assert f"epoch 2/3, processed {2 * nsamples} samples" in out
    assert "epoch 0/3" not in out and "epoch 1/3" not in out
    lines = _losses(out)
    assert len(lines) == per_epoch
    assert int(lines[0].group(1)) == c["seen"] + 4
    final = ckpt.restore_train_state(ckpt.latest_checkpoint(f"{root}/ck_parts"))["counters"]
    assert final == {"seen": START_SEEN + 3 * per_epoch * 4,
                     "processed_batches": 3 * per_epoch, "step": 3}
    assert sorted(os.listdir(f"{root}/ck_parts")) == [f"ckpt_{s:08d}" for s in (1, 2, 3)]


def test_each_epoch_prints_the_step_timer_line_and_writes_a_trace(ws, runs):
    timer_lines = [l for l in runs["whole"].splitlines() if STEP_TIMER_LINE.search(l)]
    assert len(timer_lines) == 3
    files = trace_summary.find_trace_files(f"{ws['root']}/traces")
    assert len(files) == 3  # one trace a epoch
    s = trace_summary.summarize(trace_summary.load_events(files[0]))
    assert s["total_us"] > 0 and any("conv" in n for n in s["ops"])
