"""The port's span recorder (`utils/profiling.py`) and the spans that the
train step and the loss line open: off it records nothing and hands out
one shared no-op; on, spans nest with their parents, a step identifier and
their self time; a CPU MetaTrainer and PlainTrainer step (R = 2) give
`train.step` over `train.to_device`, one `train.forward` a group,
`train.backward` and `train.update`, in that order (the plain trainer's
`train.loss` inside each forward), and on the card counts the kernel
launches of the benchmark's networks; `format_loss_line`
gives `train.sync`; the spans share the profiler's clock; `trace()` writes
them into its file, and `trace_summary` gives the device's idle time by
innermost span."""

import json
import os
import types

import numpy as np
import pytest
import torch

from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import meta as tm
from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.train import MetaTrainer, PlainTrainer, init_momentum
from fewshot_detection_tpu_torch.utils import format_loss_line
from fewshot_detection_tpu_torch.utils import profiling as prof
from fewshot_detection_tpu_torch.utils import trace_summary as ts
from torch_port_util import cfg

N_CLS, SIZE = 3, 32
PLAIN_CFG = """[net]
batch=2
width=32
height=32
channels=3

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


def _ticks(values):
    it = iter(values)
    return types.SimpleNamespace(time_ns=lambda: next(it), perf_counter=lambda: 0.0)


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not prof._RECORDER.on
    got = prof.span("train.forward", group=1)
    assert got is prof.NO_SPAN and prof.step_span("train.step") is prof.NO_SPAN
    with got as sp:
        sp.add("bytes", 10)
    assert prof._RECORDER.spans == [] and prof._RECORDER._stack == []


def test_nesting_gives_parents_step_ids_and_self_time(monkeypatch):
    monkeypatch.setattr(prof, "time", _ticks(range(0, 1000, 10)))
    with prof.recording() as spans:
        with prof.span("before"):  # 0-10
            pass
        with prof.step_span("step", n=1) as st:  # 20 ..
            with prof.span("a") as a:  # 30-40
                a.add("bytes", 5)
                a.add("bytes", 7)
            with prof.span("b"):  # 50 ..
                with prof.span("c"):  # 60-70
                    pass
            # b ends 80
            st.add("n", 2)
        # step ends 90
        with prof.span("after"):  # 100-110
            pass
        assert spans == []  # handed over when the block ends
    assert not prof._RECORDER.on and prof._RECORDER.spans == []
    assert [s.name for s in spans] == ["before", "step", "a", "b", "c", "after"]
    assert [s.parent for s in spans] == [-1, -1, 1, 1, 3, -1]
    assert [s.index for s in spans] == list(range(6))
    first = spans[1].step
    assert [s.step for s in spans] == [first - 1] + [first] * 5
    assert [(s.start, s.end) for s in spans] == [(0, 10), (20, 90), (30, 40), (50, 80),
                                                 (60, 70), (100, 110)]
    assert spans[2].counts == {"bytes": 12} and spans[1].counts == {"n": 3}
    assert prof.self_ns(spans) == [10, 70 - 10 - 30, 10, 20, 10, 10]
    assert prof.self_parts(spans) == [(0, 10, 0), (20, 30, 1), (30, 40, 2), (40, 50, 1),
                                      (50, 60, 3), (60, 70, 4), (70, 80, 3), (80, 90, 1),
                                      (100, 110, 5)]


def test_recordings_do_not_nest():
    with prof.recording():
        with pytest.raises(RuntimeError, match="do not nest"):
            with prof.recording():
                pass
        assert prof._RECORDER.on
    assert not prof._RECORDER.on


def _meta_setup(dtype=np.float32):
    names = ("tiny_darknet_dynamic.cfg", "tiny_reweighting.cfg")
    spec = tm.MetaSpec(*(build_spec(parse_cfg(cfg(n))) for n in names))
    params = tm.init_meta_params(spec, 0)
    tp = require_grads({k: from_jax_params(getattr(spec, k), params[k], "cpu")
                        for k in ("darknet", "learnet")})
    r = np.random.RandomState(3)
    R, b, size = 2, 1, 64
    target = np.zeros((R, b, N_CLS, 50, 5), np.float32)
    target[:, :, 0, 0] = [0, 0.5, 0.5, 0.3, 0.3]
    batch = {"x": r.rand(R, b, size, size, 3).astype(dtype),
             "metax": r.rand(R, N_CLS, size, size, 3).astype(dtype),
             "mask": (r.rand(R, N_CLS, size, size, 1) > 0.5).astype(dtype),
             "target": target, "keep": np.ones((R, b * N_CLS), np.float32)}
    return MetaTrainer(spec, weight_decay=5e-4, device="cpu"), tp, batch


def _plain_setup(tmp_path):
    path = os.path.join(tmp_path, "plain.cfg")
    with open(path, "w") as f:
        f.write(PLAIN_CFG)
    spec = build_spec(parse_cfg(path))
    tp = require_grads(from_jax_params(spec, init_params(spec, 0), "cpu"))
    r = np.random.RandomState(4)
    R, b = 2, 1
    target = np.zeros((R, b, 50, 5), np.float32)
    target[:, :, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    batch = {"x": r.rand(R, b, SIZE, SIZE, 3).astype(np.float32), "target": target,
             "keep": np.ones((R, b), np.float32)}
    return PlainTrainer(spec, weight_decay=5e-4, device="cpu"), tp, batch


@pytest.mark.parametrize("kind", ["meta", "plain"])
def test_a_train_step_records_its_phases_in_order(kind, tmp_path):
    trainer, tp, batch = _meta_setup() if kind == "meta" else _plain_setup(str(tmp_path))
    mom = init_momentum(tp)
    with prof.recording() as spans:
        tp, mom, metrics = trainer.step(tp, mom, batch, seen=64, lr=1e-3)
        line = format_loss_line(64, metrics)
    assert line.startswith("64: nGT ")
    loss = [s for s in spans if s.name == "train.loss"]
    if kind == "plain":  # the plain trainer's loss, inside each group's forward
        assert [spans[s.parent].name for s in loss] == ["train.forward"] * 2
        assert [s.counts for s in loss] == [
            {"heads": 1, "predictions": (SIZE // 2) ** 2 * 5, "truth_rows": 50}] * 2
    else:
        assert loss == []
    spans = [s for s in spans if s.name != "train.loss"]
    names = [s.name for s in spans]
    assert names == ["train.step", "train.to_device", "train.forward", "train.forward",
                     "train.backward", "train.update", "train.sync"]
    step = spans[0]
    assert [s.parent for s in spans] == [-1, 0, 0, 0, 0, 0, -1]
    assert {s.step for s in spans} == {step.step}  # the loss line belongs to its step
    assert [s.counts.get("group") for s in spans[2:4]] == [0, 1]
    want = sum(torch.as_tensor(batch[k]).nbytes for k in trainer._KEYS)
    # on the CPU nothing takes the pinned ring (train/staging.py)
    assert spans[1].counts == {"bytes": want, "staged_bytes": 0, "chunks": 0, "slot_waits": 0}
    # the plain bn_sums, bn_act and maxpool2x2 versions serve CPU tensors: no
    # kernel launches
    assert step.counts == {"bn_sums_forward": 0, "bn_sums_backward": 0,
                           "bn_act_forward": 0, "bn_act_backward": 0,
                           "pool_forward": 0, "pool_backward": 0}
    for a, b in zip(spans[1:6], spans[2:6]):
        assert a.end <= b.start
    assert step.start <= spans[1].start and spans[5].end <= step.end <= spans[6].start
    assert all(s.end >= s.start for s in spans)


def test_spans_lie_on_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with prof.recording() as spans:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            with prof.span("around"):
                with record_function("probe"):
                    torch.ones(64).sum()
    path = str(tmp_path / "t.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    ev = next(e for e in doc["traceEvents"] if e.get("name") == "probe")
    t = float(ev["ts"]) * 1000 + int(doc.get("baseTimeNanoseconds", 0))
    (s,) = spans
    # the trace's microseconds are rounded: a microsecond of slack each side
    assert s.start - 1000 <= t <= s.end + 1000
    assert s.start - 1000 <= t + float(ev["dur"]) * 1000 <= s.end + 1000


def _fake_clock(ticks):
    it = iter(ticks)
    return types.SimpleNamespace(perf_counter=lambda: next(it),
                                 time_ns=lambda: round(next(it) * 1e9))


def test_step_timer_phases_are_spans_and_its_line_is_unchanged(monkeypatch):
    monkeypatch.setattr(prof, "time", _fake_clock([10.0, 10.5, 10.75, 11.0, 13.125, 20.0]))
    t = prof.StepTimer()
    with t.phase("data") as a:
        assert isinstance(a, prof.Span) and a.name == "data"
    with t.phase("step"):
        pass
    assert t._spans.on and t._spans.spans == []  # folded into the totals, not kept
    assert t.summary(images=64) == ("data 0.25s (250.0ms/it) | step 2.12s (2125.0ms/it) "
                                    "| wall 10.00s | 6.4 images/s")
    assert not prof._RECORDER.on


def test_trace_writes_the_blocks_spans_and_summary_reads_them(monkeypatch, tmp_path):
    monkeypatch.setenv("FSD_PROFILE_DIR", str(tmp_path))
    with prof.trace(device="cpu") as path:
        with prof.step_span("train.step"):
            with prof.span("train.forward") as sp:
                sp.add("group", 0)
                torch.tanh(torch.ones(32, 32)).sum()
    with open(path) as f:
        doc = json.load(f)
    mine = [e for e in doc["traceEvents"] if e.get("cat") == prof.SPAN_CATEGORY]
    assert [e["name"] for e in mine] == ["train.step", "train.forward"]
    assert {e["tid"] for e in mine} == {prof.SPAN_LANE}
    assert mine[1]["args"]["group"] == 0 and mine[1]["args"]["parent"] == 0
    op = next(e for e in doc["traceEvents"] if e.get("name") == "aten::tanh")
    assert mine[1]["ts"] - 1 <= float(op["ts"]) <= mine[1]["ts"] + mine[1]["dur"] + 1
    # a CPU trace has no device timeline: nothing to put down to a span
    assert "idle_by_span" not in ts.summarize(ts.load_events(path))


def test_summary_puts_each_idle_part_down_to_its_innermost_span():
    def x(cat, name, t, d, parent=-1):
        return {"ph": "X", "cat": cat, "name": name, "ts": t, "dur": d, "pid": 0,
                "args": {"parent": parent}}

    ev = [x("kernel", "at::cuda::spin_kernel(long)", 0, 10),
          x("kernel", "k1", 20, 10),  # idle [10, 20): step 15-20, none 10-15
          x("gpu_memcpy", "Memcpy HtoD", 40, 10),  # idle [30, 40): copy 30-35, step 35-40
          x("kernel", "k2", 60, 20),  # idle [50, 60): forward
          x("kernel", "k3", 100, 5),  # idle [80, 100): step 80-90, sync 92-98, none
          x(prof.SPAN_CATEGORY, "train.step", 15, 75),
          x(prof.SPAN_CATEGORY, "train.to_device", 25, 10, parent=0),
          x(prof.SPAN_CATEGORY, "train.forward", 45, 20, parent=0),
          x(prof.SPAN_CATEGORY, "train.sync", 92, 6)]
    got, shift = ts.idle_by_span(ev)
    assert got == pytest.approx({"train.step": 5 + 5 + 10, "train.to_device": 5,
                                 "train.forward": 10, "train.sync": 6, ts.NO_SPAN: 5 + 4})
    assert shift == (0.0, 0.0)  # no launches to shift by
    s = ts.summarize(ev)
    assert s["idle_by_span"] == got and s["device_shift_us"] == shift
    assert ("-- device idle by innermost span (device times shifted by 0.0 us at the start, "
            "0.0 at the end) --") in ts.format_summary(s)
    assert ts.idle_by_span([e for e in ev if e["cat"] != prof.SPAN_CATEGORY]) is None


def _x(cat, name, t, d, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": t, "dur": d, "pid": 0, "args": args}


def _stretch_spans(k=1):
    """Two steps' spans as `write_spans` writes them, times k-fold."""
    out = []
    for s0, s1, c0, c1, f0, f1, b1, u1, y0, y1 in (
            (12, 95, 14, 30, 32, 60, 80, 94, 96, 99),
            (105, 190, 106, 120, 122, 150, 170, 185, 192, 196)):
        root = len(out)
        s0, s1, c0, c1, f0, f1, b1, u1, y0, y1 = (k * v for v in (s0, s1, c0, c1, f0, f1, b1,
                                                               u1, y0, y1))
        out += [_x(prof.SPAN_CATEGORY, "train.step", s0, s1 - s0, parent=-1),
                _x(prof.SPAN_CATEGORY, "train.to_device", c0, c1 - c0, parent=root),
                _x(prof.SPAN_CATEGORY, "train.forward", f0, f1 - f0, parent=root),
                _x(prof.SPAN_CATEGORY, "train.backward", f1, b1 - f1, parent=root),
                _x(prof.SPAN_CATEGORY, "train.update", b1, u1 - b1, parent=root),
                _x(prof.SPAN_CATEGORY, "train.sync", y0, y1 - y0, parent=-1)]
    return out


# two steps of device events: warm-up spins end at 10, the last event at 200
_DEVICE = (("kernel", "at::cuda::spin_kernel(long)", 0, 5),
           ("kernel", "at::cuda::spin_kernel(long)", 5, 5),
           ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 8),
           ("kernel", "conv", 36, 20), ("kernel", "bwd", 64, 10), ("kernel", "sgd", 84, 12),
           ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 110, 12),
           ("kernel", "conv", 122, 70), ("kernel", "tail", 195, 5))


def _launched(drift=lambda t: 0.0, k=1):
    """_DEVICE's events, times k-fold, each launched (a `cudaLaunchKernel`
    of the same correlation id) at its true start, the second spin 3k us
    before it (it waits behind the first); each device time t then read
    drift(t) early: a device clock that runs ahead of the host's."""
    out = []
    for c, (cat, name, t0, d) in enumerate(_DEVICE):
        t, end = k * t0, k * (t0 + d)
        out.append(_x("cuda_runtime", "cudaLaunchKernel", t - (3 * k if t0 == 5 else 0), 1,
                      correlation=c))
        out.append(_x(cat, name, t - drift(t), end - drift(end) - (t - drift(t)),
                      correlation=c))
    return out + _stretch_spans(k)


def test_upper_hull_is_the_least_concave_function_above_the_points():
    pts = [(0, 0), (1, 3), (2, 1), (3, 4), (4, 0), (4, 2)]
    assert ts.upper_hull(pts) == [(0, 0), (1, 3), (3, 4), (4, 2)]
    line = [(t, 2 + 0.5 * t) for t in range(6)] + [(2.5, 1.0)]
    assert ts.upper_hull(line) == [(0, 2.0), (5, 4.5)]


def test_a_stretch_read_on_the_true_clock_gives_its_known_idle():
    idle, shift = ts.idle_by_span(_launched())
    assert shift == (0.0, 0.0)
    assert idle == pytest.approx({
        ts.NO_SPAN: 2 + 6, "train.step": 2 + 2 + 1, "train.to_device": 6 + 2 + 4,
        "train.forward": 4 + 4, "train.backward": 4 + 6, "train.update": 4,
        "train.sync": 3 + 3})


@pytest.mark.parametrize("drift, k", [
    (lambda t: 25.0, 1),  # every device time 25 us early (gaps of 2-14 us)
    (lambda t: -50.0, 1),  # 50 us late
    # times 1000-fold (gaps of 2-14 ms): 20 us early at the start, 1.02 ms at the end
    (lambda t: 20 + 0.005 * t, 1000),
    (lambda t: 500 - 0.005 * t, 1000),  # 0.5 ms early at the start, 0.5 ms late at the end
], ids=["early", "late", "growing", "crossing"])
def test_a_device_clock_off_by_an_offset_and_a_rate_is_put_back(drift, k):
    """Read with the launches, the trace gives the idle of the true device
    times; read without them, it misplaces it."""
    true, _ = ts.idle_by_span(_launched(k=k))
    ev = _launched(drift, k)
    fixed, shift = ts.idle_by_span(ev)
    lo, hi = 10 * k - drift(10 * k), 200 * k - drift(200 * k)  # the window, as read
    assert shift == pytest.approx((drift(lo + drift(lo)), drift(hi + drift(hi))), rel=1e-3)
    names = set(true) | set(fixed)
    for key in names:
        assert fixed.get(key, 0) == pytest.approx(true.get(key, 0), rel=1e-6, abs=1e-6), key
    raw, _ = ts.idle_by_span([e for e in ev if e["cat"] != "cuda_runtime"])
    assert max(abs(raw.get(key, 0) - true.get(key, 0)) for key in names) > 0.3 * k


def test_events_queued_behind_their_launches_do_not_move_the_shift():
    """Every time 25 us early; the tail kernel, and the second spin,
    started long after their launches (a busy card): they lie under the
    line that the kernels after idle gaps hold, at either end."""
    ev = _launched(lambda t: 25.0)
    launches = [e for e in ev if e["cat"] == "cuda_runtime"]
    launches[-1]["ts"] -= 150
    launches[1]["ts"] -= 150
    shift = ts.clock_shift([e for e in ev if e["cat"] in ts.GPU_CATEGORIES],
                           {e["args"]["correlation"]: e["ts"] for e in launches})
    assert [shift(t) for t in (0.0, 170.0, 1e6)] == pytest.approx([25.0] * 3)
    assert ts.idle_by_span(ev)[1] == pytest.approx((25.0, 25.0))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


SPIN_CYCLES = 200_000  # about 0.1 ms on an H100
SLACK_US = 20.0


@pytest.mark.card
def test_a_kernel_launched_inside_a_span_starts_after_the_span(card, tmp_path):
    """Read from a trace of device activity alone, on the file's own
    `baseTimeNanoseconds`: the shared clock holds to SLACK_US."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        prof.warm_up_cuda_trace()
        with prof.recording() as spans:
            for _ in range(20):
                with prof.span("probe"):
                    torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
    path = str(tmp_path / "t.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    spins = sorted(float(e["ts"]) for e in doc["traceEvents"]
                   if e.get("cat") == "kernel" and prof.WARMUP_KERNEL in e["name"]
                   and float(e.get("dur", 0)) > 20)
    assert len(spins) == len(spans) == 20
    lags = [k - (s.start - base) / 1e3 for k, s in zip(spins, spans)]
    print("kernel start after its span's start, us:", [round(v, 2) for v in lags])
    assert min(lags) >= -SLACK_US
    assert all(k <= (s.end - base) / 1e3 + 1e3 for k, s in zip(spins, spans))


@pytest.mark.card
def test_a_traced_card_step_puts_its_idle_down_to_its_spans(card, tmp_path):
    """Three plain steps on the card under `trace()`: the idle goes to the
    step's spans, `train.step` counts one bn_sums and one bn_act launch a BN
    layer and a replica group each way, and each `train.sync` ends after its step's last kernel (the
    device's times shifted by their launches)."""
    trainer, tp, batch = _plain_setup(str(tmp_path))
    spec = trainer.spec
    tp = require_grads(from_jax_params(spec, init_params(spec, 0), "cuda"))
    trainer = PlainTrainer(spec, weight_decay=5e-4, device="cuda")
    mom = init_momentum(tp)
    tp, mom, metrics = trainer.step(tp, mom, batch, seen=64, lr=1e-3)  # warm-up
    format_loss_line(64, metrics)
    with prof.trace(str(tmp_path / "t"), device="cuda") as path:
        for i in range(3):
            tp, mom, metrics = trainer.step(tp, mom, batch, seen=128 + 64 * i, lr=1e-3)
            format_loss_line(128 + 64 * i, metrics)
    events = ts.load_events(path)
    s = ts.summarize(events)
    print(ts.format_summary(s))
    idle = s["idle_by_span"]
    assert set(idle) <= {"train.step", "train.to_device", "train.forward", "train.loss",
                         "train.backward", "train.update", "train.sync", ts.NO_SPAN}
    mine = [e for e in events if e.get("cat") == prof.SPAN_CATEGORY]
    steps = [e for e in mine if e["name"] == "train.step"]
    # one launch a BN layer each way, in each of the R = 2 replica groups
    n_bn = sum(1 for layer in spec.layers if layer.batch_normalize) * len(batch["x"])
    assert len(steps) == 3
    assert [(e["args"]["bn_sums_forward"], e["args"]["bn_sums_backward"]) for e in steps] == [
        (n_bn, n_bn)] * 3
    assert [(e["args"]["bn_act_forward"], e["args"]["bn_act_backward"]) for e in steps] == [
        (n_bn, n_bn)] * 3
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in complete if e.get("cat") in ts.GPU_CATEGORIES]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in complete
                if e.get("cat") in ts.HOST_CUDA_CATEGORIES and "correlation" in e.get("args", {})}
    shift = ts.clock_shift(device, launches)
    for e in (e for e in mine if e["name"] == "train.sync"):
        step = next(st for st in steps if st["args"]["step"] == e["args"]["step"])
        # the step's device events: those launched inside its span
        ends = [float(d["ts"]) + float(d["dur"]) for d in device
                if step["ts"] <= launches.get(d["args"].get("correlation"), -1)
                <= step["ts"] + step["dur"]]
        last = max(t + shift(t) for t in ends)
        assert e["ts"] + e["dur"] >= last - SLACK_US


# (networks, 2x2 stride-2 pools a step of one replica group): the meta
# detector's 5 backbone and 6 learnet pools, YOLOv2's 5, YOLOv3 none
STEP_POOLS = [(("darknet_dynamic.cfg", "reweighting_net.cfg"), 11), (("yolo-voc.cfg",), 5),
              (("yolov3.cfg",), 0)]


@pytest.mark.card
@pytest.mark.parametrize("cfgs,pools", STEP_POOLS, ids=["meta", "yolov2", "yolov3"])
def test_a_card_step_counts_its_pool_launches(card, cfgs, pools):
    """One step of each network of the benchmark's cells at 64 px (R = 1):
    `train.step` counts one `maxpool2x2` launch each way a 2x2 stride-2
    pool, and the step puts no PyTorch pooling kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    specs = [build_spec(parse_cfg(cfg(n))) for n in cfgs]
    r = np.random.RandomState(5)
    size = 64
    if len(specs) == 2:
        spec = tm.MetaSpec(*specs)
        params = tm.init_meta_params(spec, 0)
        tp = require_grads({k: from_jax_params(getattr(spec, k), params[k], "cuda")
                            for k in ("darknet", "learnet")})
        target = np.zeros((1, 2, N_CLS, 50, 5), np.float32)
        target[:, :, 0, 0] = [0, 0.5, 0.5, 0.3, 0.3]
        batch = {"x": r.rand(1, 2, size, size, 3).astype(np.float32),
                 "metax": r.rand(1, N_CLS, size, size, 3).astype(np.float32),
                 "mask": (r.rand(1, N_CLS, size, size, 1) > 0.5).astype(np.float32),
                 "target": target, "keep": np.ones((1, 2 * N_CLS), np.float32)}
        trainer = MetaTrainer(spec, weight_decay=5e-4, device="cuda")
    else:
        (spec,) = specs
        tp = require_grads(from_jax_params(spec, init_params(spec, 0), "cuda"))
        target = np.zeros((1, 2, 50, 5), np.float32)
        target[:, :, 0] = [1, 0.5, 0.5, 0.3, 0.3]
        batch = {"x": r.rand(1, 2, size, size, 3).astype(np.float32), "target": target,
                 "keep": np.ones((1, 2), np.float32)}
        trainer = PlainTrainer(spec, weight_decay=5e-4, device="cuda")
    mom = init_momentum(tp)
    tp, mom, _ = trainer.step(tp, mom, batch, seen=64, lr=1e-3)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        with prof.recording() as spans:
            tp, mom, metrics = trainer.step(tp, mom, batch, seen=128, lr=1e-3)
            format_loss_line(128, metrics)
        torch.cuda.synchronize()
    (step,) = [s for s in spans if s.name == "train.step"]
    assert (step.counts["pool_forward"], step.counts["pool_backward"]) == (pools, pools)
    names = [ev.key for ev in p.key_averages() if ev.device_type.name == "CUDA"]
    assert not [n for n in names if "pool" in n.lower() and "maxpool2x2" not in n], names
