"""The port's profiling utilities against the JAX package's.

`StepTimer` must print the JAX package's line character for character under
a pinned clock; `trace()` is a no-op without a directory and otherwise
writes a torch.profiler Chrome trace that `trace_summary` finds and
summarises; on JAX-style traces (device timelines named by their process)
`summarize` returns the JAX package's dict exactly."""

import json
import types

import pytest
import torch

from fewshot_detection_tpu.utils import profiling as j_prof
from fewshot_detection_tpu.utils import trace_summary as j_ts
from fewshot_detection_tpu_torch.utils import profiling as t_prof
from fewshot_detection_tpu_torch.utils import trace_summary as t_ts


def _fake_clock(ticks):
    # the port's phases are spans, timed by time_ns on the same ticks
    it = iter(ticks)
    return types.SimpleNamespace(perf_counter=lambda: next(it),
                                 time_ns=lambda: round(next(it) * 1e9))


@pytest.mark.parametrize("images", [None, 0, 24, 3000])
def test_step_timer_line_equals_jax(monkeypatch, images):
    ticks = [10.0, 10.5, 10.75, 11.0, 13.125, 13.5, 13.50001, 20.0, 20.25, 26.2]
    lines = []
    for mod in (t_prof, j_prof):
        monkeypatch.setattr(mod, "time", _fake_clock(ticks))
        t = mod.StepTimer()
        with t.phase("data"):
            pass
        with t.phase("step"):
            pass
        with t.phase("sync"):
            pass
        with t.phase("data"):
            pass
        lines.append(t.summary(images=images))
    assert lines[0] == lines[1]
    assert lines[0].startswith("data ") and "| sync " in lines[0]


def test_trace_is_a_noop_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("FSD_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with t_prof.trace() as path:
        x = 1 + 1
    assert x == 2 and path is None
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    mp = pytest.MonkeyPatch()
    mp.setenv("FSD_PROFILE_DIR", d)
    try:
        with t_prof.trace(device="cpu") as path:
            x = torch.ones(128, 128)
            for _ in range(3):
                y = torch.tanh(x @ x) + 1
            float(y.sum())
    finally:
        mp.undo()
    return d, path


def test_a_real_cpu_trace_is_found_and_summarised(cpu_trace, capsys):
    d, path = cpu_trace
    assert t_ts.find_trace_files(d) == [path]
    s = t_ts.summarize(t_ts.load_events(path))
    assert s["total_us"] > 0 and s["device"].startswith("CPU operators")
    assert s["counts"]["aten::tanh"] == 3 and s["counts"]["aten::mm"] == 3
    assert t_ts.main([d, "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "device timeline" in out and "-- top 3 ops --" in out
    assert t_ts.main([str(d) + "/nothing_here"]) == 1


def _jax_style_events(seed):
    """A device timeline as jax.profiler writes it: processes named by
    their device, complete events with fusion-numbered names, enclosing
    jit_ markers and step numbers that must not count."""
    import random

    rng = random.Random(seed)
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "process_name", "pid": 3, "args": {"name": "TPU:1 Ops"}},
    ]
    names = ["fusion.1", "fusion.12", "convolution.3", "copy", "jit_step", "17", "all-reduce.2"]
    for _ in range(40):
        events.append({"ph": "X", "name": rng.choice(names), "pid": rng.choice([1, 2, 3]),
                       "ts": rng.uniform(0, 1e4), "dur": rng.uniform(1, 100)})
    events.append({"ph": "i", "name": "marker", "pid": 1, "ts": 5.0})
    return events


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("substr", ["TPU", "Ops"])
def test_summarize_equals_jax_on_jax_style_events(seed, substr):
    ev = _jax_style_events(seed)
    got = t_ts.summarize(ev, device_substr=substr)
    assert got == j_ts.summarize(ev, device_substr=substr)
    assert t_ts.format_summary(got, top=4) == j_ts.format_summary(got, top=4)


def test_summarize_falls_back_like_jax_when_no_process_matches():
    ev = [{"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "Accel 0"}},
          {"ph": "M", "name": "process_name", "pid": 8, "args": {"name": "CPU host"}},
          {"ph": "X", "name": "fusion.3", "pid": 7, "ts": 0, "dur": 5.0},
          {"ph": "X", "name": "fusion.4", "pid": 8, "ts": 0, "dur": 7.0}]
    assert t_ts.summarize(ev, "GPU") == j_ts.summarize(ev, "GPU")


def test_kineto_gpu_events_are_the_device_timeline(tmp_path):
    """A Kineto trace with a GPU timeline: kernels, copies and sets count;
    host operators and runtime calls do not; a kernel's category is its name
    without template arguments and parameters."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 99, "args": {"name": "python"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 99, "ts": 0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 99, "ts": 0,
         "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "void bn_sums_vec_kernel<float, 4>(float const*)",
         "pid": 0, "ts": 0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void bn_sums_vec_kernel<__nv_bfloat16, 8>(int)",
         "pid": 0, "ts": 20, "dur": 6.0},
        {"ph": "X", "cat": "kernel", "name": "bn_sums_bwd_kernel", "pid": 0, "ts": 40, "dur": 4.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0,
         "ts": 50, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "ts": 90,
         "dur": 1.0},
    ]
    s = t_ts.summarize(ev)
    assert s["device"] == "GPU 0"
    assert s["total_us"] == 51.0
    assert s["categories"] == {"bn_sums_vec_kernel": 16.0, "bn_sums_bwd_kernel": 4.0,
                               "gpu_memcpy": 30.0, "gpu_memset": 1.0}
    assert s["counts"]["bn_sums_bwd_kernel"] == 1
    path = tmp_path / "x" / "t.pt.trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": ev}))
    assert t_ts.find_trace_files(str(tmp_path)) == [str(path)]
    assert t_ts.summarize(t_ts.load_events(str(path))) == s
    assert t_ts.kernel_base_name("void at::native::k<4, float>(float*)") == "at::native::k"
    assert t_ts.kernel_base_name(
        "void at::native::(anonymous namespace)::k2<float>(int)") == "at::native::k2"
    assert t_ts.kernel_base_name("<unnamed>") == "<unnamed>"
