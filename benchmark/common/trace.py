"""Profiled stretches of a run and what the per-layer readers take from them.

`profile_stretch(fn, cuda, steps)` runs `fn` twice under `torch.profiler`,
each time after the spin-kernel warm-up of `utils/profiling.trace` (a
trace on the card can lose its first device events). The first stretch
records device activity alone, so that the host runs at nearly its
untraced pace: its window is the `WINDOW` annotation where the trace keeps
one, else from the end of the last warm-up kernel to the end of the last
device event, and every metric reads it. The second
records the host's operators too, inside a `record_function` named
`WINDOW`; recording them slows the host, so it serves only to name the
idle gaps of the breakdown by the host operator running in them. Each
trace is exported to a temporary file, read back and deleted.

`Trace` holds the device events (kernels, copies, memsets) and the host
operators of one window, and answers: the union of device intervals (busy
time, not a sum, so overlapping streams count once), the idle share of the
window, device time by kind of kernel, and the breakdown the result line
carries.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict

from .kinds import kernel_base_name, kind_of

WINDOW = "bench_window"
GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WARMUP_LAUNCHES = 64
SPIN = "spin_kernel"  # torch.cuda._sleep's kernel, the warm-up's


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_us(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi) between the union's intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(host: list[dict], points: list[float]) -> list[str]:
    """For each point, the name of the shortest host operator running at it
    ("(no operator)" where none is): a sweep over the points in order with
    the operators begun so far in a heap by duration, the ended ones dropped
    when they reach its top."""
    ops = sorted((float(h["ts"]), float(h["ts"]) + float(h["dur"]), float(h["dur"]), h["name"])
                 for h in host)
    names = [""] * len(points)
    heap: list = []
    i = 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        t = points[k]
        while i < len(ops) and ops[i][0] <= t:
            heapq.heappush(heap, (ops[i][2], ops[i][1], ops[i][3]))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        names[k] = heap[0][2] if heap else "(no operator)"
    return names


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


class Trace:
    """The device events and host operators of one profiled window: the
    `WINDOW` annotation's where the trace has it, else (device activity
    alone) from the end of the last warm-up spin kernel to the end of the
    last device event. `named`, where set, is the trace whose host
    operators name the breakdown's idle gaps."""

    def __init__(self, events: list[dict], steps: int):
        self.steps = steps  # steps or batches the window ran
        self.named, self.host_s = None, None
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        device = [e for e in complete if e.get("cat") in GPU_CATEGORIES]
        marks = [e for e in complete if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if marks:
            self.lo, self.hi = float(marks[-1]["ts"]), _end(marks[-1])
        else:
            spins = [e for e in device if SPIN in e["name"]]
            rest = [e for e in device if SPIN not in e["name"]]
            if not rest:
                raise ValueError("the trace has neither a window annotation nor device events")
            self.lo = max(map(_end, spins)) if spins else min(float(e["ts"]) for e in rest)
            self.hi = max(map(_end, rest))
        self.device = [e for e in device if self.lo <= float(e["ts"]) < self.hi]
        self.host = [e for e in complete if e.get("cat") == "cpu_op"
                     and float(e["ts"]) < self.hi and _end(e) > self.lo]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def _intervals(self):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device]

    @property
    def busy_s(self) -> float:
        return union_us(self._intervals(), self.lo, self.hi) / 1e6

    def idle_pct(self) -> float | None:
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def seconds(self, pred) -> float:
        """Summed device seconds of the events for which pred(event) holds."""
        return sum(float(e["dur"]) for e in self.device if pred(e)) / 1e6

    def kernel_s(self, *kinds: str) -> float:
        return self.seconds(lambda e: e["cat"] == "kernel" and kind_of(e["name"]) in kinds)

    def memcpy_s(self, direction: str) -> float:
        return self.seconds(lambda e: e["cat"] == "gpu_memcpy" and direction in e["name"])

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps (of `named`'s window where set) summed by the host operator
        running in them (the innermost operator around a gap's middle)."""
        ops: dict = defaultdict(float)
        for e in self.device:
            name = kernel_base_name(e["name"]) if e["cat"] == "kernel" else e["name"]
            ops[name] += float(e["dur"]) / 1e6
        idle: dict = defaultdict(float)
        named = self.named or self
        gaps = gaps_us(named._intervals(), named.lo, named.hi)
        for (s, e), name in zip(gaps, innermost(named.host, [(s + e) / 2 for s, e in gaps])):
            idle[name] += (e - s) / 1e6
        return {
            "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        }


def _profiled(fn, activities, cuda: bool, steps: int) -> Trace:
    import torch
    from torch.profiler import profile, record_function

    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(WARMUP_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        t = time.perf_counter()
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
        host_s = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    trace = Trace(events, steps)
    trace.host_s = host_s  # the stretch's seconds on the host's clock
    return trace


def profile_stretch(fn, cuda: bool, steps: int) -> Trace:
    """Run fn() (`steps` steps, ending in a synchronise on the card) under
    device activity alone, then again with the host's operators too (see
    the module's docstring). Returns the first stretch's Trace, whose
    `named` is the second's; on the CPU, one stretch with host operators."""
    from torch.profiler import ProfilerActivity

    if not cuda:
        return _profiled(fn, [ProfilerActivity.CPU], False, steps)
    trace = _profiled(fn, [ProfilerActivity.CUDA], True, steps)
    trace.named = _profiled(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA], True, steps)
    return trace
