"""Tracing / profiling utilities.

Own copy of the JAX package's `utils/profiling.py`. The reference's tracing
story was hand-rolled time.time() stopwatches behind `if False:` flags
(train.py:179-223, region_loss.py:162-230, utils.py:121-192). Here:

  * span() / recording() — spans at the program's layer boundaries (the
    train step's phases, `train/trainer.py`; the loss line's transfer,
    `utils/logging.py`). A span holds its name, its start and end as
    `time.time_ns()`, the index of its parent, the identifier of the train
    step it belongs to, and counts. The module's recorder is off unless a
    `recording()` block is open: `span` then returns one shared no-op
    context. `time.time_ns()` is CLOCK_REALTIME, the clock on which
    torch.profiler writes a Chrome trace's events (an event's `ts` in us
    plus the file's `baseTimeNanoseconds`), and onto which Kineto maps the
    device's timestamps: spans can be laid over the kernels of a trace that
    records device activity alone
  * StepTimer — always-on lightweight phase timing with an images/sec
    summary line (the reference's throughput log, train_meta.py:250); the
    same line, format for format, as the JAX package's. Its phases are
    spans of a recorder of its own, always on
  * trace() — a `torch.profiler` context (CPU activity, plus CUDA when the
    traced device is a CUDA device) that writes a Chrome trace
    `<dir>/trace_<pid>_<n>.pt.trace.json` when FSD_PROFILE_DIR (or the
    argument) is set, with the block's spans on a lane of their own;
    `python -m fewshot_detection_tpu_torch.utils.trace_summary <dir>`
    summarises it, the device's idle time by span included. A CUDA trace
    opens with WARMUP_LAUNCHES spin kernels (`warm_up_cuda_trace`): a trace
    on the card can miss its first device events (seen on an H100 by
    chip_smoke.py: a training step's first bn_sums forward, and the only
    kernel of one short call)
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from collections import defaultdict


class Span:
    """One timed region of one thread: `name`; `start` and `end` in ns of
    `time.time_ns()`; `index`, its place in the recorder's list, and
    `parent`, its enclosing span's (-1: none); `step`, the identifier of
    the train step it belongs to (0: before any); `counts`. Entered, it is
    its own context; `add` sums into a count."""

    __slots__ = ("name", "start", "end", "index", "parent", "step", "counts", "_rec")

    def __init__(self, rec, name: str, counts: dict):
        self._rec, self.name, self.counts = rec, name, counts
        self.start = self.end = 0
        self.index = self.parent = -1
        self.step = rec.step

    def add(self, key: str, value) -> None:
        self.counts[key] = self.counts.get(key, 0) + value

    def __enter__(self):
        rec = self._rec
        if rec._stack:
            self.parent = rec._stack[-1].index
        if rec.done is None:
            self.index = len(rec.spans)
            rec.spans.append(self)
        rec._stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        rec = self._rec
        rec._stack.pop()
        if rec.done is not None:
            rec.done(self)
        return False


class _NoSpan:
    """What `span` returns while its recorder is off: enters and adds
    nothing, reads no clock."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, value) -> None:
        pass


NO_SPAN = _NoSpan()


class Recorder:
    """Spans of one thread, in the order they start. Off, `span` is one flag
    test and returns NO_SPAN. `step_span` opens a span that starts a new
    step identifier, which every span until the next one carries. With
    `done` set, each finished span is handed to it and not kept."""

    def __init__(self, on: bool = False, done=None):
        self.on, self.done = on, done
        self.spans: list[Span] = []
        self.step = 0
        self._stack: list[Span] = []

    def span(self, name: str, **counts):
        if not self.on:
            return NO_SPAN
        return Span(self, name, counts)

    def step_span(self, name: str, **counts):
        if not self.on:
            return NO_SPAN
        self.step += 1
        return Span(self, name, counts)


_RECORDER = Recorder()
span = _RECORDER.span  # a span of the module's recorder
step_span = _RECORDER.step_span  # a span of the module's recorder that starts a step


@contextlib.contextmanager
def recording():
    """The module's recorder on for the block. Yields a list that holds the
    block's finished spans once the block ends. Blocks do not nest."""
    rec = _RECORDER
    if rec.on:
        raise RuntimeError("recording() blocks do not nest")
    rec.on = True
    out: list[Span] = []
    try:
        yield out
    finally:
        rec.on = False
        out.extend(rec.spans)
        rec.spans = []


def self_parts(spans) -> list[tuple]:
    """(start, end, index) of the stretches of time in which each span is
    the innermost one open: its interval less its children's, in order of
    time. `spans` are a recorder's list, or hold `start`, `end`, `index`
    (their place in the list) and `parent` as its spans do."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent >= 0:
            kids[s.parent].append(s)
    out = []
    for s in spans:
        t = s.start
        for c in kids[s.index]:  # in the order they started
            if c.start > t:
                out.append((t, c.start, s.index))
            t = max(t, c.end)
        if s.end > t:
            out.append((t, s.end, s.index))
    return sorted(out)


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's duration less what its children cover."""
    out = [0] * len(spans)
    for start, end, i in self_parts(spans):
        out[i] += end - start
    return out


class StepTimer:
    """Accumulates named phase durations across steps.

    with timer.phase("data"): ...
    with timer.phase("step"): ...
    print(timer.summary(images=...))

    A phase is a span of the timer's own recorder, always on, folded into
    the totals as it ends. The wall time is on the spans' clock too,
    `time.time_ns()`: CLOCK_REALTIME, which a step of the system's clock
    moves; the line is a log of an epoch, not a benchmark.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._spans = Recorder(on=True, done=self._add)
        self._t0 = time.time_ns()

    def phase(self, name: str) -> Span:
        return self._spans.span(name)

    def _add(self, s: Span) -> None:
        self.totals[s.name] += (s.end - s.start) / 1e9
        self.counts[s.name] += 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self._t0 = time.time_ns()

    def summary(self, images: int | None = None) -> str:
        wall = (time.time_ns() - self._t0) / 1e9
        parts = [
            f"{k} {self.totals[k]:.2f}s ({self.totals[k] / max(self.counts[k], 1) * 1e3:.1f}ms/it)"
            for k in sorted(self.totals)
        ]
        line = " | ".join(parts) + f" | wall {wall:.2f}s"
        if images is not None:
            line += f" | {images / max(wall, 1e-9):.1f} images/s"
        return line


_trace_ids = itertools.count()
WARMUP_LAUNCHES = 64
WARMUP_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, as traces name it


def warm_up_cuda_trace() -> None:
    """WARMUP_LAUNCHES spin kernels of one cycle each, then a synchronise:
    the first device events of a trace, which it can miss."""
    import torch

    for _ in range(WARMUP_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None = None, device=None):
    """torch.profiler trace of the block when a log dir is configured (the
    argument or FSD_PROFILE_DIR); a no-op otherwise. CUDA kernels are traced
    when `device` is a CUDA device. The block's spans are recorded and
    written into the same file (`write_spans`). Yields the trace file's path
    (None when off); the file is written when the block ends."""
    log_dir = log_dir or os.environ.get("FSD_PROFILE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.pt.trace.json")
    with recording() as spans:
        with profile(activities=activities) as prof:
            if ProfilerActivity.CUDA in activities:
                warm_up_cuda_trace()
            yield path
    prof.export_chrome_trace(path)
    write_spans(path, spans)


SPAN_CATEGORY = "fsd_span"
SPAN_LANE = 1 << 30  # the spans' thread id in a trace; no thread has it


def write_spans(path: str, spans: list[Span]) -> None:
    """Add `spans` to the Chrome trace at `path` as complete events of
    category SPAN_CATEGORY on a lane of their own ("program spans"), their
    `ts` against the file's `baseTimeNanoseconds` (0 where it has none),
    their step, parent and counts under `args`."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_LANE,
                   "args": {"name": "program spans"}})
    events.extend({"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid,
                   "tid": SPAN_LANE, "ts": (s.start - base) / 1e3,
                   "dur": (s.end - s.start) / 1e3,
                   "args": {"step": s.step, "parent": s.parent, **s.counts}}
                  for s in spans)
    with open(path, "w") as f:
        json.dump(doc, f)
