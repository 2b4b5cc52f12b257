"""Tracing / profiling utilities.

Own copy of the JAX package's `utils/profiling.py`. The reference's tracing
story was hand-rolled time.time() stopwatches behind `if False:` flags
(train.py:179-223, region_loss.py:162-230, utils.py:121-192). Here:

  * StepTimer — always-on lightweight phase timing with an images/sec
    summary line (the reference's throughput log, train_meta.py:250); the
    same line, format for format, as the JAX package's
  * trace() — a `torch.profiler` context (CPU activity, plus CUDA when the
    traced device is a CUDA device) that writes a Chrome trace
    `<dir>/trace_<pid>_<n>.pt.trace.json` when FSD_PROFILE_DIR (or the
    argument) is set; `python -m fewshot_detection_tpu_torch.utils.trace_summary
    <dir>` summarises it. A CUDA trace opens with WARMUP_LAUNCHES spin
    kernels (`warm_up_cuda_trace`): a trace on the card can miss its first
    device events (seen on an H100 by chip_smoke.py: a training step's
    first bn_sums forward, and the only kernel of one short call)
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict


class StepTimer:
    """Accumulates named phase durations across steps.

    with timer.phase("data"): ...
    with timer.phase("step"): ...
    print(timer.summary(images=...))
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t
            self.counts[name] += 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self._t0 = time.perf_counter()

    def summary(self, images: int | None = None) -> str:
        wall = time.perf_counter() - self._t0
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
    when `device` is a CUDA device. Yields the trace file's path (None when
    off); the file is written when the block ends."""
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
    with profile(activities=activities) as prof:
        if ProfilerActivity.CUDA in activities:
            warm_up_cuda_trace()
        yield path
    prof.export_chrome_trace(path)
