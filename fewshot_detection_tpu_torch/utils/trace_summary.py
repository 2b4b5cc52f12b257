"""Profiler-trace summarizer: where does a step actually go?

Own counterpart of the JAX package's `utils/trace_summary.py`. Parses the
Chrome-format trace that `utils/profiling.trace` writes under
FSD_PROFILE_DIR (a `torch.profiler` / Kineto trace) and prints
per-category and top-op time tables for the device timeline.

    python -m fewshot_detection_tpu_torch.utils.trace_summary <trace_dir> [--top N]

In a Kineto trace the device timeline is the GPU's: the complete events of
category `kernel`, `gpu_memcpy` and `gpu_memset`; a kernel's category is its
name without template arguments and parameters. A trace with no GPU events
(a CPU-only run) is summarised over its host operators (`cpu_op`) and says
so. On a JAX-style trace (device timelines named by their process) the
summary is the JAX package's.

Where the trace also holds the program's spans (`utils/profiling.trace`
writes them, category `fsd_span`) and GPU events, the summary adds the
device's idle time by the innermost span open over it (`idle_by_span`):
the gaps between the union of device intervals, from the end of the last
warm-up spin kernel to the end of the last device event, each part of a
gap given to the span that is innermost there, "(no span)" where none is.
Kineto maps the device's timestamps onto the host's clock by a calibration
that can be off by an offset and a rate (on an H100, in 14 of 38 stretches
the kernels read from 58 us to 8.2 ms ahead of their own launches), which
moves idle across span edges by as much. No device event starts before
the CUDA call that launched it (`cuda_runtime` / `cuda_driver`, the same
correlation id), so the device's times are first shifted by the least
straight line of time that puts no event before its launch (`clock_shift`:
the edge over the stretch's middle of the upper hull of each event's
(start, launch - start); right after an idle gap the card starts a kernel
a few microseconds after its launch, and such kernels hold the line, while
events queued behind their launches lie below it). The summary gives the
shift at the window's two ends (`device_shift_us`).
"""

from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os
import re
import sys
import types

from .profiling import SPAN_CATEGORY, WARMUP_KERNEL, self_parts

GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CUDA_CATEGORIES = ("cuda_runtime", "cuda_driver")  # the host's CUDA calls
NO_SPAN = "(no span)"


def find_trace_files(trace_dir: str) -> list[str]:
    pats = [
        os.path.join(trace_dir, "**", "*.trace.json.gz"),
        os.path.join(trace_dir, "**", "*.trace.json"),
    ]
    out: list[str] = []
    for p in pats:
        out.extend(glob.glob(p, recursive=True))
    return sorted(out)


def load_events(path: str) -> list[dict]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def kernel_base_name(name: str) -> str:
    """`void ns::(anonymous namespace)::kern<4, float>(float*, int)` ->
    `ns::kern`; a name that would come out empty stays whole."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[len("void "):]
    for stop in ("<", "("):
        if base.find(stop) > 0:
            base = base[:base.index(stop)]
    return base.strip() or name


def _process_names(events: list[dict], key: str = "process_name") -> dict:
    """pid -> the name (or, for key "process_labels", the labels) that the
    trace's metadata events give it."""
    field = "labels" if key == "process_labels" else "name"
    return {
        e["pid"]: str(e["args"].get(field, ""))
        for e in events
        if e.get("ph") == "M" and e.get("name") == key
    }


def _aggregate(picked, category) -> tuple[dict, dict, dict]:
    cats: collections.Counter = collections.Counter()
    ops: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for e in picked:
        n = e["name"]
        ops[n] += e["dur"]
        counts[n] += 1
        cats[category(e)] += e["dur"]
    return dict(cats), dict(ops), dict(counts)


def _idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers, in order."""
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


def upper_hull(points) -> list[tuple[float, float]]:
    """The vertices, in order of x, of the upper hull of (x, y) `points`:
    the least concave function above them all."""
    hull: list = []
    for p in sorted(set(points)):
        while hull and hull[-1][0] == p[0]:
            hull.pop()
        while len(hull) >= 2 and ((hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1])
                                  >= (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])):
            hull.pop()
        hull.append(p)
    return hull


def clock_shift(device: list[dict], launches: dict):
    """The shift (us) to add to a device time `t`, as a function of `t`:
    the least straight line under which no event of `device` starts
    before its launch (`launches`: correlation id to the launch's `ts`),
    which is the edge of their upper hull over the stretch's middle (see
    the module's docstring); None where no event has a launch."""
    ahead = [(float(e["ts"]), launches[c] - float(e["ts"])) for e in device
             if (c := e.get("args", {}).get("correlation")) in launches]
    if not ahead:
        return None
    hull = upper_hull(ahead)
    if len(hull) == 1:
        return lambda t: hull[0][1]
    xs = [x for x, _ in hull]
    i = min(bisect.bisect_right(xs, (xs[0] + xs[-1]) / 2), len(hull) - 1)
    (x0, y0), (x1, y1) = hull[i - 1], hull[i]
    rate = (y1 - y0) / (x1 - x0)
    return lambda t: y0 + rate * (t - x0)


def idle_by_span(events: list[dict]) -> tuple[dict, tuple[float, float]] | None:
    """({innermost span name or NO_SPAN: idle us}, the device's shift in us
    at the window's start and end) of a Kineto trace with the program's
    spans (see the module's docstring); None without GPU events or spans.
    The spans' nesting is their `parent` indices, each span's index its
    place among the trace's spans, as `write_spans` wrote them."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [types.SimpleNamespace(name=e["name"], start=float(e["ts"]),
                                   end=float(e["ts"]) + float(e["dur"]), index=i,
                                   parent=e.get("args", {}).get("parent", -1))
             for i, e in enumerate(e for e in complete if e.get("cat") == SPAN_CATEGORY)]
    device = [e for e in complete if e.get("cat") in GPU_CATEGORIES]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in complete
                if e.get("cat") in HOST_CUDA_CATEGORIES and "correlation" in e.get("args", {})}
    spins = [float(e["ts"]) + float(e["dur"]) for e in device if WARMUP_KERNEL in e["name"]]
    rest = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device
            if WARMUP_KERNEL not in e["name"]]
    if not spans or not rest:
        return None
    lo = max(spins) if spins else min(s for s, _ in rest)
    hi = max(e for _, e in rest)
    shift = clock_shift(device, launches) or (lambda t: 0.0)
    moved = (shift(lo), shift(hi))
    rest = [(s + shift(s), e + shift(e)) for s, e in rest]
    lo, hi = lo + moved[0], hi + moved[1]
    idle: dict = collections.defaultdict(float)
    parts = self_parts(spans)
    i = 0
    for g0, g1 in _idle_gaps(rest, lo, hi):
        t = g0
        while i < len(parts) and parts[i][1] <= g0:
            i += 1
        j = i
        while t < g1:
            if j < len(parts) and parts[j][0] <= t < parts[j][1]:
                end = min(parts[j][1], g1)
                idle[spans[parts[j][2]].name] += end - t
                t = end
                j += 1
            else:
                end = min(parts[j][0], g1) if j < len(parts) else g1
                idle[NO_SPAN] += end - t
                t = end
    return dict(idle), moved


def _summarize_kineto(events: list[dict]) -> dict:
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    gpu = [e for e in complete if e.get("cat") in GPU_CATEGORIES]
    if gpu:
        # Kineto labels a device's timeline ("GPU 0") apart from its name
        names = {**_process_names(events), **_process_names(events, "process_labels")}
        pids = sorted({e["pid"] for e in gpu}, key=str)
        dev = ", ".join(names.get(p) or f"GPU {p}" for p in pids)
        cats, ops, counts = _aggregate(
            gpu, lambda e: kernel_base_name(e["name"]) if e["cat"] == "kernel" else e["cat"])
    else:
        host = [e for e in complete if e.get("cat") == "cpu_op"]
        dev = "CPU operators (the trace has no GPU events)"
        cats, ops, counts = _aggregate(host, lambda e: e["name"])
    out = {"categories": cats, "ops": ops, "counts": counts,
           "total_us": float(sum(ops.values())), "device": dev}
    idle = idle_by_span(events)
    if idle is not None:
        out["idle_by_span"], out["device_shift_us"] = idle
    return out


def _summarize_by_process(events: list[dict], device_substr: str) -> dict:
    """The JAX package's summary: complete events on the processes whose
    name holds `device_substr` or "/device:"."""
    names = _process_names(events)
    device_pids = {
        pid for pid, n in names.items()
        if device_substr.lower() in n.lower() or "/device:" in n
    }
    # fall back to any non-CPU pid when the device name doesn't match
    if not device_pids:
        device_pids = {
            pid for pid, n in names.items() if "cpu" not in n.lower()
        }
    picked = [
        e for e in events
        if e.get("ph") == "X" and "dur" in e and e.get("pid") in device_pids
        # skip enclosing step/module markers (they double-count their ops)
        and not (e["name"].startswith("jit_") or e["name"].isdigit())
    ]
    cats, ops, counts = _aggregate(picked, lambda e: re.sub(r"[.\d]+$", "", e["name"]) or e["name"])
    dev = ", ".join(sorted(names[p] for p in device_pids)) or "?"
    return {"categories": cats, "ops": ops, "counts": counts,
            "total_us": float(sum(ops.values())), "device": dev}


def summarize(events: list[dict], device_substr: str = "GPU") -> dict:
    """Aggregate the device timeline's complete ('X') events.

    Returns {"categories": {base_name: us}, "ops": {name: us},
             "counts": {name: n}, "total_us": float, "device": str}.
    A Kineto trace (its events carry a `cat`) is summarised over its GPU
    events; any other over the processes named like a device."""
    if any("cat" in e for e in events if e.get("ph") == "X"):
        return _summarize_kineto(events)
    return _summarize_by_process(events, device_substr)


def format_summary(s: dict, top: int = 15) -> str:
    total = max(s["total_us"], 1e-9)
    lines = [f"device timeline: {s['device']}  total {total / 1e3:.2f} ms"]
    lines.append("-- categories --")
    for n, d in sorted(s["categories"].items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"{d / 1e3:10.2f} ms  {100 * d / total:5.1f}%  {n or '(unnamed)'}")
    lines.append(f"-- top {top} ops --")
    for n, d in sorted(s["ops"].items(), key=lambda kv: -kv[1])[:top]:
        lines.append(
            f"{d / 1e3:10.2f} ms  x{s['counts'][n]:<5d} {n[:90]}"
        )
    if "idle_by_span" in s:
        lines.append("-- device idle by innermost span (device times shifted by "
                     "{:.1f} us at the start, {:.1f} at the end) --".format(*s["device_shift_us"]))
        for n, d in sorted(s["idle_by_span"].items(), key=lambda kv: -kv[1]):
            lines.append(f"{d / 1e3:10.2f} ms  {n}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("Usage: python -m fewshot_detection_tpu_torch.utils.trace_summary "
              "<trace_dir> [--top N]")
        return 1
    top = 15
    if "--top" in argv:
        i = argv.index("--top")
        top = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    files = find_trace_files(argv[0])
    if not files:
        print(f"no trace files under {argv[0]}")
        return 1
    for f in files:
        print(f"== {f}")
        print(format_summary(summarize(load_events(f)), top=top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
