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
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys

GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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
    return {"categories": cats, "ops": ops, "counts": counts,
            "total_us": float(sum(ops.values())), "device": dev}


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
