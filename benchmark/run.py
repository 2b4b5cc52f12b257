#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is comes from data, found by name: its entry in
`BENCHMARK.json` names a configuration (`configs[].file`, the cfg copies
and settings under `benchmark/configs/`) and a traffic mix
(`benchmark/traffic/<mix>.json`, whose `driver` names the general
generator in `benchmark/drivers/`); its limits are
`benchmark/limits/<cell>.json`; each per-layer metric is read by
`benchmark/metrics/<metric>.py`. A later cell, mix or metric is new files.

The driver builds the program's objects from the seed, warms every shape
the cell uses, times the window of `--seconds` with tracing off, and with
`--trace 1` then times the same window and profiles a short stretch for
the per-layer metrics. It then frees the program's state and the plain
reference decides `correct`. Standard output ends with one JSON line;
standard error ends with each compared number beside its limit.

Exits 2 without a CUDA device or with fewer than the cell asks for, and
3 when `jax`, `jaxlib`, `flax` or the JAX package is loaded once the run
is over; neither prints a result.
"""

import time

T0 = time.perf_counter()  # the process's start, as near as Python reaches

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "fewshot_detection_tpu")
CACHE = ".bench_cache"  # inside the checkout, at a fixed path


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout; no library loads JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(root, CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Context:
    """What a driver is handed: the cell's data, the seed, the window, the
    device, and the clock's start."""

    def __init__(self, root, cell, config, traffic, seed, seconds, trace, device, t0):
        import torch

        self.root, self.cell, self.config, self.traffic = root, cell, config, traffic
        self.seed, self.seconds, self.trace, self.t0 = seed, seconds, trace, t0
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def log(self, what: str) -> None:
        """A progress line on standard error, with the seconds since start."""
        print(f"[{time.perf_counter() - self.t0:8.2f} s] {what}", file=sys.stderr, flush=True)

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


def load_cell(root: str, name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def reader(root: str, metric: str):
    """The `read(record)` of benchmark/metrics/<metric>.py."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def card_line(cuda: bool) -> str:
    if not cuda:
        return "card: none (cpu)"
    try:
        return "card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"card: nvidia-smi gave nothing ({e})"


def finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def main(argv=None, device=None, root=None) -> int:
    """Run the cell; `device` other than None skips the look for a chip
    (tests only), `root` is the checkout whose data is read."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = root or ROOT
    set_cache_dirs(root)
    bench, cell, config, traffic = load_cell(root, args.workload)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"the cell needs {cell['chips']} CUDA device(s); this machine has {n}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.common import compare
    from benchmark.common.peaks import peaks_of

    ctx = Context(root, cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                  device, T0)
    print(card_line(ctx.cuda), flush=True)
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    out = driver.run(ctx)
    print(f"peak device memory: {out['memory']} bytes", flush=True)

    e2e, layer = cell_metrics(bench, cell["name"])
    rec = out["record"]
    metrics = {}
    if args.trace:
        rec["peaks"] = peaks_of(torch.cuda.get_device_name(ctx.device)) if ctx.cuda else None
        for m in layer:
            value = reader(root, m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}

    correct, checks = compare.judge(out["readings"], compare.load_limits(root, cell["name"]))
    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))
    if loaded:
        print(f"modules that must not load were loaded: {loaded}", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(ctx.device) if ctx.cuda else "cpu"
    dev = {"platform": "gpu" if ctx.cuda else "cpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": out["memory"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    trace = rec.get("trace")
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    print("readings " + json.dumps({k: finite(v) for k, v in out["readings"].items()}),
          file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, heads the import path
    sys.path[0] = ROOT
    sys.exit(main())
