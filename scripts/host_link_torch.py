"""The host link's rates on a CUDA card's host, for the train step's input copy.

    python3 scripts/host_link_torch.py [--out FILE] [--reps N]

Prints one JSON line a reading (and writes them to --out):
  host      os.cpu_count(), the affinity, the cgroup's `cpu.max`, PyTorch's
            intra-op threads and `train/staging.py:fill_threads()`
  pageable  `.to(device, non_blocking=True)` of each benchmark cell's batch
            from pageable memory, host clock to a synchronise
  pinned    the same bytes from pinned memory, whole and in 16 MB chunks
            (CUDA events): the layer's bound
  fill      the host's fill of pinned slots from a pageable source (no DMA),
            by thread count and slot size, as `staging.Ring` fills them
  staged    `staging.stage` of each cell's batch through a ring of 4 slots,
            by thread count and slot size, held bit-equal to `.to()`
  to_device `staging.to_device` of each cell's batch as the trainer calls it
            (the process's ring of `SLOTS` x `SLOT_BYTES` from
            `MIN_STAGED_BYTES`, `.to()` under it)
Rates are GB/s (1e9 bytes), the median of --reps runs. A CUDA card is needed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fewshot_detection_tpu_torch.train import staging  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _meta(b):
    return [((1, b, 416, 416, 3), BF16), ((1, 15, 416, 416, 3), BF16),
            ((1, 15, 416, 416, 1), BF16), ((1, b, 15, 50, 5), F32), ((1, b * 15), F32)]


def _plain(b, size):
    return [((1, b, size, size, 3), BF16), ((1, b, 50, 5), F32), ((1, b), F32)]


# each benchmark cell's batch: (shape, dtype) of its arrays, in the trainer's
# key order (`MetaTrainer._KEYS`, `PlainTrainer._KEYS`)
CELL_BATCHES = {
    "meta_voc15.train_b64": _meta(64),
    "yolov2_voc.train_b64": _plain(64, 416),
    "meta_voc15.train_b384": _meta(384),
    "yolov3_coco.train_b64_608": _plain(64, 608),
}
THREADS = (1, 2, 3, 4, 6, 8, 12, 16)
SLOT_MB = (4, 8, 16, 32, 64)


def batch_of(cell: str, seed: int = 0) -> list[torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(shape, generator=gen).to(dtype) for shape, dtype in CELL_BATCHES[cell]]


def gbs(nbytes: int, seconds: list[float]) -> float:
    return nbytes / statistics.median(seconds) / 1e9


def host_reading() -> dict:
    try:
        with open("/proc/self/cgroup") as f:
            cgroup = f.read().strip()
        path = cgroup.split("::", 1)[1] if "::" in cgroup else ""
        with open(f"/sys/fs/cgroup{path}/cpu.max") as f:
            cpu_max = f.read().strip()
    except OSError as e:
        cgroup, cpu_max = None, f"unreadable: {e}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "cgroup": cgroup, "cpu.max": cpu_max, "cgroup_cpus": staging.cgroup_cpus(),
            "torch_threads": torch.get_num_threads(), "fill_threads": staging.fill_threads(),
            "card": smi.stdout.strip(), "torch": torch.__version__, "cuda": torch.version.cuda}


def pageable_reading(cell: str, dev, reps: int) -> dict:
    batch = batch_of(cell)
    nbytes = sum(t.nbytes for t in batch)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [t.to(dev, non_blocking=True) for t in batch]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    return {"cell": cell, "bytes": nbytes, "gbs": gbs(nbytes, times[1:]),
            "ms": 1e3 * statistics.median(times[1:])}


def pinned_reading(nbytes: int, dev, reps: int) -> dict:
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = {"bytes": nbytes}
    for name, chunk in (("whole", nbytes), ("chunks_16mb", 16 << 20)):
        times = []
        for _ in range(reps + 1):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for off in range(0, nbytes, chunk):
                dst[off:off + chunk].copy_(src[off:off + chunk], non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        out[name + "_gbs"] = gbs(nbytes, times[1:])
    return out


class _Done:
    def record(self):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass


def fill_readings(src: torch.Tensor, reps: int) -> list[dict]:
    """Slots filled round a ring from `src` as `staging.Ring` fills them
    (PyTorch's `copy_` on at most `threads` intra-op threads), no DMA."""
    out = []
    for slot_mb in SLOT_MB:
        for threads in [t for t in THREADS if t <= torch.get_num_threads()]:
            ring = staging.Ring(slot_mb << 20, staging.SLOTS, threads,
                                dma=lambda dst, s: None, new_event=_Done)
            sink = torch.empty(len(src), dtype=torch.uint8)  # never written: dma is a no-op
            times = []
            for _ in range(reps + 1):
                t0 = time.perf_counter()
                ring.copy([src], [sink])
                times.append(time.perf_counter() - t0)
            out.append({"slot_mb": slot_mb, "threads": threads, "gbs": gbs(len(src), times[1:])})
    return out


def staged_readings(dev, reps: int) -> list[dict]:
    out = []
    default = staging.fill_threads()
    for cell in CELL_BATCHES:
        batch = batch_of(cell, seed=1)
        want = [t.to(dev) for t in batch]
        nbytes = sum(t.nbytes for t in batch)
        for slot_mb in (8, 16, 32):
            for threads in sorted({1, 2, 4, 6, default}):
                ring = staging.Ring(slot_mb << 20, staging.SLOTS, threads)
                times, counts = [], None
                for _ in range(reps + 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got, counts = staging.stage(batch, dev, ring)
                    host = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0, host))
                equal = all(torch.equal(a, b) for a, b in zip(got, want))
                out.append({"cell": cell, "bytes": nbytes, "slot_mb": slot_mb,
                            "threads": threads, "gbs": gbs(nbytes, [t for t, _ in times[1:]]),
                            "host_ms": 1e3 * statistics.median(h for _, h in times[1:]),
                            "equal": equal, **counts})
                del got
    return out


def to_device_readings(dev, reps: int) -> list[dict]:
    out = []
    for cell in CELL_BATCHES:
        batch = batch_of(cell, seed=2)
        want = [t.to(dev) for t in batch]
        nbytes = sum(t.nbytes for t in batch)
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, counts = staging.to_device(batch, dev)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0, host))
        out.append({"cell": cell, "bytes": nbytes, "slot_mb": staging.SLOT_BYTES >> 20,
                    "slots": staging.SLOTS, "threads": staging.fill_threads(),
                    "gbs": gbs(nbytes, [t for t, _ in times[1:]]),
                    "host_ms": 1e3 * statistics.median(h for _, h in times[1:]),
                    "equal": all(torch.equal(a, b) for a, b in zip(got, want)), **counts})
        del got
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_link_torch.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)
    lines = [{"reading": "host", **host_reading()}]
    print(json.dumps(lines[-1]), flush=True)

    def emit(kind, rec):
        lines.append({"reading": kind, **rec})
        print(json.dumps(lines[-1]), flush=True)

    for cell in CELL_BATCHES:
        emit("pageable", pageable_reading(cell, dev, args.reps))
    emit("pinned", pinned_reading(sum(t.nbytes for t in batch_of("meta_voc15.train_b384")),
                                  dev, args.reps))
    src = batch_of("meta_voc15.train_b384")[0].reshape(-1).view(torch.uint8)
    for rec in fill_readings(src, args.reps):
        emit("fill", rec)
    for rec in staged_readings(dev, args.reps):
        emit("staged", rec)
    for rec in to_device_readings(dev, args.reps):
        emit("to_device", rec)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
