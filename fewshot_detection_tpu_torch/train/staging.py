"""The train step's host-to-device copy, staged through a ring of pinned slots.

A `.to(device, non_blocking=True)` of a pageable host array holds its calling
thread while the CUDA driver stages the bytes through a bounce buffer of its
own, one CPU thread's `memcpy` at a time: on an H100's host the train step's
batch crossed at 5-7 GB/s, a seventh of what the host link carries from pinned
memory. Here the batch's arrays are laid end to end as bytes and cut into
chunks of one slot. For each chunk the host waits on the slot's event from its
previous DMA (only when it laps the ring), fills the slot from the pageable
source with a `copy_` that PyTorch splits over its intra-op threads, issues
the DMA into the destination on the current stream and records the slot's
event. While the DMA of one chunk runs, the host fills the next.

Destinations are allocated as `.to()` allocates them (same shape, dtype and
device) and hold the same bytes. Only contiguous, pageable CPU sources bound for
a CUDA device take the ring, and only in a batch that sends at least
MIN_STAGED_BYTES through it; device tensors, pinned tensors, non-contiguous
arrays, smaller batches and every copy to the CPU keep `.to()`.
"""

from __future__ import annotations

import os
import threading

import torch

# 4 x 16 MB of pinned memory a process and device, whatever the batch. On the
# H100's hosts (8 cores) a slot of 4-16 MB filled alone at 22-53 GB/s on 8
# threads, 32-64 MB ones at 21-37; inside the training loop, where each
# chunk's fill is one parallel region that waits for its slowest thread on a
# shared host, 16-32 MB slots gave the shortest copies and 8 MB ones the
# longest tails (PERF.md §3). A 16 MB DMA takes about 0.3 ms at the link's
# 54 GB/s, less than its fill, so the host never waited on a slot in any
# cell, and the last chunk's DMA, the part of the copy nothing overlaps,
# stays under a millisecond.
SLOT_BYTES = 16 << 20
SLOTS = 4
# The least a batch sends through the ring. The staged copy is mostly the
# faster from 66 MB up, but each chunk's fill wakes every intra-op thread and
# they spin after it, and in the host-bound cells the rest of the step then
# took 3-7 ms longer: at 66-142 MB (the b64 cells, YOLOv3 at 608 px) the
# cells' images/s did not rise (YOLOv3's copy fell from 24-27 ms of the card
# to 4, yet its images/s were higher in 2 of 7 pairs), while at b384's 425 MB
# the copy saves 30-60 ms and images/s rose in 22 of 23 pairs (PERF.md §6).
MIN_STAGED_BYTES = 256 << 20

COUNTS = ("staged_bytes", "chunks", "slot_waits")


def cgroup_cpus() -> float | None:
    """The CPUs the process's cgroup (v2) quota allows, `cpu.max`'s quota
    over its period; None where there is no quota or it cannot be read."""
    try:
        with open("/proc/self/cgroup") as f:
            path = next(line.split("::", 1)[1].strip() for line in f
                        if line.startswith("0::"))
        with open(f"/sys/fs/cgroup{path}/cpu.max") as f:
            quota, period = f.read().split()
    except (OSError, StopIteration, ValueError):
        return None
    return None if quota == "max" else int(quota) / int(period)


def fill_threads() -> int:
    """Threads that fill a slot: PyTorch's intra-op thread count, capped by
    the CPUs the process may run on and by its cgroup's quota. More threads
    than that share cores and copy slower than fewer."""
    n = min(torch.get_num_threads(), len(os.sched_getaffinity(0)))
    quota = cgroup_cpus()
    if quota is not None:
        n = min(n, int(quota))
    return max(1, n)


def _dma(dst: torch.Tensor, src: torch.Tensor) -> None:
    dst.copy_(src, non_blocking=True)


class Ring:
    """`slots` host buffers of `slot_bytes` (pinned where `pin`), each with
    the event of its last DMA. A slot is filled by PyTorch's own `copy_`,
    which splits a copy over its intra-op threads, at most `threads` of
    them (default `fill_threads()`). `dma(dst, src)` issues a copy from a
    slot's bytes and `new_event()` gives an object with `record()`,
    `query()` and `synchronize()`: the CUDA ones by default; tests swap them
    to run the chunking on the CPU. One copy at a time (a lock)."""

    def __init__(self, slot_bytes: int = SLOT_BYTES, slots: int = SLOTS,
                 threads: int | None = None, *, pin: bool = True,
                 dma=_dma, new_event=torch.cuda.Event):
        self.slot_bytes = slot_bytes
        buf = torch.empty(slot_bytes * slots, dtype=torch.uint8, pin_memory=pin)
        self.slots = list(buf.split(slot_bytes))
        self.events = [None] * slots
        self.threads = threads or fill_threads()
        self.dma, self.new_event = dma, new_event
        self._next = 0
        self._lock = threading.Lock()

    def copy(self, sources: list[torch.Tensor], dests: list[torch.Tensor]) -> tuple[int, int]:
        """Each flat uint8 host tensor's bytes into its flat uint8 tensor of
        the same length, the sources end to end in chunks of one slot.
        Returns (chunks, slot_waits): a slot wait is a refill that found the
        slot's previous DMA unfinished."""
        chunks = waits = 0
        with self._lock:
            before = torch.get_num_threads()
            if before > self.threads:
                torch.set_num_threads(self.threads)
            try:
                for pieces in _chunks(sources, dests, self.slot_bytes):
                    i = self._next
                    self._next = (i + 1) % len(self.slots)
                    slot, ev = self.slots[i], self.events[i]
                    if ev is not None and not ev.query():
                        waits += 1
                        ev.synchronize()
                    for src, _, at in pieces:
                        slot[at:at + src.numel()].copy_(src)
                    for src, dst, at in pieces:
                        self.dma(dst, slot[at:at + src.numel()])
                    if ev is None:
                        ev = self.events[i] = self.new_event()
                    ev.record()
                    chunks += 1
            finally:
                if torch.get_num_threads() != before:
                    torch.set_num_threads(before)
        return chunks, waits


def _chunks(sources, dests, slot_bytes: int):
    """The sources laid end to end, cut into chunks of `slot_bytes`: yields
    each chunk's pieces, a piece (source bytes, destination bytes, offset in
    the slot)."""
    pieces, used = [], 0
    for src, dst in zip(sources, dests):
        off = 0
        while off < src.numel():
            n = min(src.numel() - off, slot_bytes - used)
            pieces.append((src[off:off + n], dst[off:off + n], used))
            used += n
            off += n
            if used == slot_bytes:
                yield pieces
                pieces, used = [], 0
    if pieces:
        yield pieces


def engages(t: torch.Tensor) -> bool:
    """Whether a source takes the ring: a contiguous, pageable CPU tensor
    with bytes to copy."""
    return (t.device.type == "cpu" and t.is_contiguous() and t.numel() > 0
            and not t.is_pinned())


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


def stage(tensors: list[torch.Tensor], device: torch.device, ring: Ring):
    """`[t.to(device, non_blocking=True) for t in tensors]`, with the
    sources that `engages` takes copied through `ring`; also the counts
    (COUNTS)."""
    ring_takes = [engages(t) for t in tensors]
    out = [torch.empty(t.shape, dtype=t.dtype, device=device) if takes
           else t.to(device, non_blocking=True) for t, takes in zip(tensors, ring_takes)]
    pairs = [(t, o) for t, o, takes in zip(tensors, out, ring_takes) if takes]
    chunks, waits = ring.copy([_bytes(t) for t, _ in pairs], [_bytes(o) for _, o in pairs])
    return out, {"staged_bytes": sum(t.nbytes for t, _ in pairs), "chunks": chunks,
                 "slot_waits": waits}


_RINGS: dict[torch.device, Ring] = {}
_RINGS_LOCK = threading.Lock()


def ring_for(device: torch.device) -> Ring:
    """The process's ring for a CUDA device, made at its first use."""
    key = torch.device("cuda", torch.cuda.current_device() if device.index is None
                       else device.index)
    with _RINGS_LOCK:
        if key not in _RINGS:
            _RINGS[key] = Ring()
        return _RINGS[key]


def takes_ring(tensors: list[torch.Tensor], device: torch.device) -> bool:
    """Whether a batch goes through the ring: bound for a CUDA device, with
    at least MIN_STAGED_BYTES in the sources that `engages` takes."""
    return device.type == "cuda" and sum(
        t.nbytes for t in tensors if engages(t)) >= MIN_STAGED_BYTES


def to_device(arrays, device: torch.device):
    """Each array (numpy or tensor) as a tensor on `device`, as
    `torch.as_tensor(a).to(device, non_blocking=True)` gives it, and the
    counts (COUNTS, all 0 where nothing took the ring). Where `takes_ring`,
    the sources that `engages` takes go through the device's ring, their
    DMAs on its current stream."""
    tensors = [torch.as_tensor(a) for a in arrays]
    if not takes_ring(tensors, device):
        return [t.to(device, non_blocking=True) for t in tensors], dict.fromkeys(COUNTS, 0)
    with torch.cuda.device(device):
        return stage(tensors, device, ring_for(device))
