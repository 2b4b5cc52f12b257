"""Data parallelism over `torch.distributed`: one process a device.

Counterpart of the JAX package's `parallel/mesh.py`. There, a 1-D `data`
mesh shards the train step's leading replica-group axis R one group per
device, parameters are replicated, and XLA inserts the gradient all-reduce.
Here each rank is one process on one device (launched by `torchrun
--nproc_per_node=N`) and runs its contiguous share of the R groups, and the
trainer (train/trainer.py) sums what the groups give with explicit
collectives. The semantics are the JAX package's, which are not DDP's: the
groups' losses are SUMMED (gradients all-reduced with SUM), each group keeps
its own batch statistics (no sync-BN), and the BN running-statistics updates
are AVERAGED over the groups.

A `Mesh` issues every collective of a step through `all_reduce_sum`,
`broadcast`, `broadcast_object`, `gather_object` or `barrier` and counts
them (`collectives`). A tree goes as one flat buffer a dtype, so a step costs
a few collectives, not one a leaf.

The backend is NCCL for a CUDA device and gloo for the CPU; another is used
only when the caller names it. gloo is also what runs several ranks on ONE
card (NCCL refuses two ranks on one device); its collectives on CUDA tensors
are staged through host copies, a branch for gloo alone."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..train.optim import tree_leaves_with_path, tree_map

DATA_AXIS = "data"
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass
class Mesh:
    """This process's place in the data-parallel world: `size` ranks, this
    one `rank`, computing on `device`, talking over `backend`."""

    size: int
    rank: int
    device: torch.device
    backend: str
    collectives: int = 0

    @property
    def is_chief(self) -> bool:
        """Rank 0: the one rank that logs and writes files."""
        return self.rank == 0

    def _staged(self, t: torch.Tensor) -> bool:
        # gloo only: its collectives take host tensors here
        return self.backend == "gloo" and t.device.type == "cuda"

    def _each_dtype(self, tree, collective) -> None:
        """Run `collective(flat)` on one flat buffer per dtype of the tree's
        tensor leaves, in place, and write the result back into the leaves."""
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for _, t in tree_leaves_with_path(tree):
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for leaves in by_dtype.values():
                flat = torch.cat([t.detach().reshape(-1) for t in leaves])
                staged = self._staged(flat)
                buf = flat.cpu() if staged else flat
                collective(buf)
                self.collectives += 1
                if staged:
                    flat.copy_(buf)
                offset = 0
                for t in leaves:
                    n = t.numel()
                    t.copy_(flat[offset:offset + n].view_as(t))
                    offset += n

    def all_reduce_sum(self, tree):
        """Every tensor leaf replaced, in place, by its sum over the ranks;
        returns the tree. Every rank ends with the same bits."""
        self._each_dtype(tree, lambda buf: dist.all_reduce(buf, op=dist.ReduceOp.SUM))
        return tree

    def broadcast(self, tree, src: int = 0):
        """Every tensor leaf replaced, in place, by rank `src`'s; returns the
        tree."""
        self._each_dtype(tree, lambda buf: dist.broadcast(buf, src=src))
        return tree

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable `obj`, on every rank."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src)
        self.collectives += 1
        return box[0]

    def gather_object(self, obj, dst: int = 0):
        """On rank `dst` the list of every rank's `obj` in rank order; None
        on the others."""
        out = [None] * self.size if self.rank == dst else None
        dist.gather_object(obj, out, dst=dst)
        self.collectives += 1
        return out

    def barrier(self) -> None:
        dist.barrier()
        self.collectives += 1


def launched_by_torchrun() -> bool:
    """Whether this process was started as one rank of a world (torchrun's
    environment) or already joined one."""
    return dist.is_available() and (
        dist.is_initialized() or all(k in os.environ for k in _TORCHRUN_ENV))


def world_size() -> int:
    """The size of the world this process is in or will join: 1 for a
    process started alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if all(k in os.environ for k in _TORCHRUN_ENV):
        return int(os.environ["WORLD_SIZE"])
    return 1


def make_mesh(n_devices: int | None = None, *, device="cuda", backend: str | None = None) -> Mesh:
    """Join the default process group, or initialise it from the torchrun
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks
    the card). A process started alone makes a world of one. `device="cuda"`
    resolves to `cuda:LOCAL_RANK` and becomes the current device; an indexed
    device is taken as named. The backend is NCCL for CUDA and gloo for the
    CPU unless `backend` names another. Raises when `n_devices` is not the
    world's size, when the group already runs another backend than the one
    named, and when NCCL cannot start (no fallback)."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this PyTorch build")
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        want = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if all(k in os.environ for k in _TORCHRUN_ENV):
            dist.init_process_group(want, init_method="env://")
        elif n_devices in (None, 1):
            dist.init_process_group(want, store=dist.HashStore(), rank=0, world_size=1)
        else:
            raise ValueError(
                f"a mesh of {n_devices} devices needs {n_devices} processes: launch with "
                f"torchrun --nproc_per_node={n_devices} (this process was started alone)")
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a world of {size} ranks")
    return Mesh(size, dist.get_rank(), dev, dist.get_backend())


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous share of a leading axis of length `n`."""
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated_sharding(mesh: Mesh) -> int:
    """The rank whose tree every rank takes when a tree is replicated."""
    return 0


def shard_batch(mesh: Mesh, tree):
    """This rank's slice of the leading (replica-group) axis of every leaf
    (numpy arrays or tensors, left where they are)."""
    def take(x):
        return x[batch_sharding(mesh, x.shape[0])]

    return tree_map(take, tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's tensors in every rank's tree, in place (parameters and
    momentum before the first step); returns the tree."""
    return mesh.broadcast(tree, src=replicated_sharding(mesh))


def pad_to_ranks(mesh: Mesh, images):
    """(this rank's block of a batch padded to a multiple of the ranks by
    repeating its last image, the batch's length). The blocks are contiguous
    and in rank order, so the ranks' outputs put together are the padded
    batch's, image-major."""
    x = np.asarray(images)
    b = x.shape[0]
    pad = (-b) % mesh.size
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
    return x[batch_sharding(mesh, x.shape[0])], b
