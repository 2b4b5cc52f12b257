"""Full training-state checkpoints beside the darknet `.weights` codec.

The reference's only persistence was the `.weights` format, whose header
`seen` counter restored the LR-schedule position and epoch
(darknet_meta.py:104-105, train_meta.py:94-99). That codec is kept for
interop (models/weights_io.py); this module adds full training-state
checkpoints — parameters, SGD momentum and the `seen` / `processed_batches`
/ `step` counters — written with `torch.save` (the JAX package writes the
same state with Orbax).

Layout: `<directory>/ckpt_<step:08d>/state.pt`. The file is written under a
temporary name and renamed when complete, so `latest_checkpoint` never
returns a partial write.

`FSD_ASYNC_CKPT=1` writes on a background thread. The trainer updates its
parameters in place, so `save_train_state` first stages a CPU copy of every
tensor and returns only then; the next step cannot change what is being
written. One save is in flight at a time: a new save waits for the one
before it, and `wait_for_saves()` waits for the last (and raises what a
background write raised).

In a data-parallel world (parallel/mesh.py) every rank holds the same state:
rank 0 alone writes, and every rank passes a barrier after the save, so
none runs ahead of a save that is not yet staged (or, synchronously,
written). Every rank restores, so a resumed world continues bit-equal to
its saved state."""

from __future__ import annotations

import os
import re
import threading
from typing import Any

import torch

from .optim import tree_map

STATE_FILE = "state.pt"
_CKPT_NAME = re.compile(r"ckpt_\d{8}")


class _Writer:
    """At most one background write at a time; its error is kept until
    someone waits."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def _run(self, state: dict, path: str) -> None:
        try:
            _write(state, path)
        except Exception as e:  # handed to the caller of wait()
            self._error = e

    def submit(self, state: dict, path: str) -> None:
        self.wait()
        self._thread = threading.Thread(target=self._run, args=(state, path),
                                        name="fsd-checkpoint", daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err


_writer = _Writer()


def _write(state: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = f"{final}.partial-{os.getpid()}-{threading.get_ident()}"
    torch.save(state, tmp)
    os.replace(tmp, final)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor that shares no storage with `t` (for a CUDA tensor the
    copy waits for the work queued before it, so it is the value after the
    last step)."""
    return t.detach().to("cpu", copy=True)


def wait_for_saves() -> None:
    """Block until the in-flight background save (if any) is written; raise
    what it raised. Call before exit and before reading a just-written
    checkpoint."""
    _writer.wait()


def save_train_state(
    directory: str,
    step: int,
    params: Any,
    momentum: Any,
    seen: int,
    processed_batches: int,
    mesh=None,
) -> str:
    """Write one checkpoint under <directory>/ckpt_<step:08d> and return that
    path. The values are copied to the host before this returns, also when
    the write itself runs in the background (FSD_ASYNC_CKPT=1). With a
    `mesh`, rank 0 writes and every rank waits at a barrier after."""
    path = os.path.abspath(os.path.join(directory, f"ckpt_{step:08d}"))
    if mesh is not None and not mesh.is_chief:
        mesh.barrier()
        return path
    state = {
        "params": tree_map(_host_copy, params),
        "momentum": tree_map(_host_copy, momentum),
        "counters": {
            "seen": int(seen),
            "processed_batches": int(processed_batches),
            "step": int(step),
        },
    }
    if os.environ.get("FSD_ASYNC_CKPT", "0") == "1":
        _writer.submit(state, path)
    else:
        _writer.wait()  # keep the order of the writes
        _write(state, path)
    if mesh is not None:
        mesh.barrier()
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The newest complete checkpoint under `directory`, or None. A
    `ckpt_*` directory without a finished state file (empty, or holding
    only a partial write) is skipped."""
    if not os.path.isdir(directory):
        return None
    done = sorted(
        d for d in os.listdir(directory)
        if _CKPT_NAME.fullmatch(d)
        and os.path.isfile(os.path.join(directory, d, STATE_FILE))
    )
    return os.path.join(directory, done[-1]) if done else None


def restore_train_state(path: str, template: Any | None = None) -> dict:
    """Restore {params, momentum, counters} from a checkpoint directory.
    Without `template` the tensors come back on the CPU. With a template (a
    dict with "params" and "momentum" trees of tensors of the same shape),
    each tensor is moved to its template leaf's device and dtype and
    requires gradients where that leaf does."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if template is not None:
        def place(t, like):
            if t.shape != like.shape:
                raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)}, "
                                 f"expected {tuple(like.shape)}")
            return t.to(like.device, like.dtype).requires_grad_(like.requires_grad)

        for key in ("params", "momentum"):
            state[key] = tree_map(place, state[key], template[key])
    state["counters"] = {k: int(v) for k, v in state["counters"].items()}
    return state
