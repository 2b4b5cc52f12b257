"""Batched greedy NMS on the device: a CUDA kernel and its plain version.

`nms_rows` replaces the TPU kernel `ops/nms_device.py:_nms_kernel` of the JAX
package (reached through `nms_pallas` under a per-row `vmap`) for ALL
(image, class) rows of a batch at once. The kernel source is
`csrc/nms.cu`; `ops/_build.py` compiles it with `nvcc` for sm_90a at first
use into `_build/` inside the package and loads it with `ctypes`.

Bound on an H100: the function reads R*K*20 bytes and writes R*K (a few
hundred nanoseconds at the card's memory rate), and the pairwise IoUs are
less float32 arithmetic than that; the time actually follows the chain of
greedy NMS, in which a candidate is settled only after every candidate
ranked before it, and a row lives in one block on one SM. A kernel that
takes one block-wide barrier per candidate, with the IoU's division inside
each step, waits most of its time. The design spends one thread block per
row, keeps the per-box terms of the IoU in shared memory (IoUs on the fly,
never an (R, K, K) matrix in device memory), and works in groups of 32
candidates: before the chain starts, all threads compute every group's own
triangle of overlaps as 32-bit words; then, per group, one warp settles the
group's members in registers with ballots, and all threads drop the later
candidates that a KEPT member overlaps. Two barriers per 32 candidates, no
arithmetic in the settling warp's way, no division for a pair whose boxes do
not meet, and the loop ends at the last live candidate.

A row longer than `MAX_K` candidates does not fit one block's shared
memory. For such a row the wrapper hands the kernel a global workspace (40
bytes a candidate, reused per device and stream as `bn_sums` reuses its
own), and the same kernel keeps the row's arrays there: same steps, same
arithmetic, the same keep mask. The wrapper picks the path from K alone;
`nms_rows.long_launches` counts the launches that took the workspace.

`nms_rows_reference` is the plain PyTorch version of the same function (the
loop of the JAX package's `nms_jax`, over all rows at once). It serves CPU
tensors and is what the kernel is compared against; on a CUDA tensor
`nms_rows` launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import launch_on, load_library
from .boxes import iou_xywh_t

# K*(32+4+4) bytes of shared memory per row (edges, sizes, confidence, word)
# must fit one block's 227 KB; 845 is every anchor of a 13x13 grid. A longer
# row keeps those bytes in a workspace in device memory instead
MAX_K = 5600
ROW_BYTES = 40  # per candidate, csrc/nms.cu:row_smem

_fn = None
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def _kernel():
    """`fsd_nms_rows` of csrc/nms.cu, built and loaded on first use."""
    global _fn
    if _fn is None:
        fn = load_library("nms").fsd_nms_rows
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(boxes: torch.Tensor, dsel: torch.Tensor) -> torch.Size:
    if boxes.dtype != torch.float32 or dsel.dtype != torch.float32:
        raise TypeError(f"nms_rows takes float32, got {boxes.dtype} and {dsel.dtype}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or dsel.shape != boxes.shape[:2]:
        raise ValueError(
            f"nms_rows takes boxes (R, K, 4) and dsel (R, K), got "
            f"{tuple(boxes.shape)} and {tuple(dsel.shape)}"
        )
    if boxes.device != dsel.device:
        raise ValueError(f"boxes on {boxes.device} but dsel on {dsel.device}")
    if not (boxes.is_contiguous() and dsel.is_contiguous()):
        raise ValueError("nms_rows takes contiguous tensors")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_rows: boxes must be 16-byte aligned (float4 loads)")
    return dsel.shape


def nms_rows(boxes: torch.Tensor, dsel: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS of every row at once.

    boxes (R, K, 4) float32 cxcywh, already confidence-descending within a
    row; dsel (R, K) float32 confidences, 0 for masked-out slots. Returns
    keep (R, K) bool: ``keep[r, j]`` = candidate j survives the greedy pass
    of row r and ``dsel[r, j] > 0``.

    A CUDA tensor goes to the kernel (built at first use; any failure to
    build, load or launch raises); a CPU tensor goes to the plain version.
    A row of more than `MAX_K` candidates takes the workspace path.
    `nms_rows.launches` counts kernel launches."""
    if boxes.device.type == "cpu":
        return nms_rows_reference(boxes, dsel, thresh)  # which checks the inputs
    return _launch(boxes, dsel, thresh, dsel.shape[-1] > MAX_K)


nms_rows.launches = 0
nms_rows.long_launches = 0  # of those, the launches that took the workspace


def _workspace(device: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """This device's and stream's workspace for long rows, made on first
    use and made anew only when a call needs more than it holds. Launches
    on one stream run one after the other, so one workspace a stream is
    never shared by two running kernels."""
    key = (device.index, stream)
    held = _workspaces.get(key)
    if held is None or held.numel() < nbytes:
        held = torch.empty(nbytes, dtype=torch.uint8, device=device)
        _workspaces[key] = held
    return held


def _launch(boxes: torch.Tensor, dsel: torch.Tensor, thresh: float, long: bool) -> torch.Tensor:
    """The kernel on CUDA tensors: in shared memory, or with `long` in the
    workspace (which `nms_rows` takes for K > MAX_K; the smoke also takes it
    on short rows, to hold it to the plain version on the group edges)."""
    r, k = _check(boxes, dsel)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_rows: unsupported device {boxes.device}")
    keep = torch.empty((r, k), dtype=torch.bool, device=boxes.device)
    if r == 0 or k == 0:
        return keep
    fn = _kernel()
    # whole float4 words a row, as the kernel strides the workspace
    row = -(-k * ROW_BYTES // 16) * 16

    def call(stream: int) -> int:
        work = _workspace(boxes.device, stream, r * row).data_ptr() if long else None
        return fn(boxes.data_ptr(), dsel.data_ptr(), keep.data_ptr(), r, k, float(thresh),
                  work, stream)

    err = launch_on(boxes.device, call)
    if err != 0:
        raise RuntimeError(f"nms_rows: kernel launch failed with CUDA error {err}")
    nms_rows.launches += 1
    nms_rows.long_launches += int(long)
    return keep


def nms_rows_reference(boxes: torch.Tensor, dsel: torch.Tensor, thresh: float) -> torch.Tensor:
    """Plain PyTorch version of `nms_rows`: the (R, K, K) IoU matrix with
    `iou_xywh_t`, then the sequential suppression loop over all rows at once."""
    _check(boxes, dsel)
    k = dsel.shape[1]
    ious = iou_xywh_t(boxes[:, :, None, :], boxes[:, None, :, :])
    over = ious > torch.tensor(thresh, dtype=torch.float32, device=boxes.device)
    idx = torch.arange(k, device=boxes.device)
    conf = dsel.clone()
    for i in range(k):
        alive = conf[:, i] > 0
        suppress = alive[:, None] & (idx > i)[None, :] & over[:, i]
        conf = torch.where(suppress, torch.zeros_like(conf), conf)
    return conf > 0
