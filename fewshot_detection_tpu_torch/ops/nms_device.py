"""Batched greedy NMS on the device: a CUDA kernel and its plain version.

`nms_rows` replaces the TPU kernel `ops/nms_device.py:_nms_kernel` of the JAX
package (reached through `nms_pallas` under a per-row `vmap`) for ALL
(image, class) rows of a batch at once. The kernel source is
`csrc/nms.cu`; it is compiled with `nvcc` for sm_90a at first use into
`_build/` inside the package and loaded with `ctypes`.

Bound on an H100: the function reads R*K*20 bytes and writes R*K (a few
hundred nanoseconds at the card's memory rate), and the pairwise IoUs are
less float32 arithmetic than that; the time actually follows the chain of
dependent steps, one per kept candidate of the longest row. The design spends one thread block per
row, keeps the row's boxes and confidences in shared memory, computes IoUs
on the fly instead of reading an (R, K, K) matrix from device memory, ends
the chain at the last live candidate and skips suppressed ones.

`nms_rows_reference` is the plain PyTorch version of the same function (the
loop of the JAX package's `nms_jax`, over all rows at once). It serves CPU
tensors and is what the kernel is compared against; on a CUDA tensor
`nms_rows` launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from .boxes import iou_xywh_t

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMS_SOURCE = os.path.join(_PKG_DIR, "csrc", "nms.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
# K*(16+4) bytes of shared memory per row must fit one block's 227 KB
MAX_K = 11000


def _find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the NMS kernel cannot be built")


def build_nms_library(verbose: bool = False) -> str:
    """Compile csrc/nms.cu into _build/ (keyed by the source's hash) and
    return the library's path. Raises when the compiler is missing or fails."""
    with open(NMS_SOURCE, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = os.path.join(BUILD_DIR, f"libfsd_nms_{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = [_find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, NMS_SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, lib)
    return lib


class _Lib:
    """The loaded library, built on first use and then kept."""

    fn = None


def _kernel():
    if _Lib.fn is None:
        lib = ctypes.CDLL(build_nms_library())
        fn = lib.fsd_nms_rows
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _Lib.fn = fn
    return _Lib.fn


def _check(boxes: torch.Tensor, dsel: torch.Tensor) -> tuple[int, int]:
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
    r, k = dsel.shape
    if k > MAX_K:
        raise ValueError(f"nms_rows: K={k} exceeds the kernel's limit {MAX_K}")
    return r, k


def nms_rows(boxes: torch.Tensor, dsel: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS of every row at once.

    boxes (R, K, 4) float32 cxcywh, already confidence-descending within a
    row; dsel (R, K) float32 confidences, 0 for masked-out slots. Returns
    keep (R, K) bool: ``keep[r, j]`` = candidate j survives the greedy pass
    of row r and ``dsel[r, j] > 0``.

    A CUDA tensor goes to the kernel (built at first use; any failure to
    build, load or launch raises); a CPU tensor goes to the plain version.
    `nms_rows.launches` counts kernel launches."""
    r, k = _check(boxes, dsel)
    if boxes.device.type == "cpu":
        return nms_rows_reference(boxes, dsel, thresh)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_rows: unsupported device {boxes.device}")
    keep = torch.empty((r, k), dtype=torch.bool, device=boxes.device)
    if r == 0 or k == 0:
        return keep
    fn = _kernel()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), dsel.data_ptr(), keep.data_ptr(),
                 r, k, float(thresh), stream)
    if err != 0:
        raise RuntimeError(f"nms_rows: kernel launch failed with CUDA error {err}")
    nms_rows.launches += 1
    return keep


nms_rows.launches = 0


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
