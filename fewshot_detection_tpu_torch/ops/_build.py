"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` has a plain C interface (no PyTorch
headers), is compiled with `nvcc` for sm_90a into `_build/` inside the
package at first use, never at import, and is loaded with `ctypes`. The
library's name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is found again. A missing compiler or
a failed build raises: no wrapper falls back to its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# -fmad=false: the kernels must round where their plain PyTorch versions
# round, so the compiler may not contract a*b + c into one operation
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    """Path of `csrc/<name>.cu`."""
    return os.path.join(CSRC_DIR, f"{name}.cu")


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libfsd_{name}_{tag}.so")


def start_build(name: str, verbose: bool = False):
    """Start `nvcc` on csrc/<name>.cu without waiting; returns a handle for
    `finish_build`, or None when the library is already there. Several
    sources build side by side when all are started before any is waited on."""
    lib = library_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, lib, verbose


def finish_build(handle) -> None:
    if handle is None:
        return
    proc, tmp, lib, verbose = handle
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}\n{err}")
    if verbose:
        print(err.strip())
    os.replace(tmp, lib)


def build_library(name: str, verbose: bool = False) -> str:
    """Compile csrc/<name>.cu into _build/ (keyed by the source's hash) and
    return the library's path. Raises when the compiler is missing or fails."""
    finish_build(start_build(name, verbose))
    return library_path(name)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use and then kept."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build_library(name))
    return _loaded[name]


def launch_on(device: torch.device, call) -> int:
    """`call(stream)` with `device` current and `stream` its current stream's
    handle; returns what `call` returns (the launch's error code). The device
    is switched only when it is not the current one already, and the handle
    is read without building a `torch.cuda.Stream`: either costs the host
    more time than a small kernel takes on the card."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return call(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return call(torch._C._cuda_getCurrentRawStream(index))
