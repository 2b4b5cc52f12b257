"""ctypes binding + on-demand build of the native image pipeline.

The shared library is compiled from the sources in `src/` (host C++:
`imagepipe.cpp`, the pipeline; `pngdec.cpp` and `jpegdec.cpp`, the port's own
decoders; zlib and pthreads, no system image library) with `g++` at first
use, never at import, with the flags the JAX package uses, into the
package's `_build/` directory. Its name carries a hash of every source, the
compiler and the flags, and it is written under a temporary name and then
renamed, so processes that build at the same time do not collide and an
edited source is rebuilt.

A missing compiler, missing zlib headers, or a failed build raise
`RuntimeError` with the compiler's output: the port does not fall back to
PIL, which the machine with the card does not have. A file that does not
decode raises `IOError` naming the file and the reason, among them the JPEG
codings that libjpeg-turbo fails on too (lossless, 12-bit, CMYK).

The native path is an opt-in throughput path (`FSD_NATIVE=1`). The
datasets' interpolation is a PIL-style triangle filter, as in the JAX
package's native library: close to PIL's BILINEAR, not to its default.
`resize_pil` / `load_resized_pil` (`src/resize.cpp`) are PIL's default
`Image.resize` (bicubic), bit for bit."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "imagepipe.cpp")
SOURCES = (SOURCE, os.path.join(_HERE, "src", "pngdec.cpp"),
           os.path.join(_HERE, "src", "jpegdec.cpp"), os.path.join(_HERE, "src", "resize.cpp"))
HEADERS = (os.path.join(_HERE, "src", "decoders.h"),)
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBS = ("-lz",)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_u8_p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "fsd_image_size": [ctypes.c_char_p, _c_int_p, _c_int_p],
    "fsd_decode_error": [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int],
    "fsd_decode": [ctypes.c_char_p, _c_u8_p, ctypes.c_int, _c_int_p, _c_int_p],
    "fsd_load_augment": [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, _c_float_p,
    ],
    "fsd_load_plain": [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _c_float_p],
    "fsd_load_batch": [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _c_float_p, ctypes.c_int, _c_float_p, ctypes.c_int,
    ],
    "fsd_augment_raw": [
        _c_u8_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _c_float_p,
    ],
    "fsd_resize_pil": [_c_u8_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c_u8_p],
    "fsd_load_resized_pil": [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _c_u8_p],
    "fsd_load_batch_raw": [
        ctypes.POINTER(_c_u8_p), _c_int_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _c_float_p, ctypes.c_int, _c_float_p, ctypes.c_int,
    ],
}


def build_command(out: str) -> list[str]:
    return [CXX, *CXX_FLAGS, *SOURCES, "-o", out, *LIBS]


def library_path() -> str:
    """Where the library for these sources, compiler and flags lives."""
    h = hashlib.sha1()
    for path in (*SOURCES, *HEADERS):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(build_command("")).encode())
    return os.path.join(BUILD_DIR, f"libimagepipe_{h.hexdigest()[:12]}.so")


def build_library() -> str:
    """Compile the library unless it is there; returns its path. Raises
    RuntimeError when the compiler is missing or fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        proc = subprocess.run(build_command(tmp), capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native image pipeline: cannot run {CXX}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"native image pipeline: {CXX} failed ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library, built on first use and then kept."""
    with _lock:
        lib_path = library_path()
        if lib_path not in _loaded:
            lib = ctypes.CDLL(build_library())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[lib_path] = lib
        return _loaded[lib_path]


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_c_float_p)


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_c_u8_p)


def _batch_params(n: int, params: np.ndarray | None) -> tuple[np.ndarray, int]:
    """(the (n, 8) float32 parameter table, augment flag)."""
    if params is None:
        return np.zeros((n, 8), np.float32), 0
    p = np.ascontiguousarray(params, np.float32)
    if p.shape != (n, 8):
        raise ValueError(f"augment params of shape {p.shape}, not ({n}, 8)")
    return p, 1


class NativeImagePipe:
    """Batch-oriented native loader; the methods of the JAX package's."""

    def __init__(self, n_threads: int | None = None):
        self.lib = load_library()
        self.n_threads = n_threads or max(os.cpu_count() or 1, 1)

    def failure(self, path: str, size_only: bool = False) -> IOError:
        """The error for a file that did not decode: its name and why."""
        msg = ctypes.create_string_buffer(256)
        self.lib.fsd_decode_error(path.encode(), int(size_only), msg, len(msg))
        why = msg.value.decode(errors="replace") or "unknown reason"
        return IOError(f"cannot decode {path}: {why}")

    def image_size(self, path: str) -> tuple[int, int]:
        """(width, height) from the file's header, without decoding pixels."""
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self.lib.fsd_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise self.failure(path, size_only=True)
        return w.value, h.value

    def decode(self, path: str) -> np.ndarray:
        w, h = self.image_size(path)
        buf = np.empty((h, w, 3), np.uint8)
        rc = self.lib.fsd_decode(
            path.encode(), _u8ptr(buf), buf.size,
            ctypes.byref(ctypes.c_int()), ctypes.byref(ctypes.c_int()),
        )
        if rc != 0:
            raise self.failure(path)
        return buf

    def load_plain(self, path: str, width: int, height: int) -> np.ndarray:
        out = np.empty((height, width, 3), np.float32)
        rc = self.lib.fsd_load_plain(path.encode(), width, height, _fptr(out))
        if rc != 0:
            raise self.failure(path)
        return out

    def load_resized_pil(self, path: str, width: int, height: int) -> np.ndarray:
        """(height, width, 3) uint8: the file decoded to RGB and resized as
        PIL's `Image.open(path).convert("RGB").resize((width, height))`."""
        out = np.empty((height, width, 3), np.uint8)
        rc = self.lib.fsd_load_resized_pil(path.encode(), width, height, _u8ptr(out))
        if rc != 0:
            raise self.failure(path)
        return out

    def resize_pil(self, rgb: np.ndarray, width: int, height: int) -> np.ndarray:
        """A decoded (H, W, 3) uint8 array resized as PIL's default
        `Image.resize((width, height))` (bicubic, fixed point), uint8."""
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.ndim != 3 or rgb.shape[2] != 3 or min(rgb.shape[:2] + (width, height)) <= 0:
            raise ValueError(f"resize_pil of an array of shape {rgb.shape} to {width}x{height}")
        out = np.empty((height, width, 3), np.uint8)
        rc = self.lib.fsd_resize_pil(_u8ptr(rgb), rgb.shape[1], rgb.shape[0], width, height,
                                     _u8ptr(out))
        if rc != 0:
            raise ValueError("fsd_resize_pil failed")
        return out

    def load_augment(
        self, path: str, width: int, height: int,
        pleft: int, pright: int, ptop: int, pbot: int,
        flip: int, dhue: float, dsat: float, dexp: float,
    ) -> np.ndarray:
        out = np.empty((height, width, 3), np.float32)
        rc = self.lib.fsd_load_augment(
            path.encode(), width, height, pleft, pright, ptop, pbot,
            flip, dhue, dsat, dexp, _fptr(out),
        )
        if rc != 0:
            raise self.failure(path)
        return out

    def load_batch(
        self,
        paths: list[str],
        width: int,
        height: int,
        params: np.ndarray | None = None,
    ) -> tuple[np.ndarray, int]:
        """params: (n, 8) float32 [pleft,pright,ptop,pbot,flip,dhue,dsat,
        dexp] or None for plain resize. Returns (batch, n_failed); a failed
        image's slot is zero."""
        n = len(paths)
        out = np.empty((n, height, width, 3), np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        p, augment = _batch_params(n, params)
        fails = self.lib.fsd_load_batch(
            arr, n, width, height, _fptr(p), augment, _fptr(out), self.n_threads,
        )
        return out, int(fails)

    def augment_raw(
        self, rgb: np.ndarray, width: int, height: int,
        pleft: int, pright: int, ptop: int, pbot: int,
        flip: int, dhue: float, dsat: float, dexp: float,
    ) -> np.ndarray:
        """Augment tail on an already decoded (H,W,3) uint8 array — no IO."""
        rgb = np.ascontiguousarray(rgb, np.uint8)
        out = np.empty((height, width, 3), np.float32)
        rc = self.lib.fsd_augment_raw(
            _u8ptr(rgb), rgb.shape[1], rgb.shape[0], width, height,
            pleft, pright, ptop, pbot, flip, dhue, dsat, dexp, 1, _fptr(out),
        )
        if rc != 0:
            raise ValueError("fsd_augment_raw failed")
        return out

    def resize_raw(self, rgb: np.ndarray, width: int, height: int) -> np.ndarray:
        """Plain filtered resize of a decoded (H,W,3) uint8 array."""
        rgb = np.ascontiguousarray(rgb, np.uint8)
        out = np.empty((height, width, 3), np.float32)
        rc = self.lib.fsd_augment_raw(
            _u8ptr(rgb), rgb.shape[1], rgb.shape[0], width, height,
            0, 0, 0, 0, 0, 0.0, 0.0, 0.0, 0, _fptr(out),
        )
        if rc != 0:
            raise ValueError("fsd_augment_raw failed")
        return out

    def load_batch_raw(
        self,
        bufs: list[np.ndarray],
        width: int,
        height: int,
        params: np.ndarray | None = None,
    ) -> tuple[np.ndarray, int]:
        """Batch augment over decoded (H,W,3) uint8 arrays (RAM cache hits).
        Same params layout/return as load_batch."""
        n = len(bufs)
        bufs = [np.ascontiguousarray(b, np.uint8) for b in bufs]
        out = np.empty((n, height, width, 3), np.float32)
        ptrs = (_c_u8_p * n)(*[_u8ptr(b) for b in bufs])
        whs = np.asarray([[b.shape[1], b.shape[0]] for b in bufs], np.int32).reshape(n, 2)
        p, augment = _batch_params(n, params)
        fails = self.lib.fsd_load_batch_raw(
            ptrs, whs.ctypes.data_as(_c_int_p), n,
            width, height, _fptr(p), augment, _fptr(out), self.n_threads,
        )
        return out, int(fails)
