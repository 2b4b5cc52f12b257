"""Per-channel sum and sum of squares for training BatchNorm: CUDA kernels
with a backward, and their plain versions.

Counterpart of the JAX package's `ops/bn_pallas.py`: `bn_sums(x)` replaces
the TPU kernel `_sums_kernel` (reached through `_sums_pallas_2d`) and the
elementwise backward of its custom VJP. The kernel source is
`csrc/bn_sums.cu`; `ops/_build.py` compiles it with `nvcc` for sm_90a at
first use and loads it with `ctypes`.

Bound on an H100: bytes. The forward reads the (M, C) activation once
(M*C*itemsize) and writes 2*C floats; the backward reads it once and writes
as much. The design is two forward kernels, per-block partial sums into a
(G, C) table and a fold of that table, both in a fixed order, so the result
does not change from run to run; adjacent threads read adjacent channels,
and for C < 32 a warp takes several whole rows.

The kernels take the activation as a row-major (M, C) array, i.e. NHWC
memory. A tensor that is not contiguous is copied first, and the copy is
counted in `bn_sums.layout_copies`: a silent layout copy at this boundary
costs a full pass over the activation.

`bn_sums_reference` and `bn_sums_backward_reference` are the plain PyTorch
versions. They serve CPU tensors and are what the kernels are compared
against; on a CUDA tensor `bn_sums` launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

# threads of a block along the channels and along the rows (csrc/bn_sums.cu)
_TX, _TY = 32, 8
# blocks the card holds at once: 132 SMs x 8 blocks of 256 threads
_RESIDENT_BLOCKS = 132 * 8
_DTYPES = (torch.float32, torch.bfloat16)

_fns = None


def _kernels():
    """(`fsd_bn_sums_fwd`, `fsd_bn_sums_bwd`) of csrc/bn_sums.cu, built and
    loaded on first use."""
    global _fns
    if _fns is None:
        lib = load_library("bn_sums")
        fwd, bwd = lib.fsd_bn_sums_fwd, lib.fsd_bn_sums_bwd
        fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


def row_blocks(m: int, c: int) -> int:
    """Blocks along the rows (the kernels' grid.y, and the rows of the
    partials table): enough to fill the card once, never more than there are
    rows to hand out."""
    fold = _TX // c if c < _TX else 1
    tiles = -(-c // _TX)
    by_rows = -(-m // (_TY * fold))
    return max(1, min(by_rows, -(-_RESIDENT_BLOCKS // tiles), 65535))


def _check(x: torch.Tensor) -> tuple[int, int]:
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_sums takes float32 or bfloat16, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"bn_sums takes (..., C) with C > 0, got {tuple(x.shape)}")
    c = x.shape[-1]
    return x.numel() // c, c


def _launch_forward(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m, c = _check(x)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if m == 0:
        out.zero_()
        return out[0], out[1]
    if x.data_ptr() % x.element_size():
        raise ValueError("bn_sums: misaligned tensor")
    g = row_blocks(m, c)
    partials = torch.empty((2, g, c), dtype=torch.float32, device=x.device)
    fwd, _ = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fwd(x.data_ptr(), partials.data_ptr(), out.data_ptr(), m, c, g,
                  int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"bn_sums: forward launch failed with CUDA error {err}")
    bn_sums.launches += 1
    return out[0], out[1]


def _launch_backward(x: torch.Tensor, dsum: torch.Tensor, dsq: torch.Tensor) -> torch.Tensor:
    m, c = _check(x)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if m == 0:
        return dx
    dsum = dsum.to(torch.float32).contiguous()
    dsq = dsq.to(torch.float32).contiguous()
    _, bwd = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = bwd(x.data_ptr(), dsum.data_ptr(), dsq.data_ptr(), dx.data_ptr(), m, c,
                  row_blocks(m, c), int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"bn_sums: backward launch failed with CUDA error {err}")
    bn_sums.backward_launches += 1
    return dx


def bn_sums_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `bn_sums`: float32 sums over all leading axes."""
    _check(x)
    xf = x.float()
    axes = tuple(range(x.ndim - 1))
    if not axes:
        return xf.clone(), xf * xf
    return xf.sum(dim=axes), (xf * xf).sum(dim=axes)


def bn_sums_backward_reference(
    x: torch.Tensor, dsum: torch.Tensor | None, dsq: torch.Tensor | None
) -> torch.Tensor:
    """Plain PyTorch version of the backward: dx = dsum + (2*x)*dsq in
    float32, rounded once to x's dtype. A `None` gradient counts as zeros."""
    dsum, dsq = _grads_or_zeros(x, dsum, dsq)
    dx = dsum.float() + (2.0 * x.float()) * dsq.float()
    return dx.to(x.dtype)


def _grads_or_zeros(x, dsum, dsq):
    c = x.shape[-1]
    if dsum is None:
        dsum = torch.zeros(c, dtype=torch.float32, device=x.device)
    if dsq is None:
        dsq = torch.zeros(c, dtype=torch.float32, device=x.device)
    return dsum, dsq


def bn_sums_backward(
    x: torch.Tensor, dsum: torch.Tensor | None, dsq: torch.Tensor | None
) -> torch.Tensor:
    """Gradient of `bn_sums` to a contiguous x: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return bn_sums_backward_reference(x, dsum, dsq)
    dsum, dsq = _grads_or_zeros(x, dsum, dsq)
    return _launch_backward(x, dsum, dsq)


class _BnSums(torch.autograd.Function):
    """x (contiguous, (..., C)) -> (sum, sumsq); saves x for the backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            return bn_sums_reference(x)
        return _launch_forward(x)

    @staticmethod
    def backward(ctx, dsum, dsq):
        (x,) = ctx.saved_tensors
        return bn_sums_backward(x, dsum, dsq)


def bn_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares) over all leading axes, per channel, float32,
    differentiable.

    x (..., C) float32 or bfloat16. A CUDA tensor goes to the kernels (built
    at first use; any failure to build, load or launch raises); a CPU tensor
    goes to the plain versions. `bn_sums.launches` and
    `bn_sums.backward_launches` count kernel launches (a forward launch is
    the pair partial sums + fold); `bn_sums.layout_copies` counts inputs
    that had to be copied into row-major order first."""
    _check(x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_sums: unsupported device {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
        bn_sums.layout_copies += 1
    return _BnSums.apply(x)


bn_sums.launches = 0
bn_sums.backward_launches = 0
bn_sums.layout_copies = 0
