"""2x2 stride-2 max pooling of NHWC tensors: a CUDA kernel each way, and the
plain versions.

`maxpool2x2(x)` pools a (B, H, W, C) tensor with floor semantics, as
`F.max_pool2d(x, 2, 2)` pools its channels-last view, with the same values
and the same gradients. It replaces no TPU kernel: XLA lowered the pool to
its own `reduce_window`. The kernel source is `csrc/maxpool.cu`;
`ops/_build.py` compiles it with `nvcc` for sm_90a at first use and loads it
with `ctypes`.

Bound on an H100: bytes. With T the input's bytes, the least a pool can move
is T + T/4 forward (read x, write y) and T/4 + T backward (read dy, write
dx). PyTorch's pair wrote and read an int64 index per output element on top
(T each way in bfloat16), and autograd kept x for its backward. Here the
forward writes a 1-byte window code per output element instead (0-3, which
of the four positions won, T/8 in bfloat16), the function saves that code
and nothing else, and the backward writes dy at the coded position and 0 at
the other three. Under `torch.no_grad()`, or for an x that needs no
gradient, no code is written.

The window's winner is PyTorch's: starting from -inf and scanning in
row-major window order, a value is taken when it is greater than the best
so far or is a NaN, so ties and +0 against -0 go to the first, NaNs to the
last. PyTorch's CPU and CUDA kernels part in two corners, and the plain
version follows the kernel of its tensor's device, so that it gives
`F.max_pool2d`'s bits on either: a window that is all -inf routes its
gradient nowhere on the card (the code is `NONE`; PyTorch's NHWC kernel
keeps an index that lies in no window) and to its first position on the
CPU (code 0); and a gradient of -0 is copied as -0 on the card, where the
CPU's kernel adds it to a zero and writes +0. The CUDA kernels do what the
card's `F.max_pool2d` does.

Geometry: 16-byte loads on the vector path (C a multiple of 16 / itemsize,
every array aligned), the scalar path otherwise, chosen by the library on
shape and alignment alone and reported in `maxpool2x2.last_path`. A tensor
that is not contiguous is copied first and the copy counted in
`maxpool2x2.layout_copies`.

`maxpool2x2_reference` and `maxpool2x2_backward_reference` are the plain
versions, the same code-based forward and backward in PyTorch: CPU tensors
take them, and the kernels are held against them on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import launch_on, load_library

# the library's codes of the types it takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the window's positions in scan order: (row, column) offsets of the code's 0-3
WINDOW = ((0, 0), (0, 1), (1, 0), (1, 1))
# the code of a window where no value was taken (all -inf) on the card
NONE = 4

_fns = None


def _kernels():
    """(`fsd_maxpool2x2_fwd`, `fsd_maxpool2x2_bwd`) of csrc/maxpool.cu,
    built and loaded on first use."""
    global _fns
    if _fns is None:
        lib = load_library("maxpool")
        fwd, bwd = lib.fsd_maxpool2x2_fwd, lib.fsd_maxpool2x2_bwd
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd.argtypes = [p, p, p, ll, i, i, i, i, p, ctypes.POINTER(i)]
        bwd.argtypes = [p, p, p, ll, i, i, i, i, p, ctypes.POINTER(i)]
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


def takes(x: torch.Tensor) -> bool:
    """True when `maxpool2x2` takes x: a 4-D floating tensor on the CPU (the
    plain version) or on the card in float32, bfloat16 or float16."""
    return x.ndim == 4 and (x.device.type == "cpu" and x.dtype.is_floating_point
                            or x.device.type == "cuda" and x.dtype in _DTYPES)


def maxpool2x2_reference(x: torch.Tensor, with_code: bool = True):
    """Plain forward: (y, code) for x (B, H, W, C), code (B, H/2, W/2, C)
    uint8 or None. The four positions of each window are compared in scan
    order with PyTorch's rule, so y is `F.max_pool2d`'s bit for bit; a
    window where no value is taken keeps code 0 on the CPU, `NONE` on the
    card, as the two devices' PyTorch kernels keep their index."""
    _, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    parts = [x[:, dh:2 * ho:2, dw:2 * wo:2] for dh, dw in WINDOW]
    y = torch.full(parts[0].shape, -float("inf"), dtype=x.dtype, device=x.device)
    code = None
    if with_code:
        none = 0 if x.device.type == "cpu" else NONE
        code = torch.full(y.shape, none, dtype=torch.uint8, device=x.device)
    for k, v in enumerate(parts):
        take = (v > y) | torch.isnan(v)
        y = torch.where(take, v, y)
        if with_code:
            code = torch.where(take, k, code)
    return y.contiguous(), code


def maxpool2x2_backward_reference(dy: torch.Tensor, code: torch.Tensor, h: int, w: int):
    """Plain backward: dx (B, h, w, C) with dy at each window's coded
    position and 0 elsewhere (the rows and columns the floor dropped too).
    On the CPU dy is added to a zero, as PyTorch's CPU kernel adds it, so
    -0 comes out +0 there; on the card it is copied, as there."""
    b, ho, wo, c = dy.shape
    dx = dy.new_zeros((b, h, w, c))
    zero = dy.new_zeros(())
    for k, (dh, dw) in enumerate(WINDOW):
        g = torch.where(code == k, dy, zero)
        dx[:, dh:2 * ho:2, dw:2 * wo:2] = g + 0 if dy.device.type == "cpu" else g
    return dx


def _launch_forward(x: torch.Tensor, with_code: bool):
    """(y, code or None) of a contiguous CUDA x, one kernel launch."""
    b, h, w, c = x.shape
    y = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    code = torch.empty(y.shape, dtype=torch.uint8, device=x.device) if with_code else None
    if y.numel() == 0:
        return y, code
    fwd, _ = _kernels()
    path = ctypes.c_int(-1)
    err = launch_on(x.device, lambda stream: fwd(
        x.data_ptr(), y.data_ptr(), None if code is None else code.data_ptr(), b, h, w, c,
        _DTYPES[x.dtype], stream, ctypes.byref(path)))
    if err != 0:
        raise RuntimeError(f"maxpool2x2: forward launch failed with CUDA error {err}")
    maxpool2x2.launches += 1
    maxpool2x2.last_path = ("scalar", "vector")[path.value]
    return y, code


def _launch_backward(dy: torch.Tensor, code: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """dx (B, h, w, C) of a contiguous CUDA dy and the forward's code."""
    b, ho, wo, c = dy.shape
    if code.shape != dy.shape or code.dtype != torch.uint8 or code.device != dy.device:
        raise ValueError(f"maxpool2x2: the code is {code.dtype} {tuple(code.shape)}, "
                         f"the gradient {tuple(dy.shape)}")
    dx = torch.empty((b, h, w, c), dtype=dy.dtype, device=dy.device)
    if dy.numel() == 0:
        return dx.zero_()
    _, bwd = _kernels()
    path = ctypes.c_int(-1)
    err = launch_on(dy.device, lambda stream: bwd(
        dy.data_ptr(), code.data_ptr(), dx.data_ptr(), b, h, w, c, _DTYPES[dy.dtype], stream,
        ctypes.byref(path)))
    if err != 0:
        raise RuntimeError(f"maxpool2x2: backward launch failed with CUDA error {err}")
    maxpool2x2.backward_launches += 1
    maxpool2x2.last_backward_path = ("scalar", "vector")[path.value]
    return dx


def _forward(x: torch.Tensor, with_code: bool):
    if x.device.type == "cpu":
        return maxpool2x2_reference(x, with_code)
    return _launch_forward(x, with_code)


class _MaxPool2x2(torch.autograd.Function):
    """x contiguous (B, H, W, C) -> its 2x2 stride-2 max pool; saves the
    window code and nothing else."""

    @staticmethod
    def forward(ctx, x):
        y, code = _forward(x, True)
        ctx.save_for_backward(code)
        ctx.hw = x.shape[1], x.shape[2]
        return y

    @staticmethod
    def backward(ctx, dy):
        (code,) = ctx.saved_tensors
        h, w = ctx.hw
        if dy.device.type == "cpu":
            return maxpool2x2_backward_reference(dy, code, h, w)
        if not dy.is_contiguous():
            dy = dy.contiguous()
            maxpool2x2.layout_copies += 1
        return _launch_backward(dy, code, h, w)


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of x (B, H, W, C), floor semantics,
    differentiable; `F.max_pool2d`'s values and gradients.

    A CUDA tensor in float32, bfloat16 or float16 goes to the kernels (built
    at first use; any failure to build, load or launch raises); a CPU tensor
    goes to the plain versions. `maxpool2x2.launches` and
    `.backward_launches` count kernel launches; `.layout_copies` counts
    inputs and gradients that had to be copied into row-major order first."""
    if not takes(x):
        raise TypeError(f"maxpool2x2 takes a 4-D floating CPU tensor or a CUDA tensor in "
                        f"float32, bfloat16 or float16, got {x.dtype} {tuple(x.shape)} "
                        f"on {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
        maxpool2x2.layout_copies += 1
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool2x2.apply(x)
    return _forward(x, False)[0]


maxpool2x2.launches = 0
maxpool2x2.backward_launches = 0
maxpool2x2.layout_copies = 0
maxpool2x2.last_path = None
maxpool2x2.last_backward_path = None
