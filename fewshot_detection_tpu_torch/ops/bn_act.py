"""Training BatchNorm's epilogue, out = act(y * inv + bias): a CUDA kernel
each way, and the plain versions.

`bn_act(y, inv, bias, activation)` normalises a conv output y (..., C) with
the float32 per-channel pair that `layers.bn_train_affine` takes from the
`bn_sums` statistics, and applies the activation (leaky 0.1, relu, or
anything else as linear, as `layers._activate` reads it). It replaces no TPU
kernel: XLA fused this epilogue on the TPU, and eager PyTorch ran it as about
five elementwise kernels forward and ten backward. The kernel source is
`csrc/bn_act.cu`; `ops/_build.py` compiles it with `nvcc` for sm_90a at first
use and loads it with `ctypes`.

Bound on an H100: bytes. The forward reads y and writes out; the backward
reads dout and y, writes dy, and sums the pair's gradients per channel in
the same pass (dinv = sum g*y, dbias = sum g, g the gradient at the affine
output). Both kernels round where the composition rounds, so out and dy are
its bits and the sums differ from its reductions only in the order of the
additions (`csrc/bn_act.cu` lists the rounding points).

The function saves y, inv and bias and nothing else: the backward rebuilds
the affine output from them. y is the conv output that `bn_sums` saves
already, so the epilogue keeps no tensor of its own for the backward, and
rematerialising it (as `torch.utils.checkpoint` did) has nothing left to
save.

Geometry follows `ops/bn_sums.py`: 16-byte loads on the vector path
(C % (16 / itemsize) == 0 and every array 16-byte aligned), the scalar path
otherwise, chosen by the library on shape and alignment alone and reported
in `bn_act.last_path`; the backward's per-channel sums go through a table of
per-block partials that the last block of a channel tile folds. The table
and the tiles' tickets live in `bn_sums`' workspace of the device and
stream: both libraries' kernels leave the tickets at 0, and kernels of one
stream run one after another, so the epilogue holds no memory of its own. A tensor that is not contiguous is
copied first and the copy counted in `bn_act.layout_copies`.

`bn_act_reference` (the composition, differentiable by autograd) and
`bn_act_backward_reference` (its backward written out with the same
operations) are the plain versions: CPU tensors take them, and the kernels
are held against them on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import launch_on, load_library
# the vector path's rule (C a multiple of 16 / itemsize, every array 16-byte
# aligned: pass the OR of their addresses), which csrc/bn_act.cu applies too;
# the workspace of a device and stream, shared with bn_sums' kernels
from .bn_sums import _workspace, vector_width

# activation codes of csrc/bn_act.cu; any other name is linear
_CODES = {"leaky": 0, "relu": 1}
_LINEAR = 2
# threads of a block along the channels and along the rows, loads a thread
# has in flight on the vector path, and threads across a channel tile there
_TX, _TY = 32, 8
_UNROLL = 4
_VEC_LANES = 8
# blocks an SM holds of each kernel (csrc/bn_act.cu's launch bounds; the
# scalar kernels use few registers), on an H100's 132 SMs
_SMS = 132
_FWD_PER_SM, _BWD_PER_SM, _SCALAR_PER_SM = 4, 2, 8
_DTYPES = (torch.float32, torch.bfloat16)
# values one float32 accumulator of the backward's sums takes at most, as
# `ops/bn_sums.py:_MAX_CHAIN`
_MAX_CHAIN = 512

_fns = None


def _kernels():
    """(`fsd_bn_act_fwd`, `fsd_bn_act_bwd`) of csrc/bn_act.cu, built and
    loaded on first use."""
    global _fns
    if _fns is None:
        lib = load_library("bn_act")
        fwd, bwd = lib.fsd_bn_act_fwd, lib.fsd_bn_act_bwd
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd.argtypes = [p, p, p, p, ll, i, i, i, i, p, ctypes.POINTER(i)]
        bwd.argtypes = [p, p, p, p, p, p, i, p, ll, i, i, i, i, p, ctypes.POINTER(i)]
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


def activation_code(activation: str) -> int:
    return _CODES.get(activation, _LINEAR)


def row_blocks(m: int, c: int, vec: int = 1, backward: bool = False) -> int:
    """Blocks along the rows (the kernels' grid.y, and the rows of the
    backward's table of partials): enough to fill the card once, never more
    than there are rows to hand out. `vec` is the channels a thread owns (1
    on the scalar path).

    `backward=True` also keeps every float32 accumulator of the sums to
    `_MAX_CHAIN` values: a tall input gets more blocks, in whole waves of
    the card. A vector thread adds two values a pass to each of its chains;
    a scalar thread rotates four chains, one value a row."""
    cv = c // vec
    cw = min(cv, _TX if vec == 1 else _VEC_LANES)
    tiles = -(-cv // cw)
    rows = _TY * (_TX // cw) * (1 if vec == 1 else _UNROLL)  # rows a pass of a block covers
    per_sm = _SCALAR_PER_SM if vec == 1 else (_BWD_PER_SM if backward else _FWD_PER_SM)
    wave = max(1, _SMS * per_sm // tiles)  # blocks along the rows that fill the card once
    most = -(-m // rows)
    g = min(most, wave)
    if backward:
        passes = 4 * _MAX_CHAIN if vec == 1 else _MAX_CHAIN // 2
        need = -(-m // (rows * passes))
        if need > g:
            g = min(-(-need // wave) * wave, most)
    return max(1, min(g, 65535))


def _check(y: torch.Tensor) -> tuple[int, int]:
    if y.dtype not in _DTYPES:
        raise TypeError(f"bn_act takes float32 or bfloat16, got {y.dtype}")
    if y.ndim < 1 or y.shape[-1] == 0:
        raise ValueError(f"bn_act takes (..., C) with C > 0, got {tuple(y.shape)}")
    c = y.shape[-1]
    return y.numel() // c, c


def _pair(y: torch.Tensor, inv: torch.Tensor, bias: torch.Tensor):
    """inv and bias as the kernels take them: contiguous float32 (C,) on y's
    device; y itself must be row-major (the wrapper copies it first)."""
    if not y.is_contiguous():
        raise ValueError("bn_act: the kernels take a row-major (..., C) tensor")
    c = y.shape[-1]
    out = []
    for name, t in (("inv", inv), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or t.device != y.device:
            raise ValueError(f"bn_act: {name} must be float32 ({c},) on {y.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t.detach().contiguous())
    return out


def _address(*tensors: torch.Tensor) -> int:
    a = 0
    for t in tensors:
        a |= t.data_ptr()
    return a


def _launch_forward(y: torch.Tensor, inv: torch.Tensor, bias: torch.Tensor, act: int) -> torch.Tensor:
    m, c = _check(y)
    inv, bias = _pair(y, inv, bias)
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    if m == 0:
        return out
    g = row_blocks(m, c, vector_width(c, y.element_size(), _address(y, out)))
    fwd, _ = _kernels()
    path = ctypes.c_int(-1)
    err = launch_on(y.device, lambda stream: fwd(
        y.data_ptr(), inv.data_ptr(), bias.data_ptr(), out.data_ptr(), m, c, g,
        int(y.dtype == torch.bfloat16), act, stream, ctypes.byref(path)))
    if err != 0:
        raise RuntimeError(f"bn_act: forward launch failed with CUDA error {err}")
    bn_act.launches += 1
    bn_act.last_path = ("scalar", "vector")[path.value]
    return out


def _launch_backward(dout: torch.Tensor, y: torch.Tensor, inv: torch.Tensor,
                     bias: torch.Tensor, act: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    m, c = _check(y)
    inv, bias = _pair(y, inv, bias)
    if dout.shape != y.shape or dout.dtype != y.dtype:
        raise ValueError(f"bn_act: the gradient is {dout.dtype} {tuple(dout.shape)}, "
                         f"the activation {y.dtype} {tuple(y.shape)}")
    if not dout.is_contiguous():
        dout = dout.contiguous()
        bn_act.layout_copies += 1
    dy = torch.empty_like(y, memory_format=torch.contiguous_format)
    sums = torch.empty((2, c), dtype=torch.float32, device=y.device)
    if m == 0:
        sums.zero_()
        return dy, sums[0], sums[1]
    g = row_blocks(m, c, vector_width(c, y.element_size(), _address(dout, y, dy)), backward=True)
    _, bwd = _kernels()
    path = ctypes.c_int(-1)

    def call(stream: int) -> int:
        ws, slots = _workspace(y.device, stream, c, 2 * g * c)
        return bwd(dout.data_ptr(), y.data_ptr(), inv.data_ptr(), bias.data_ptr(), dy.data_ptr(),
                   ws.data_ptr(), slots, sums.data_ptr(), m, c, g,
                   int(y.dtype == torch.bfloat16), act, stream, ctypes.byref(path))

    err = launch_on(y.device, call)
    if err != 0:
        raise RuntimeError(f"bn_act: backward launch failed with CUDA error {err}")
    bn_act.backward_launches += 1
    bn_act.last_backward_path = ("scalar", "vector")[path.value]
    return dy, sums[0], sums[1]


def bn_act_reference(y: torch.Tensor, inv: torch.Tensor, bias: torch.Tensor,
                     activation: str) -> torch.Tensor:
    """Plain PyTorch version of the forward, differentiable by autograd: the
    pair cast to y's dtype before the multiply (`layers.bn_normalize`), then
    `layers._activate`."""
    from .layers import _activate, bn_normalize

    return _activate(bn_normalize(y, inv, bias), activation)


def bn_act_backward_reference(dout: torch.Tensor, y: torch.Tensor, inv: torch.Tensor,
                              bias: torch.Tensor, activation: str):
    """Plain PyTorch version of the backward, (dy, dinv, dbias): the
    operations autograd runs on `bn_act_reference`, in its order, so the
    values are autograd's bit for bit. With g the gradient at z
    (`grad_at_z`), dy = g * inv, and the pair's gradients are the sums of
    g * y and of g over the leading axes in y's dtype, then float32."""
    g = grad_at_z(dout, y, inv, bias, activation)
    axes = tuple(range(y.ndim - 1))
    return g * inv.to(y.dtype), (g * y).sum(axes).float(), g.sum(axes).float()


def grad_at_z(dout: torch.Tensor, y: torch.Tensor, inv: torch.Tensor, bias: torch.Tensor,
              activation: str) -> torch.Tensor:
    """The gradient at z = y*inv + bias (the pair cast to y's dtype) as
    autograd forms it from `dout`: leaky's two `where` backwards and the
    scalar product's, summed; relu's `threshold_backward`; linear's dout."""
    if activation not in _CODES:
        return dout
    z = y * inv.to(y.dtype) + bias.to(y.dtype)
    if activation == "relu":
        return torch.where(z > 0, dout, 0)
    mask = z >= 0
    return torch.where(mask, dout, 0) + torch.where(mask, 0, dout * 0.1)


class _BnAct(torch.autograd.Function):
    """(y contiguous (..., C), inv, bias float32 (C,)) -> act(y*inv + bias);
    saves y, inv and bias for the backward."""

    @staticmethod
    def forward(ctx, y, inv, bias, activation):
        ctx.save_for_backward(y, inv, bias)
        ctx.activation = activation
        if y.device.type == "cpu":
            return bn_act_reference(y, inv, bias, activation)
        return _launch_forward(y, inv, bias, activation_code(activation))

    @staticmethod
    def backward(ctx, dout):
        y, inv, bias = ctx.saved_tensors
        if y.device.type == "cpu":
            dy, dinv, dbias = bn_act_backward_reference(dout, y, inv, bias, ctx.activation)
        else:
            dy, dinv, dbias = _launch_backward(dout, y, inv, bias, activation_code(ctx.activation))
        return dy, dinv, dbias, None


def bn_act(y: torch.Tensor, inv: torch.Tensor, bias: torch.Tensor, activation: str) -> torch.Tensor:
    """act(y * inv + bias) per channel, differentiable in all three.

    y (..., C) float32 or bfloat16; inv, bias float32 (C,). A CUDA tensor
    goes to the kernels (built at first use; any failure to build, load or
    launch raises); a CPU tensor goes to the plain versions.
    `bn_act.launches` and `bn_act.backward_launches` count kernel launches;
    `bn_act.layout_copies` counts inputs and gradients that had to be copied
    into row-major order first."""
    _check(y)
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_act: unsupported device {y.device}")
    if not y.is_contiguous():
        y = y.contiguous()
        bn_act.layout_copies += 1
    return _BnAct.apply(y, inv, bias, activation)


bn_act.launches = 0
bn_act.backward_launches = 0
bn_act.layout_copies = 0
bn_act.last_path = None
bn_act.last_backward_path = None
