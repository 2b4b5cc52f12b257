"""Per-channel sum and sum of squares for training BatchNorm: CUDA kernels
with a backward, and their plain versions.

Counterpart of the JAX package's `ops/bn_pallas.py`: `bn_sums(x)` replaces
the TPU kernel `_sums_kernel` (reached through `_sums_pallas_2d`) and the
elementwise backward of its custom VJP. The kernel source is
`csrc/bn_sums.cu`; `ops/_build.py` compiles it with `nvcc` for sm_90a at
first use and loads it with `ctypes`.

Bound on an H100: bytes. The forward reads the (M, C) activation once
(M*C*itemsize) and writes 2*C floats; the backward reads it once and writes
as much. What holds a forward back on this card is the size of its loads and
the host's cost per call, so the design is: 16-byte loads (a thread owns 4
float32 or 8 bfloat16 adjacent channels, `_VEC_LANES` neighbouring threads
cover a channel tile, the rest of the warp takes further rows), four loads a
thread in flight, float32 sums in a fixed order, and ONE launch a call: every
block writes its row of a (G, 2, C) table of partials and draws a ticket from
an integer counter, and the block that draws the last ticket of its channel
tile folds the table. No float atomics, so the result does not change from
run to run. That vector path needs C % (16 / itemsize) == 0 and a 16-byte
aligned base; any other input takes the scalar path of the same file (one
value a thread), chosen by the library on shape and alignment alone and
reported in `bn_sums.last_path`.

The table and the tickets live in a workspace that is allocated once per
device and stream and then reused; `out` is the only allocation of a call.
Reuse is safe because launches on one stream run one after the other: the
next launch writes the table only after this launch's fold has read it, and
the fold leaves the tickets at 0. A call on a second stream gets a workspace
of its own (keyed by the stream's handle), so calls on two streams never
share one and need no ordering between them. Workspaces are small (half a
megabyte) and are kept for the life of the process.

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

from ._build import launch_on, load_library

# threads of a block along the channels and along the rows (csrc/bn_sums.cu)
_TX, _TY = 32, 8
# scalar geometry (backward, scalar forward): 132 SMs x 8 blocks of 256 threads
_SCALAR_RESIDENT = 132 * 8
# vector forward: 132 SMs x 4 blocks (up to 64 registers a thread), and a
# pass of a block is 4 loads a thread
_VECTOR_RESIDENT = 132 * 4
_UNROLL = 4
# threads across one channel tile on the vector path (csrc/bn_sums.cu:LANES):
# 8 x 16 bytes is one 128-byte line of a row; narrow tiles keep the table of
# partials that the last block of a tile folds small
_VEC_LANES = 8
_DTYPES = (torch.float32, torch.bfloat16)
# values one float32 accumulator of the forward takes at most. A longer
# chain rounds further: at (66,453,504, 32) bfloat16 one wave of blocks gives
# a chain 984 values, and the sums on an H100 fell outside 2e-6 of sum|x|;
# at 512 values a chain they were within 1.2e-6
_MAX_CHAIN = 512
# ticket counters at the head of a workspace, and floats of partials after them
_TICKET_SLOTS = 64
_WORKSPACE_FLOATS = 1 << 17

_fns = None
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}


def _kernels():
    """(`fsd_bn_sums_fwd`, `fsd_bn_sums_bwd`) of csrc/bn_sums.cu, built and
    loaded on first use."""
    global _fns
    if _fns is None:
        lib = load_library("bn_sums")
        fwd, bwd = lib.fsd_bn_sums_fwd, lib.fsd_bn_sums_bwd
        fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


def vector_width(c: int, itemsize: int, address: int = 0) -> int:
    """Channels a thread of the forward owns: 16 / itemsize on the vector
    path (C a multiple of that, base 16-byte aligned), else 1. The library
    applies the same rule when it picks its kernel."""
    v = 16 // itemsize
    return v if c % v == 0 and address % 16 == 0 else 1


def row_blocks(m: int, c: int, vec: int = 1, forward: bool = False) -> int:
    """Blocks along the rows (the kernels' grid.y, and the rows of the
    forward's table of partials): enough to fill the card once, never more
    than there are rows to hand out. `vec` is the channels a thread owns: 1
    for the backward and the scalar forward, `vector_width` for the vector
    forward, whose blocks take `_UNROLL` loads a thread in one pass.

    `forward=True` also keeps every float32 accumulator of the forward to
    `_MAX_CHAIN` values: a tall input gets more blocks (further waves) and
    so fewer passes a block. A vector thread adds two values a pass to each
    of its two accumulators; a scalar thread rotates four accumulators, one
    value a pass."""
    cv = c // vec
    cw = min(cv, _TX if vec == 1 else _VEC_LANES)
    fold = _TX // cw
    tiles = -(-cv // cw)
    rows = _TY * fold * (1 if vec == 1 else _UNROLL)
    resident = _SCALAR_RESIDENT if vec == 1 else _VECTOR_RESIDENT
    g = max(1, min(-(-m // rows), -(-resident // tiles), 65535))
    if forward:
        passes = 4 * _MAX_CHAIN if vec == 1 else _MAX_CHAIN // 2
        g = min(max(g, -(-m // (rows * passes))), 65535)
    return g


def _workspace(device: torch.device, stream: int, c: int, floats: int) -> tuple[torch.Tensor, int]:
    """(this device's and stream's workspace, its ticket slots): zeroed int32
    storage, tickets first, made on first use and made anew only when a call
    needs more than it holds. Called with `device` current and `stream` its
    current stream, so the zeroing runs on that stream too."""
    slots = max(_TICKET_SLOTS, -(-(-(-c // _TX)) // 4) * 4)
    key = (device.index, stream)
    held = _workspaces.get(key)
    if held is None or held[1] < slots or held[0].numel() < slots + floats:
        size = slots + max(floats, _WORKSPACE_FLOATS)
        held = (torch.zeros(size, dtype=torch.int32, device=device), slots)
        _workspaces[key] = held
    return held


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
    g = row_blocks(m, c, vector_width(c, x.element_size(), x.data_ptr()), forward=True)
    fwd, _ = _kernels()
    path = ctypes.c_int(-1)

    def call(stream: int) -> int:
        ws, slots = _workspace(x.device, stream, c, 2 * g * c)
        return fwd(x.data_ptr(), ws.data_ptr(), slots, out.data_ptr(), m, c, g,
                   int(x.dtype == torch.bfloat16), stream, ctypes.byref(path))

    err = launch_on(x.device, call)
    if err != 0:
        raise RuntimeError(f"bn_sums: forward launch failed with CUDA error {err}")
    bn_sums.launches += 1
    bn_sums.last_path = ("scalar", "vector")[path.value]
    return out[0], out[1]


def _launch_backward(x: torch.Tensor, dsum: torch.Tensor, dsq: torch.Tensor) -> torch.Tensor:
    m, c = _check(x)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if m == 0:
        return dx
    dsum = dsum.to(torch.float32).contiguous()
    dsq = dsq.to(torch.float32).contiguous()
    _, bwd = _kernels()
    err = launch_on(x.device, lambda stream: bwd(
        x.data_ptr(), dsum.data_ptr(), dsq.data_ptr(), dx.data_ptr(), m, c,
        row_blocks(m, c), int(x.dtype == torch.bfloat16), stream))
    if err != 0:
        raise RuntimeError(f"bn_sums: backward launch failed with CUDA error {err}")
    bn_sums.backward_launches += 1
    return dx


def bn_sums_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `bn_sums`: the sums over all leading axes
    taken in float64 and rounded once to float32. A float32 `torch.sum`
    rounds far enough that `var = q/n - mean^2` loses digits the JAX
    package's reduction keeps on nearly flat activations."""
    _check(x)
    xd = x.double()
    axes = tuple(range(x.ndim - 1))
    if not axes:
        return x.float().clone(), (xd * xd).float()
    return xd.sum(dim=axes).float(), (xd * xd).sum(dim=axes).float()


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
    `bn_sums.backward_launches` count kernel launches;
    `bn_sums.layout_copies` counts inputs that had to be copied into
    row-major order first."""
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
bn_sums.last_path = None
