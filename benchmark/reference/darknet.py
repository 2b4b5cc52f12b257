"""Forward pass of a darknet graph, the learnet and the reweighted head.

Parameters: one dict a layer index, `{"w": (O, I, k, k), "b": (O,)}` for
a conv without batch norm, `{"w", "gamma", "beta", "mean", "var"}` with
it; a dynamic conv has no entry. Activations are NCHW inside and NHWC at
the boundary. Training batch norm is `F.batch_norm(training=True)`:
biased batch statistics normalise, and the running statistics move in
place by 0.1 towards the batch mean and the unbiased batch variance
(PyTorch's `nn.BatchNorm2d`, which the authors trained with).

`dtype` is the type the configuration computes in. In float32 every
operation is float32 (TF32 off). In bfloat16 the images, every weight as a
product takes it, every convolution's output and every activation are
bfloat16, as the configuration states: a convolution accumulates in
float32 and rounds its output once; batch norm takes its statistics in
float32 over the bfloat16 values, forms its affine pair in float32 and
rounds the pair to bfloat16 before it multiplies; the running statistics
and the master weights stay float32.

`precision` other than "fp32" computes below `dtype`, the control of
`correct`: the operands of every convolution's three products (its input,
its weight, the gradient of its output) and every activation the layer
holds (the convolution's output, batch norm's, the leaky unit's) are
rounded to `precision`, their gradients too on the way back; the sums and
the batch statistics stay float32.

Departures from the published code, all of arithmetic order only: the
dynamic 1x1 depthwise conv followed by the 1x1 head conv is one
convolution whose weight is the head's times each class's code (formed in
float32, then taken in `dtype`), and the learnet's codes come out as an
(N, C) matrix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LEAKY = 0.1


def _round(t: torch.Tensor, precision: str, grad: bool = False) -> torch.Tensor:
    """t rounded to `precision` (a gradient with `grad`), back in t's type."""
    if t.dtype != torch.float32:
        return _round(t.float(), precision, grad).to(t.dtype)
    if precision == "tf32":
        bits = t.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF  # to nearest at 10 mantissa bits
        return bits.view(torch.float32)
    if precision == "fp8":
        # e4m3 for values, e5m2 for gradients, one scale a tensor (the
        # usual recipe of fp8 training)
        fmt, top = (torch.float8_e5m2, 57344.0) if grad else (torch.float8_e4m3fn, 448.0)
        scale = t.abs().amax().clamp(min=1e-30) / top
        return (t / scale).to(fmt).float() * scale
    if precision == "int8":
        # symmetric, one scale a tensor
        scale = t.abs().amax().clamp(min=1e-30) / 127.0
        return torch.clamp(torch.round(t / scale), -127, 127) * scale
    raise ValueError(f"unknown precision {precision!r}")


class _Operand(torch.autograd.Function):
    """A product's operand rounded; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, t, precision):
        return _round(t, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradOperand(torch.autograd.Function):
    """A product's output unchanged; its gradient, the operand of the two
    backward products, rounded."""

    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision, grad=True), None


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    return t if precision == "fp32" else _Operand.apply(t, precision)


def grad_rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    return t if precision == "fp32" else _GradOperand.apply(t, precision)


def stored(t: torch.Tensor, precision: str) -> torch.Tensor:
    """An activation held at `precision`: its value rounded, and its
    gradient rounded on the way back."""
    return grad_rounded(rounded(t, precision), precision)


def _move(p: dict, var: torch.Tensor, mean: torch.Tensor, y: torch.Tensor) -> None:
    """The running statistics moved by 0.1 towards the batch mean and the
    unbiased batch variance, as `F.batch_norm` moves them."""
    n = y.numel() // y.shape[1]
    p["mean"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
    p["var"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / max(n - 1, 1)))


def _batch_norm(y: torch.Tensor, p: dict, train: bool, moved: set | None) -> torch.Tensor:
    """Batch norm of NCHW y. In float32, `F.batch_norm`. Below it, the
    statistics in float32 over y's values, the affine pair in float32
    rounded to y's type, the running statistics moved as `F.batch_norm`
    moves them (by 0.1 towards the batch mean and unbiased variance).
    With `moved`, a layer recomputed in the backward moves its running
    statistics once: the ids of the layers that moved them are kept there."""
    once = train and moved is not None
    move = train and not (once and id(p) in moved)
    if once:
        moved.add(id(p))
    if y.dtype == torch.float32 and not once:
        return F.batch_norm(y, p["mean"], p["var"], p["gamma"], p["beta"], training=train,
                            momentum=BN_MOMENTUM, eps=BN_EPS)
    if y.dtype == torch.float32:
        if move:
            with torch.no_grad():
                _move(p, *torch.var_mean(y, dim=(0, 2, 3), correction=0), y)
        return F.batch_norm(y, None, None, p["gamma"], p["beta"], training=True, eps=BN_EPS)
    if train:
        var, mean = torch.var_mean(y.float(), dim=(0, 2, 3), correction=0)
        if move:
            with torch.no_grad():
                _move(p, var, mean, y)
    else:
        mean, var = p["mean"], p["var"]
    inv = torch.rsqrt(var + BN_EPS) * p["gamma"]
    bias = p["beta"] - mean * inv
    return y * inv.to(y.dtype)[None, :, None, None] + bias.to(y.dtype)[None, :, None, None]


def _conv(layer, p, x, train: bool, precision: str, codes=None, moved=None):
    """conv [+ BN | + bias] [+ leaky] of NCHW x in x's type. With `codes`
    (n_cls, C), x is first reweighted by each class's code: the weight
    becomes (n_cls * O, C, 1, 1) and the output (B * n_cls, O, H, W)."""
    w = p["w"]
    if codes is not None:
        w = (w[None, :, :, 0, 0] * codes.float()[:, None, :]).reshape(-1, w.shape[1], 1, 1)
    y = F.conv2d(rounded(x, precision), rounded(w.to(x.dtype), precision), None, layer.stride,
                 layer.pad)
    if codes is not None:
        y = y.reshape(y.shape[0] * codes.shape[0], -1, *y.shape[2:])
    y = stored(y, precision)
    if layer.bn:
        y = stored(_batch_norm(y, p, train, moved), precision)
    else:
        y = y + p["b"].to(y.dtype)[None, :, None, None]
    if layer.activation == "leaky":
        y = stored(F.leaky_relu(y, LEAKY), precision)
    return y


def _reorg(x: torch.Tensor, s: int) -> torch.Tensor:
    """The authors' reorg: output channel (i*s + j)*C + c holds input pixel
    (s*y + i, s*x + j) of channel c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h // s, w // s)


def _folds(layers, i: int) -> bool:
    """Whether the dynamic conv at i folds into the next layer: a 1x1
    conv without batch norm that reads only it."""
    nxt = layers[i + 1] if i + 1 < len(layers) else None
    return (nxt is not None and nxt.kind == "conv" and not nxt.dynamic and nxt.size == 1
            and not nxt.bn and all(l.kind != "route" or layers[i].index not in l.sources
                                   for l in layers[i + 2:]))


def forward(layers, params: dict, x: torch.Tensor, *, train: bool, codes=None,
            precision: str = "fp32", recompute: bool = False) -> torch.Tensor:
    """Run a net on NHWC x, in x's type. With `codes` (n_cls, C) the first
    dynamic conv reweights each image's features by every class's code,
    image-major (row b*n_cls + j is image b under class j). Returns the
    last output, NHWC ((N, C) after a global max pool). `recompute` keeps
    only each convolution's input for the backward and computes the layer
    again there, so that a large batch fits; the values are the same."""
    x = x.permute(0, 3, 1, 2)
    outs: dict = {}
    pending = None
    moved = set() if recompute else None
    for i, layer in enumerate(layers):
        if layer.kind == "conv" and layer.dynamic and _folds(layers, i):
            pending = codes
        elif layer.kind == "conv" and layer.dynamic:
            b, c, h, w = x.shape
            n = codes.shape[0]
            x = (x[:, None] * codes.to(x.dtype)[None, :, :, None, None]).reshape(b * n, c, h, w)
        elif layer.kind == "conv":
            args = (layer, params[layer.index], x, train, precision, pending, moved)
            x = checkpoint(_conv, *args, use_reentrant=False) if recompute else _conv(*args)
            pending = None
        elif layer.kind == "maxpool":
            if layer.stride == 1:
                x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), mode="replicate"), layer.size, 1)
            else:
                x = F.max_pool2d(x, layer.size, layer.stride)
        elif layer.kind == "reorg":
            x = _reorg(x, layer.stride)
        elif layer.kind == "route":
            parts = [outs[s] for s in layer.sources]
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        elif layer.kind == "globalmax":
            x = torch.amax(x, dim=(2, 3), keepdim=True)
        outs[layer.index] = x
    if x.shape[-1] == 1 and x.shape[-2] == 1 and layers[-1].kind == "globalmax":
        return x.reshape(x.shape[0], -1)
    return x.permute(0, 2, 3, 1)


def meta_forward(darknet, learnet, params: dict, x, metax, mask, *, train: bool,
                 precision: str = "fp32", recompute: bool = False) -> torch.Tensor:
    """The meta detector on a batch and its support set: the learnet on
    the supports with their masks as a fourth channel, its codes reweight
    the backbone's features, the head gives (B*n_cls, H, W, A*(5+1))."""
    codes = forward(learnet, params["learnet"], torch.cat([metax, mask], dim=-1),
                    train=train, precision=precision, recompute=recompute)
    return forward(darknet, params["darknet"], x, train=train, codes=codes, precision=precision,
                   recompute=recompute)
