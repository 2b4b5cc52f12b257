"""Core stateless layer ops on NHWC tensors.

Layers of the darknet executor, at inference and in training. Tensors are
NHWC at every function boundary, as in the JAX package; the pooling ops that
PyTorch computes see a permuted NCHW *view* of the same memory (which PyTorch
sees as a `channels_last` tensor), so no layout copy is made in either
direction. Training BatchNorm takes its statistics from the `bn_sums` kernel
(`ops/bn_sums.py`), not from `F.batch_norm`, and its normalise + activation
epilogue from the `bn_act` kernel (`ops/bn_act.py`); 2x2 stride-2 max pools
go to the `maxpool2x2` kernels (`ops/pool2x2.py`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .bn_act import bn_act
from .bn_sums import bn_sums
from .pool2x2 import maxpool2x2, takes as maxpool2x2_takes

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch nn.BatchNorm2d default, what the reference trained with


def bn_train_config() -> tuple[float, bool]:
    """(running-stat momentum, use-unbiased-variance-in-running-update).

    Default: torch nn.BatchNorm2d semantics — momentum 0.1, unbiased
    variance in the running update (the reference trained with torch BN).

    FSD_BN_DARKNET=1 selects the darknet extension's semantics instead
    (batchnorm.c:196-203: rolling = .99*rolling + .01*batch_stat with the
    BIASED batch variance) — for continuing/serving .weights files whose
    running stats were produced by that extension. The normalization math
    itself (biased batch stats, eps 1e-5) is identical in both modes. The
    variable is read at every call.
    """
    if os.environ.get("FSD_BN_DARKNET") == "1":
        return 0.01, False
    return BN_MOMENTUM, True


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return leaky_relu(x, 0.1)
    if activation == "relu":
        return torch.relu(x)
    return x


def reorg(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Darknet-fork reorg: (B, H, W, C) -> (B, H/s, W/s, s*s*C).

    Output channel layout is ``(hi*s + wj)*C + c`` for input pixel offset
    (hi, wj) within each s x s tile — the permutation of the reference's
    view/transpose chain (reference darknet_meta.py:55-74), which is NOT
    darknet-C's reorg and NOT `torch.pixel_unshuffle` (that one puts the
    channel index first: ``c*s*s + hi*s + wj``).
    """
    b, h, w, c = x.shape
    s = stride
    if h % s or w % s:
        raise ValueError(f"reorg: spatial dims {(h, w)} not divisible by {s}")
    x = x.reshape(b, h // s, s, w // s, s, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, H/s, W/s, hi, wj, C)
    return x.reshape(b, h // s, w // s, s * s * c)


def _pool_nhwc(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), size, stride).permute(0, 2, 3, 1)


def maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Standard max pooling, floor semantics (torch MaxPool2d default). A 2x2
    stride-2 pool goes to `maxpool2x2` (the kernels on the card, the plain
    version on the CPU: `F.max_pool2d`'s values and gradients), any other to
    `F.max_pool2d`."""
    if size == 2 and stride == 2 and maxpool2x2_takes(x):
        return maxpool2x2(x)
    return _pool_nhwc(x, size, stride)


def maxpool_stride1(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-1 maxpool with replicate pad right/bottom.

    Keeps spatial dims; matches MaxPoolStride1
    (reference darknet_meta.py:47-53).
    """
    x = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1), mode="replicate")
    return F.max_pool2d(x, 2, 1).permute(0, 2, 3, 1)


def upsample_nearest(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Nearest-neighbour upsampling by `stride` of NHWC x (darknet's
    [upsample]): output pixel (y, x) is input pixel (y // stride, x //
    stride). The interpolation sees the channels-last view, so its output
    is NHWC memory again."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=stride,
                         mode="nearest").permute(0, 2, 3, 1)


def space_to_depth(x: torch.Tensor, s: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/s, W/s, s*s*C), channel layout (v*s+u)*C + c
    for pixel offset (v, u) inside each s x s block (the layout of `reorg`)."""
    b, h, w, c = x.shape
    if h % s or w % s:
        raise ValueError(f"space_to_depth: dims {(h, w)} not divisible by {s}")
    x = x.reshape(b, h // s, s, w // s, s, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)


def _s2d_selector() -> np.ndarray:
    """Constant T[R,S,pi,po,a,b] mapping tap (a,b) of a 3x3 stride-1 conv
    into tap (R,S) of the equivalent conv on space-to-depth(2) input, for
    input phase pi=(vi,ui) and output phase po=(v,u). Output row 2i+v reads
    input row 2i+v+dr (dr=a-1); the s2d tap (i+R-1, phase vi) holds input
    row 2(i+R-1)+vi, so dr = 2R-2+vi-v (and likewise for columns)."""
    t = np.zeros((3, 3, 4, 4, 3, 3), np.float32)
    for R, S, vi, ui, v, u in np.ndindex(3, 3, 2, 2, 2, 2):
        dr, ds = 2 * R - 2 + vi - v, 2 * S - 2 + ui - u
        if -1 <= dr <= 1 and -1 <= ds <= 1:
            t[R, S, vi * 2 + ui, v * 2 + u, dr + 1, ds + 1] = 1.0
    return t


_S2D_T = _s2d_selector()


def s2d_stem_weight(w: torch.Tensor) -> torch.Tensor:
    """Lift a (K, C, 3, 3) stride-1 conv weight (OIHW) to the equivalent
    (4K, 4C, 3, 3) weight on space-to-depth(2) input, where output channel
    block po holds the conv result at pixel phase po of the original grid.
    An einsum with the constant 0/1 selector (each tap takes one weight or
    none, so it is exact), through which gradients reach the 3x3 weight."""
    k, c, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError("s2d stem expects a 3x3 kernel")
    t = torch.as_tensor(_S2D_T, dtype=w.dtype, device=w.device)
    return torch.einsum("RSpqab,kcab->qkpcRS", t, w).reshape(4 * k, 4 * c, 3, 3)


def stem_s2d_conv_pool(
    x: torch.Tensor,
    w: torch.Tensor,
    bn: dict | None,
    activation: str,
    bias: torch.Tensor | None,
    train: bool,
) -> tuple[torch.Tensor, dict | None]:
    """conv3x3(s1,p1) + [BN] + [activation] + maxpool(2,2) on (B, H, W, C),
    computed as a conv on the space-to-depth input whose output holds the
    four pool-window phases as channel blocks, (B, H/2, W/2, 4, K). BN
    normalises per original channel over the phase axis too (training BN
    reaches `bn_sums` at M = B*H*W, C = K, as the plain stem's conv output
    does), and the pool is the max over the phase axis. The same function as
    the plain stem, reassociated. In eager PyTorch the 5-D conv output has
    as many elements as the plain stem's, so it saves no activation memory;
    it exists for parity with the JAX package's `s2d` option."""
    b, h, wd, _ = x.shape
    k = w.shape[0]
    xs = space_to_depth(x, 2)
    ws = s2d_stem_weight(w)
    y = F.conv2d(xs.permute(0, 3, 1, 2), ws.to(xs.dtype), None, 1, 1).permute(0, 2, 3, 1)
    y = y.reshape(b, h // 2, wd // 2, 4, k)
    new_stats = None
    if bn is not None and train:
        y, new_stats = bn_train_activate(y, bn, activation)
    else:
        if bn is not None:
            y = batchnorm_apply(y, bn)
        elif bias is not None:
            y = y + bias.to(y.dtype)
        y = _activate(y, activation)
    return torch.amax(y, dim=3), new_stats


def global_maxpool(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 1, 1, C) max over spatial dims."""
    return torch.amax(x, dim=(1, 2), keepdim=True)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 1, 1, C) mean over spatial dims."""
    return torch.mean(x, dim=(1, 2), keepdim=True)


def batchnorm_apply(x: torch.Tensor, bn: dict) -> torch.Tensor:
    """Inference BN with running statistics. The affine pair is computed in
    the parameters' float32 and cast to x's dtype BEFORE the multiply, the
    same place the JAX package casts, so bf16 results round alike."""
    inv = torch.rsqrt(bn["var"] + BN_EPS) * bn["gamma"]
    bias = bn["beta"] - bn["mean"] * inv
    return x * inv.to(x.dtype) + bias.to(x.dtype)


def bn_train_affine(x: torch.Tensor, bn: dict) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Batch statistics of x (..., C) -> (inv, bias, new_stats): the float32
    per-channel affine pair that normalizes x with its biased batch
    statistics, and the updated running statistics (detached). The sums come
    from `bn_sums` (float32 accumulation; the CUDA kernel on the card), so
    gradients reach x through the kernel's backward."""
    n = x.numel() // x.shape[-1]
    s, q = bn_sums(x)
    mean = s / n
    var = q / n - torch.square(mean)
    inv = torch.rsqrt(var + BN_EPS) * bn["gamma"]
    bias = bn["beta"] - mean * inv
    momentum, use_unbiased = bn_train_config()
    with torch.no_grad():
        running_var = var * (n / max(n - 1, 1)) if use_unbiased else var
        new_stats = {
            "mean": (1 - momentum) * bn["mean"] + momentum * mean,
            "var": (1 - momentum) * bn["var"] + momentum * running_var,
        }
    return inv, bias, new_stats


def bn_normalize(x: torch.Tensor, inv: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x * inv + bias with the pair cast to x's dtype BEFORE the multiply."""
    return x * inv.to(x.dtype) + bias.to(x.dtype)


def batchnorm_train(x: torch.Tensor, bn: dict) -> tuple[torch.Tensor, dict]:
    """Training BN: normalize with biased batch stats, return updated
    running stats (unbiased var in the running update — torch semantics,
    or the darknet extension's with FSD_BN_DARKNET=1)."""
    inv, bias, new_stats = bn_train_affine(x, bn)
    return bn_normalize(x, inv, bias), new_stats


def bn_train_activate(y: torch.Tensor, bn: dict, activation: str) -> tuple[torch.Tensor, dict]:
    """Training BN + activation on a conv output; returns (out, new stats).

    The statistics come from `bn_sums`, the normalise + activation epilogue
    from `bn_act`, whose backward rebuilds the normalised values from the
    conv output and the pair it keeps: the epilogue saves no tensor of its
    own, which is what the JAX trainer's rematerialization saves too."""
    inv, bias, new_stats = bn_train_affine(y, bn)
    return bn_act(y, inv, bias, activation), new_stats
