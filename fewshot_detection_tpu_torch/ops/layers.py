"""Core stateless layer ops on NHWC tensors.

Inference-time layers of the darknet executor. Tensors are NHWC at every
function boundary, as in the JAX package; the pooling ops hand PyTorch a
permuted NCHW *view* of the same memory (which PyTorch sees as a
`channels_last` tensor), so no layout copy is made in either direction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


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
    """Standard max pooling, floor semantics (torch MaxPool2d default)."""
    return _pool_nhwc(x, size, stride)


def maxpool_stride1(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-1 maxpool with replicate pad right/bottom.

    Keeps spatial dims; matches MaxPoolStride1
    (reference darknet_meta.py:47-53).
    """
    x = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1), mode="replicate")
    return F.max_pool2d(x, 2, 1).permute(0, 2, 3, 1)


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
