"""The int8 product of the serving path: int8 x int8 -> int32.

The JAX package's int8 convolutions and its int8 fused reweight+head
(`models/quant.py:conv_int8`, `models/meta.py:fused_reweight_head_int8`) run
`lax.conv_general_dilated` and `einsum` with `preferred_element_type=int32`
in XLA, outside any Pallas kernel. Here each of them is one matrix product
A (M, K) x W^T with W (N, K): a 1x1 convolution is the NHWC activation as it
lies, a larger one an im2col in (kh, kw, cin) order (the order of the JAX
package's HWIO weights), and the fused head the (B*H*W, C) activation
against the sweep's effective weight.

On a CUDA tensor `int8_matmul` calls `torch._int_mm` (cuBLASLt's int8
tensor-core product on sm_90) with W's transposed view, and counts the call
in `int8_matmul.launches`. `_int_mm` takes M > 16 and K, N multiples of 8: a
product outside that is padded with zero rows or columns and the result
sliced (zeros add nothing to an integer sum). It never falls back to a float
product. On a CPU tensor it runs the plain version, `int8_matmul_reference`,
an int64 product: exact, as |sum| <= 127 * 127 * K stays in int32 for every
K below 133,000.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm on CUDA: M > 16, K and N multiples of 8
MIN_ROWS = 17
MULTIPLE = 8


def _check(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8, got {a.dtype} and {w.dtype}")
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(
            f"int8_matmul takes a (M, K) and w (N, K), got {tuple(a.shape)} and {tuple(w.shape)}")
    if a.device != w.device:
        raise ValueError(f"a on {a.device} but w on {w.device}")


def _pad_to(n: int, multiple: int) -> int:
    return -n % multiple


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ w (N, K).T int8 -> (M, N) int32, summed exactly.

    A CUDA tensor goes to `torch._int_mm` (padded to its shape rules); a CPU
    tensor to the plain version."""
    _check(a, w)
    if a.device.type == "cpu":
        return int8_matmul_reference(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    out = padded_int_mm(a, w)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def padded_int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm(a, w.t())`, with a and w padded with zeros to its
    shape rules and the result sliced back to (M, N)."""
    m, k = a.shape
    n = w.shape[0]
    pk, pn = _pad_to(k, MULTIPLE), _pad_to(n, MULTIPLE)
    pm = max(MIN_ROWS - m, 0)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if pm or pn else out


def int8_matmul_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `int8_matmul`: an int64 product, cast to int32."""
    _check(a, w)
    return torch.matmul(a.to(torch.int64), w.to(torch.int64).t()).to(torch.int32)


def im2col(xq: torch.Tensor, size: int, stride: int, pad: int):
    """(B, H, W, C) -> ((B*Ho*Wo, size*size*C) rows in (kh, kw, c) order,
    (B, Ho, Wo)). A 1x1 stride-1 unpadded window is the input as it lies;
    otherwise `F.pad`, two `Tensor.unfold` views and one copy (`F.unfold`
    has no int8 CUDA kernel)."""
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    b, _, _, c = xq.shape
    if size == 1 and stride == 1:
        return xq.reshape(-1, c), tuple(xq.shape[:3])
    cols = xq.unfold(1, size, stride).unfold(2, size, stride)  # (B, Ho, Wo, C, kh, kw)
    ho, wo = cols.shape[1], cols.shape[2]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, size * size * c), (b, ho, wo)
