"""Post-training int8 quantization for the serving path (the port's copy of
the JAX package's models/quant.py).

The folded inference graph (conv+bias+leaky after fold_batchnorm) is
quantized as the JAX package does it:

  * weights: symmetric per-output-channel int8, scale = absmax/127 (0 -> 1),
    from the FOLDED weights, so BN is inside the scales
  * activations: symmetric per-tensor int8, the scale calibrated as the
    running absmax of each conv's input over calibration batches
  * an int8 x int8 product summed in int32 (`ops/int8_mm.py`), dequantized
    as y * (sx * wscale) + b in float32, then the activation, cast back to
    the input's dtype
  * the stem conv (fewer than 8 input channels) and the detection head (the
    last static conv) stay in the compute dtype

The JAX package serves through `jax.jit` with the activation scales baked
in as constants, and XLA rewrites a division by a constant as a product
with its float32 reciprocal. Its codes are therefore round(x * (1/sx)), and
so are the port's: `act_scale_inverse` makes the reciprocal once on the
host, and the same float32 product gives the same codes on the CPU and on
the card (PyTorch's CUDA division by a Python scalar, a reciprocal product
of its own, is never used).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.int8_mm import im2col, int8_matmul
from ..ops.layers import _activate
from .darknet import apply_network
from .spec import LayerSpec, NetSpec

QMAX = 127


def _is_quantizable(spec: NetSpec, layer: LayerSpec) -> bool:
    """Static convs between the stem and the head, on the folded graph."""
    if layer.kind != "conv" or layer.dynamic or layer.groups != 1:
        return False
    if layer.in_channels < 8:
        return False  # the 3-channel stem stays in the compute dtype
    last_conv = max(
        (l.index for l in spec.layers if l.kind == "conv" and not l.dynamic),
        default=-1,
    )
    return layer.index != last_conv  # the head stays in the compute dtype


def quantize_weights(spec: NetSpec, folded_params: list) -> list:
    """Folded params -> mixed params: quantized convs get {"wq" int8
    (K, kh*kw*cin) in (kh, kw, cin) order, "wscale" float32 (K,), "b"};
    everything else passes through unchanged. The arithmetic is the JAX
    package's, in numpy on the host, on the HWIO weights."""
    out = []
    for layer, p in zip(spec.layers, folded_params):
        if p is None or not _is_quantizable(spec, layer) or "w" not in p:
            out.append(p)
            continue
        dev = p["w"].device
        w = p["w"].detach().to("cpu", torch.float32).numpy().transpose(2, 3, 1, 0)  # HWIO
        scale = np.abs(w).max(axis=(0, 1, 2)) / 127.0
        scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
        wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out.append({
            "wq": torch.from_numpy(np.ascontiguousarray(wq.reshape(-1, wq.shape[-1]).T)).to(dev),
            "wscale": torch.from_numpy(scale).to(dev),
            "b": p.get("b"),
        })
    return out


def act_scale_inverse(sx: float) -> float:
    """float32(1) / float32(sx): the factor XLA multiplies by where the JAX
    package divides by the constant sx."""
    return float(np.float32(1.0) / np.float32(sx))


def quantize_act(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(round(float32(x) * inv), -127, 127) as int8; `inv` a float32
    tensor on x's device (round half to even, as jnp.round)."""
    return torch.clamp(torch.round(x.float() * inv), -QMAX, QMAX).to(torch.int8)


def device_scalar(v, device) -> torch.Tensor:
    """A float32 scalar tensor on `device`: an operand PyTorch takes
    elementwise on the card (a Python scalar or a CPU scalar tensor there
    gets CUDA's own treatment, e.g. a division by a reciprocal product)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def conv_int8(layer: LayerSpec, p: dict, x: torch.Tensor, sx: float) -> torch.Tensor:
    """Quantize x with scale sx, run the int8 conv, dequantize + bias +
    activation (shared by the plain walk and the meta detect path)."""
    xq = quantize_act(x, device_scalar(act_scale_inverse(sx), x.device))
    a, (b, ho, wo) = im2col(xq, layer.size, layer.stride, layer.pad)
    y = int8_matmul(a, p["wq"]).reshape(b, ho, wo, -1)
    y = y.float() * (device_scalar(sx, x.device) * p["wscale"])
    if p.get("b") is not None:
        y = y + p["b"]
    return _activate(y.to(x.dtype), layer.activation)


def absmax_observer(absmax: dict, wanted) -> callable:
    """An `observe(idx, x)` hook that keeps the running max|x| of each
    layer index `wanted(idx)` accepts."""

    def observe(idx, x):
        if wanted(idx):
            m = float(x.float().abs().max())
            absmax[idx] = max(absmax.get(idx, 0.0), m)

    return observe


def scales_from_absmax(absmax: dict) -> dict[int, float]:
    return {k: (v / 127.0 if v > 0 else 1.0) for k, v in absmax.items()}


@torch.no_grad()
def calibrate_act_scales(
    spec: NetSpec, folded_params: list, images, batch: int = 8,
) -> dict[int, float]:
    """Per-quantized-conv-input symmetric scales: absmax/127 over the
    calibration images (float32, on the parameters' device), run through
    the folded float graph."""
    absmax: dict[int, float] = {}
    observe = absmax_observer(absmax, lambda idx: _is_quantizable(spec, spec.layers[idx]))
    dev = next(p["w"].device for p in folded_params if p is not None and "w" in p)
    images = torch.as_tensor(np.asarray(images, np.float32))
    for s in range(0, len(images), batch):
        apply_network(spec, folded_params, images[s:s + batch].to(dev), observe=observe)
    return scales_from_absmax(absmax)


@torch.no_grad()
def apply_network_int8(
    spec: NetSpec, qparams: list, act_scales: dict[int, float], x: torch.Tensor
) -> torch.Tensor:
    """Folded inference with the int8 convs."""
    return apply_network(spec, qparams, x, act_scales=act_scales)[0]
