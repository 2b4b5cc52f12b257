"""Carry parameters between the numpy tree and the port's tensor tree.

The numpy tree is the JAX package's: one entry per layer, ``None`` or
``{"w": HWIO, "b", "bn": {gamma, beta, mean, var}}``, fully-connected
weights as (in, out), a dynamic conv's shared `partial` weight as
(kh, kw, partial). It is what `weights_io` reads and writes, so a
checkpoint loads identically on both sides.

The port's tree has the same nesting with `torch.Tensor` leaves on one
device, and conv weights in PyTorch's OIHW order (stored `channels_last`,
the layout the NHWC executor hands to the convolution). Everything else
keeps its shape.
"""

from __future__ import annotations

import numpy as np
import torch

from .spec import NetSpec


def _is_static_conv(layer) -> bool:
    return layer.kind == "conv" and not layer.dynamic


def from_jax_params(spec: NetSpec, params: list, device="cuda") -> list:
    """numpy (or array-like) HWIO tree -> float32 tensor tree on `device`."""
    dev = torch.device(device)

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dev)

    out: list = []
    for layer, p in zip(spec.layers, params):
        if p is None:
            out.append(None)
            continue
        q: dict = {}
        if "w" in p:
            w = np.asarray(p["w"], np.float32)
            if _is_static_conv(layer):
                # HWIO -> OIHW
                q["w"] = leaf(w.transpose(3, 2, 0, 1)).contiguous(
                    memory_format=torch.channels_last
                )
            else:
                q["w"] = leaf(w)
        if "b" in p:
            q["b"] = leaf(p["b"])
        if "bn" in p:
            q["bn"] = {k: leaf(v) for k, v in p["bn"].items()}
        out.append(q)
    return out


def to_jax_params(spec: NetSpec, params: list) -> list:
    """The port's tensor tree -> numpy HWIO tree (inverse of from_jax_params)."""

    def leaf(t):
        return t.detach().to("cpu", torch.float32).contiguous().numpy()

    out: list = []
    for layer, p in zip(spec.layers, params):
        if p is None:
            out.append(None)
            continue
        q: dict = {}
        if "w" in p:
            w = leaf(p["w"])
            if _is_static_conv(layer):
                w = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # OIHW -> HWIO
            q["w"] = w
        if "b" in p:
            q["b"] = leaf(p["b"])
        if "bn" in p:
            q["bn"] = {k: leaf(v) for k, v in p["bn"].items()}
        out.append(q)
    return out
