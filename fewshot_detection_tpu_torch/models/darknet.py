"""Functional executor for static (non-dynamic) darknet graphs.

`init_params` / `apply_network` are the init/apply pair for a compiled
`NetSpec`: plain YOLOv2 backbones and the reweighting learnet
(cfg/reweighting_net.cfg). The meta detection path (dynamic convs,
class-broadcast routes) lives in models/meta.py.

Activations are NHWC at every boundary, as in the JAX package. Parameters
are the tensor tree of `models.convert` (conv weights OIHW). The reference's
interpreter forward is darknet.py:80-129 / darknet_meta.py:107-128.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.layers import (
    BN_EPS,
    batchnorm_apply,
    bn_normalize,
    bn_train_affine,
    global_avgpool,
    global_maxpool,
    leaky_relu,
    maxpool,
    maxpool_stride1,
    reorg,
)
from .spec import LayerSpec, NetSpec

Params = list  # list[dict | None], aligned with NetSpec.layers


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return leaky_relu(x, 0.1)
    if activation == "relu":
        return torch.relu(x)
    return x


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    groups: int = 1,
) -> torch.Tensor:
    """Grouped 2D convolution, NHWC x OIHW -> NHWC, in x's dtype.

    The convolution sees a permuted view of x (NCHW shape over NHWC memory,
    i.e. `channels_last`), so no layout copy is made."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype), None, stride, pad, 1, groups
    )
    return y.permute(0, 2, 3, 1)


def _normalize_activate(y, inv, bias, activation: str) -> torch.Tensor:
    return _activate(bn_normalize(y, inv, bias), activation)


def bn_train_activate(
    y: torch.Tensor, bn: dict, activation: str, remat: bool = False
) -> tuple[torch.Tensor, dict]:
    """Training BN + activation on a conv output; returns (out, new stats).

    ``remat=True`` keeps the conv output and the batch statistics and
    recomputes only the normalize/activation epilogue in the backward (the
    tensors the JAX trainer's rematerialization policy saves). The
    statistics stay outside the checkpointed function: recomputing them
    would launch the `bn_sums` kernel once more over the whole conv output."""
    inv, bias, new_stats = bn_train_affine(y, bn)
    if remat:
        from torch.utils.checkpoint import checkpoint

        out = checkpoint(_normalize_activate, y, inv, bias, activation, use_reentrant=False)
    else:
        out = _normalize_activate(y, inv, bias, activation)
    return out, new_stats


def apply_conv_layer(
    layer: LayerSpec,
    p: dict[str, Any],
    x: torch.Tensor,
    train: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """conv [+ BN] [+ activation]; returns (y, new_bn_stats|None)."""
    y = conv2d(x, p["w"], layer.stride, layer.pad, layer.groups)
    if layer.batch_normalize and train:
        return bn_train_activate(y, p["bn"], layer.activation, remat)
    if layer.batch_normalize:
        y = batchnorm_apply(y, p["bn"])
    elif "b" in p:
        y = y + p["b"].to(y.dtype)
    return _activate(y, layer.activation), None


def _bn_init(c: int) -> dict:
    return {
        "gamma": np.ones((c,), np.float32),
        "beta": np.zeros((c,), np.float32),
        "mean": np.zeros((c,), np.float32),
        "var": np.ones((c,), np.float32),
    }


def init_params(spec: NetSpec, seed: int | np.random.Generator = 0) -> Params:
    """Initialize the numpy HWIO parameter tree (uniform fan-in for conv/fc,
    ones/zeros for BN — the reference always fine-tuned from pretrained
    weights, so the init is not load-bearing). Randomness comes from a numpy
    generator, so the values do not equal the JAX package's for one seed;
    parity tests hand one tree to both sides."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)

    def uniform(shape, stdv):
        return rng.uniform(-stdv, stdv, shape).astype(np.float32)

    params: Params = []
    for layer in spec.layers:
        if layer.kind == "conv":
            if layer.dynamic:
                p: dict[str, Any] = {}
                if layer.partial is not None:
                    n = layer.partial * layer.size * layer.size
                    p["w"] = uniform(
                        (layer.size, layer.size, layer.partial), 1.0 / float(np.sqrt(n))
                    )
                if layer.batch_normalize:
                    p["bn"] = _bn_init(layer.out_channels)
                params.append(p or None)
                continue
            cin = layer.in_channels // layer.groups
            stdv = 1.0 / float(np.sqrt(cin * layer.size * layer.size))
            p = {"w": uniform((layer.size, layer.size, cin, layer.out_channels), stdv)}
            if layer.batch_normalize:
                p["bn"] = _bn_init(layer.out_channels)
            elif layer.bias:
                p["b"] = uniform((layer.out_channels,), stdv)
            params.append(p)
        elif layer.kind == "connected":
            stdv = 1.0 / float(np.sqrt(layer.in_channels))
            params.append(
                {
                    "w": uniform((layer.in_channels, layer.out_channels), stdv),
                    "b": uniform((layer.out_channels,), stdv),
                }
            )
        else:
            params.append(None)
    return params


def apply_network(
    spec: NetSpec,
    params: Params,
    x: torch.Tensor,
    *,
    train: bool = False,
    start: int = 0,
    stop: int | None = None,
    remat: bool = False,
    observe=None,
    act_scales=None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Run a static network. Returns (output, aux) where aux carries
    ``bn_updates`` ({layer_index: new stats} when train=True) and
    ``splits`` (tensors emitted by [split] layers, in order — the learnet's
    per-split dynamic-weight outputs, darknet_meta.py:120-126).

    ``start``/``stop`` run a sub-range of layers (used for feat_layer>0
    learnet stems and partial-backbone extraction). ``remat`` (training
    only) recomputes the BN/activation epilogues in the backward, see
    `bn_train_activate`.

    ``observe(layer_index, x)`` is called with every static conv's input
    (int8 calibration hook); conv params carrying ``wq`` run the int8
    product with ``act_scales[layer_index]`` (models/quant.py).
    """
    outputs: dict[int, torch.Tensor] = {}
    bn_updates: dict[int, dict] = {}
    splits: list[torch.Tensor] = []
    end = stop if stop is not None else len(spec.layers)

    for layer in spec.layers[start:end]:
        kind = layer.kind
        if kind == "conv":
            if layer.dynamic:
                raise ValueError("dynamic conv in a static network — use models.meta")
            p = params[layer.index]
            if observe is not None:
                observe(layer.index, x)
            if p is not None and "wq" in p:
                from .quant import conv_int8  # lazy: quant imports darknet

                x = conv_int8(layer, p, x, act_scales[layer.index])
            else:
                x, stats = apply_conv_layer(layer, p, x, train, remat)
                if stats is not None:
                    bn_updates[layer.index] = stats
        elif kind == "maxpool":
            x = maxpool_stride1(x) if layer.stride == 1 else maxpool(x, layer.size, layer.stride)
        elif kind == "reorg":
            x = reorg(x, layer.stride)
        elif kind == "route":
            if len(layer.sources) == 1:
                x = outputs[layer.sources[0]]
            else:
                a, b = (outputs[s] for s in layer.sources)
                x = torch.cat([a, b], dim=-1)
        elif kind == "shortcut":
            x = outputs[layer.sources[0]] + outputs[layer.sources[1]]
            x = _activate(x, layer.activation)
        elif kind == "globalmax":
            x = global_maxpool(x)
        elif kind == "globalavg" or kind == "avgpool":
            x = global_avgpool(x)
        elif kind == "softmax":
            x = torch.softmax(x, dim=-1)
        elif kind == "connected":
            p = params[layer.index]
            x = x.reshape(x.shape[0], -1) @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
            x = _activate(x, layer.activation)
        elif kind == "split":
            xs = torch.split(x, list(layer.splits), dim=-1)
            splits.append(xs[0])
            x = xs[-1]
        elif kind in ("region", "cost"):
            pass  # loss metadata only; output is the preceding conv
        else:
            raise ValueError(f"unhandled layer kind {kind!r}")
        outputs[layer.index] = x

    return x, {"bn_updates": bn_updates, "splits": splits}


def fold_batchnorm(spec: NetSpec, params: Params) -> Params:
    """Fold BN running stats into conv weights for inference (tensor tree).

    w' = w * gamma/sqrt(var+eps); b' = beta - mean*gamma/sqrt(var+eps).
    Returns new params with `bn` removed and `b` added; layers without BN
    are passed through unchanged.
    """
    folded: Params = []
    for layer, p in zip(spec.layers, params):
        # dynamic convs are not static-foldable (their effective weights are
        # the per-episode class codes); leave their params untouched
        if (p is None or layer.kind != "conv" or layer.dynamic
                or not layer.batch_normalize):
            folded.append(p)
            continue
        bn = p["bn"]
        scale = bn["gamma"] / torch.sqrt(bn["var"] + BN_EPS)
        folded.append(
            {
                "w": p["w"] * scale[:, None, None, None],  # OIHW: scale per O
                "b": bn["beta"] - bn["mean"] * scale,
            }
        )
    return folded


def folded_spec(spec: NetSpec) -> NetSpec:
    """Spec view matching fold_batchnorm output (BN flags cleared)."""
    layers = tuple(
        dataclasses.replace(l, batch_normalize=False, bias=True)
        if l.kind == "conv" and l.batch_normalize and not l.dynamic
        else l
        for l in spec.layers
    )
    return dataclasses.replace(spec, layers=layers)
