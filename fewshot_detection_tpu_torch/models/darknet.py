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
    _activate,
    batchnorm_apply,
    bn_train_activate,
    global_avgpool,
    global_maxpool,
    maxpool,
    maxpool_stride1,
    reorg,
    stem_s2d_conv_pool,
)
from .spec import LayerSpec, NetSpec

Params = list  # list[dict | None], aligned with NetSpec.layers


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


def apply_conv_layer(
    layer: LayerSpec,
    p: dict[str, Any],
    x: torch.Tensor,
    train: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """conv [+ BN] [+ activation]; returns (y, new_bn_stats|None)."""
    y = conv2d(x, p["w"], layer.stride, layer.pad, layer.groups)
    if layer.batch_normalize and train:
        return bn_train_activate(y, p["bn"], layer.activation)
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


def can_fuse_s2d_stem(spec: NetSpec) -> bool:
    """True when layers 0-1 are the conv3x3(s1,p1)+maxpool(2,2) pattern the
    space-to-depth stem handles (`ops/layers.py:stem_s2d_conv_pool`), and no
    later layer routes back into them (the stem's full-resolution conv
    output is never formed). Any other network takes the plain stem."""
    if len(spec.layers) < 2:
        return False
    c0, p1 = spec.layers[0], spec.layers[1]
    ok = (
        c0.kind == "conv"
        and not c0.dynamic
        and c0.size == 3
        and c0.stride == 1
        and c0.pad == 1
        and c0.groups == 1
        and c0.activation in ("leaky", "relu", "linear")
        and p1.kind == "maxpool"
        and p1.size == 2
        and p1.stride == 2
    )
    return ok and not any(s in (0, 1) for layer in spec.layers[2:] for s in layer.sources)


def run_s2d_stem(spec: NetSpec, params: Params, x: torch.Tensor, train: bool):
    """Layers 0-1 of an eligible network as the space-to-depth stem; returns
    (output of layer 1, new BN stats of layer 0 or None)."""
    p = params[0]
    return stem_s2d_conv_pool(x, p["w"], p.get("bn"), spec.layers[0].activation, p.get("b"),
                              train)


def apply_network(
    spec: NetSpec,
    params: Params,
    x: torch.Tensor,
    *,
    train: bool = False,
    start: int = 0,
    stop: int | None = None,
    s2d_stem: bool = False,
    observe=None,
    act_scales=None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Run a static network. Returns (output, aux) where aux carries
    ``bn_updates`` ({layer_index: new stats} when train=True) and
    ``splits`` (tensors emitted by [split] layers, in order — the learnet's
    per-split dynamic-weight outputs, darknet_meta.py:120-126).

    ``start``/``stop`` run a sub-range of layers (used for feat_layer>0
    learnet stems and partial-backbone extraction). ``s2d_stem=True`` computes an eligible conv+pool
    stem (`can_fuse_s2d_stem`) in space-to-depth form, the same function.

    ``observe(layer_index, x)`` is called with every static conv's input
    (int8 calibration hook); conv params carrying ``wq`` run the int8
    product with ``act_scales[layer_index]`` (models/quant.py).
    """
    outputs: dict[int, torch.Tensor] = {}
    bn_updates: dict[int, dict] = {}
    splits: list[torch.Tensor] = []
    end = stop if stop is not None else len(spec.layers)
    layers = spec.layers[start:end]

    if s2d_stem and start == 0 and end >= 2 and can_fuse_s2d_stem(spec):
        x, stats = run_s2d_stem(spec, params, x, train)
        if stats is not None:
            bn_updates[0] = stats
        outputs[1] = x
        layers = layers[2:]

    for layer in layers:
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
                x, stats = apply_conv_layer(layer, p, x, train)
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
