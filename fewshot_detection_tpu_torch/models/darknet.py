"""Functional executor for static (non-dynamic) darknet graphs.

`init_params` / `apply_network` are the init/apply pair for a compiled
`NetSpec`: plain YOLOv2 backbones, YOLOv3 (residual shortcuts, upsampling,
two-source routes and three [yolo] heads; cfg/yolov3.cfg) and the
reweighting learnet (cfg/reweighting_net.cfg). `Walk` runs every static
layer kind for every network; the meta detection path (models/meta.py)
subclasses it for the dynamic convs and the class-broadcast routes.

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
    upsample_nearest,
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


class Walk:
    """One pass over a network's layers, and what it has gathered so far:
    every layer's output by index (`outputs`), the new BN running
    statistics when training (`bn_updates`), the tensors emitted by [split]
    layers (`splits`) and the [yolo] heads' inputs (`heads`), in order.

    `layer` runs every static kind. A dynamic conv goes to `dynamic_conv`
    and the two sources of a route are joined by `join`: models/meta.py's
    detection walk overrides these two, and the static network's walk
    refuses a dynamic conv and concatenates the sources."""

    def __init__(self, spec: NetSpec, params: Params, *, train: bool = False,
                 observe=None, act_scales=None):
        self.spec = spec
        self.params = params
        self.train = train
        self.observe = observe
        self.act_scales = act_scales
        self.outputs: dict[int, Any] = {}
        self.bn_updates: dict[int, dict] = {}
        self.splits: list[torch.Tensor] = []
        self.heads: list[torch.Tensor] = []

    def run(self, x, start: int = 0, stop: int | None = None, s2d_stem: bool = False):
        """Layers [start, stop) from input x; returns the last output. A
        layer whose output an earlier layer already gave (meta's fused head)
        is not run again."""
        end = stop if stop is not None else len(self.spec.layers)
        if s2d_stem and start == 0 and end >= 2 and can_fuse_s2d_stem(self.spec):
            p = self.params[0]
            x, stats = stem_s2d_conv_pool(x, p["w"], p.get("bn"), self.spec.layers[0].activation,
                                          p.get("b"), self.train)
            if stats is not None:
                self.bn_updates[0] = stats
            self.outputs[1] = x
            start = 2
        for layer in self.spec.layers[start:end]:
            if layer.index not in self.outputs:
                x = self.layer(layer, x)
        return x

    def layer(self, layer: LayerSpec, x):
        """Run one layer on x (the previous layer's output) and record its
        output."""
        kind = layer.kind
        if kind == "conv":
            if layer.dynamic:
                x = self.dynamic_conv(layer, x)
            else:
                p = self.params[layer.index]
                if self.observe is not None:
                    self.observe(layer.index, x)
                if p is not None and "wq" in p:
                    from .quant import conv_int8  # lazy: quant imports darknet

                    x = conv_int8(layer, p, x, self.act_scales[layer.index])
                else:
                    y = conv2d(x, p["w"], layer.stride, layer.pad, layer.groups)
                    x = self.epilogue(layer, p, y)
        elif kind == "maxpool":
            x = maxpool_stride1(x) if layer.stride == 1 else maxpool(x, layer.size, layer.stride)
        elif kind == "reorg":
            x = reorg(x, layer.stride)
        elif kind == "route":
            if len(layer.sources) == 1:
                x = self.outputs[layer.sources[0]]
            else:
                x = self.join(layer, *(self.outputs[s] for s in layer.sources))
        elif kind == "shortcut":
            x = self.outputs[layer.sources[0]] + self.outputs[layer.sources[1]]
            x = _activate(x, layer.activation)
        elif kind == "globalmax":
            x = global_maxpool(x)
        elif kind == "globalavg" or kind == "avgpool":
            x = global_avgpool(x)
        elif kind == "softmax":
            x = torch.softmax(x, dim=-1)
        elif kind == "connected":
            p = self.params[layer.index]
            x = x.reshape(x.shape[0], -1) @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
            x = _activate(x, layer.activation)
        elif kind == "split":
            xs = torch.split(x, list(layer.splits), dim=-1)
            self.splits.append(xs[0])
            x = xs[-1]
        elif kind == "upsample":
            x = upsample_nearest(x, layer.stride)
        elif kind == "yolo":
            self.heads.append(x)  # loss metadata; the head is the preceding conv
        elif kind in ("region", "cost"):
            pass  # loss metadata only; output is the preceding conv
        else:
            raise ValueError(f"unhandled layer kind {kind!r}")
        self.outputs[layer.index] = x
        return x

    def epilogue(self, layer: LayerSpec, p: dict | None, y: torch.Tensor) -> torch.Tensor:
        """A conv's BN (training statistics when training) or bias, then its
        activation."""
        if layer.batch_normalize and self.train:
            y, self.bn_updates[layer.index] = bn_train_activate(y, p["bn"], layer.activation)
            return y
        if layer.batch_normalize:
            y = batchnorm_apply(y, p["bn"])
        elif p is not None and "b" in p:
            y = y + p["b"].to(y.dtype)
        return _activate(y, layer.activation)

    def dynamic_conv(self, layer: LayerSpec, x):
        """A conv whose filters are class codes: only the meta walk has them."""
        raise ValueError("dynamic conv in a static network — use models.meta")

    def join(self, layer: LayerSpec, a: torch.Tensor, b: torch.Tensor):
        """The output of a two-source route: the sources side by side."""
        return torch.cat([a, b], dim=-1)


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
    """Run a static network. Returns (output, aux), the output a tuple of
    the [yolo] heads' inputs in order for a net that has such heads
    (`NetSpec.yolo_heads`), else the last layer's; aux carries
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
    walk = Walk(spec, params, train=train, observe=observe, act_scales=act_scales)
    x = walk.run(x, start, stop, s2d_stem)
    return (tuple(walk.heads) if walk.heads else x), {"bn_updates": walk.bn_updates,
                                                      "splits": walk.splits}


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
