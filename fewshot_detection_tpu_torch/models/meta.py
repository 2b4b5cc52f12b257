"""Meta detector: reweighting learnet + dynamically-modulated YOLOv2 head.

Reference behavior being reproduced (file:line in the reference):
  * meta_forward — learnet over (support RGB [+ mask]) inputs, collecting one
    dynamic-weight tensor per [split] layer plus the final output
    (darknet_meta.py:107-128)
  * detect_forward — backbone walk where the dynamic conv consumes the class
    codes (darknet_meta.py:130-195) and routes broadcast across the class
    axis (maybe_repeat, darknet_meta.py:16-35)
  * dynamic conv semantics — grouped conv whose filters ARE the class codes
    (dynamic_conv.py:110-168); with the shipped 1024->1024 1x1 depthwise
    config this is per-class channel reweighting

The shipped dconv+head pair is fused into a single (B*H*W, C) x (C, N*K)
matrix product, so the (B*n_cls, H, W, 1024) expansion is never
materialized. The general grouped-conv path is kept for nonstandard cfgs
(partial weights, multi-split learnets). Inference only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.layers import (
    batchnorm_apply,
    global_avgpool,
    global_maxpool,
    maxpool,
    maxpool_stride1,
    reorg,
)
from .darknet import Params, _activate, apply_conv_layer, apply_network, conv2d, init_params
from .spec import LayerSpec, NetSpec


@dataclasses.dataclass(frozen=True)
class MetaSpec:
    darknet: NetSpec
    learnet: NetSpec

    @property
    def region(self):
        return self.darknet.region


def init_meta_params(spec: MetaSpec, seed: int = 0) -> dict[str, Params]:
    """numpy HWIO trees for both networks from one seed."""
    rng = np.random.default_rng(seed)
    return {
        "darknet": init_params(spec.darknet, rng),
        "learnet": init_params(spec.learnet, rng),
    }


def class_broadcast(x: torch.Tensor, n_cls: int) -> torch.Tensor:
    """(B, ...) -> (B*n_cls, ...) b-major interleave: out[b*n+j] = x[b].

    Matches maybe_repeat's repeat/transpose/view (darknet_meta.py:16-35)."""
    return torch.repeat_interleave(x, n_cls, dim=0)


def meta_forward(
    spec: MetaSpec,
    params: dict[str, Params],
    metax: torch.Tensor,
    mask: torch.Tensor | None,
    *,
    metain_type: int = 2,
) -> list[torch.Tensor]:
    """Support branch: (N, Hm, Wm, 3|6) images + (N, Hmask, Wmask, 1) masks
    -> list of per-class code tensors (N, 1, 1, C) (one per learnet [split]
    plus the final output)."""
    feat_layer = spec.learnet.feat_layer
    if feat_layer > 0:
        # Run the first `feat_layer` backbone layers on the support image.
        # 6-channel inputs (metain_type 4: image + cropped object) are split
        # into two 3-channel stacks, run through the shared stem, and
        # re-concatenated channel-wise (darknet_meta.py:110-116).
        done_split = metax.shape[-1] == 6
        if done_split:
            metax = torch.cat([metax[..., :3], metax[..., 3:]], dim=0)
        metax, _ = apply_network(spec.darknet, params["darknet"], metax, stop=feat_layer)
        if done_split:
            half = metax.shape[0] // 2
            metax = torch.cat([metax[:half], metax[half:]], dim=-1)
    if metain_type in (2, 3):
        if mask is None:
            raise ValueError(f"metain_type {metain_type} requires a mask input")
        metax = torch.cat([metax, mask.to(metax.dtype)], dim=-1)

    out, aux = apply_network(spec.learnet, params["learnet"], metax)
    return list(aux["splits"]) + [out]


# ---------------------------------------------------------------------------
# dynamic conv
# ---------------------------------------------------------------------------


def _full_dynamic_weight(
    layer: LayerSpec, p: dict | None, dw: torch.Tensor, n_cls: int
) -> torch.Tensor:
    """Prepend the shared `partial` weight (broadcast per class) to the
    per-class codes (dynamic_conv.py:133-136). dw: (N, kh, kw, Cd)."""
    if layer.partial is None:
        return dw
    shared = p["w"].to(dw.dtype)  # (kh, kw, partial)
    shared = shared[None].expand((n_cls,) + tuple(shared.shape))
    return torch.cat([shared, dw], dim=-1)


def dynamic_conv_general(
    x: torch.Tensor,
    dw: torch.Tensor,
    layer: LayerSpec,
    *,
    is_first: bool,
) -> torch.Tensor:
    """Materializing grouped dynamic conv, replicating dynamic_conv.py:125-164.

    x: (B, H, W, C) when is_first else (B*n_cls, H, W, C)
    dw: (n_cls, kh, kw, Cd) with Cd % C == 0
    returns (B*n_cls, H', W', C)
    """
    n_cls, kh, kw, cd = dw.shape
    c = x.shape[-1]
    if cd % c:
        raise ValueError(f"dynamic weight channels {cd} not divisible by input {c}")
    group_size = cd // c

    if is_first:
        # (B, H, W, C) -> (B, H, W, n_cls*C): class-major channel tiling
        # (torch input.repeat(1, n_cls, 1, 1) tiles the channel dim)
        x = x.repeat(1, 1, 1, n_cls)
    else:
        bn_, h, w, _ = x.shape
        b = bn_ // n_cls
        # (B*n_cls, H, W, C) -> (B, H, W, n_cls*C); batch is b-major so the
        # class id becomes the leading channel factor
        x = x.reshape(b, n_cls, h, w, c).permute(0, 2, 3, 1, 4).reshape(b, h, w, n_cls * c)

    # dw (n_cls, kh, kw, Cd) -> torch filter rows (n_cls*Cd/g, g, kh, kw)
    rows = n_cls * cd // group_size
    w_oihw = dw.permute(0, 3, 1, 2).reshape(rows, group_size, kh, kw)

    groups = n_cls * c // group_size
    y = conv2d(x, w_oihw, layer.stride, layer.pad, groups=groups)
    bh, hh, wh, _ = y.shape
    return y.reshape(bh, hh, wh, n_cls, c).permute(0, 3, 1, 2, 4).reshape(
        bh * n_cls, hh, wh, c
    )


def _can_fuse(layer: LayerSpec, nxt: LayerSpec | None, dw: torch.Tensor, x: torch.Tensor) -> bool:
    """Fusable pattern: first dconv, 1x1 depthwise (group_size 1), linear
    activation, no BN, immediately followed by a static 1x1 conv (the
    30-ch head)."""
    return (
        nxt is not None
        and layer.size == 1
        and layer.partial is None
        and not layer.batch_normalize
        and layer.activation == "linear"
        and dw.shape[1] == 1
        and dw.shape[2] == 1
        and dw.shape[3] == x.shape[-1]
        and nxt.kind == "conv"
        and not nxt.dynamic
        and nxt.size == 1
        and nxt.groups == 1
        and not nxt.batch_normalize
        and nxt.stride == 1
    )


def fused_reweight_head(
    x: torch.Tensor,
    dw: torch.Tensor,
    head_w: torch.Tensor,
    head_b: torch.Tensor | None,
    activation: str,
) -> torch.Tensor:
    """y[b,n,:,:,k] = head(x[b] * dw[n]) as ONE matrix product.

    x: (B, H, W, C); dw: (N, 1, 1, C); head_w: (K, C, 1, 1) OIHW ->
    (B*N, H, W, K) without materializing (B*N, H, W, C).

    eff[c, n*K+k] = dw[n,c] * head_w[k,c]; y = x @ eff — a
    (B*H*W, C) x (C, N*K) contraction. It lies outside any hand-written
    kernel in the JAX package too (left to the compiler there), so it goes
    to `torch.matmul` here. `eff` is built in the parameters' dtype and cast
    to x's dtype before the product, where the JAX package casts."""
    b, h, w, c = x.shape
    n = dw.shape[0]
    k = head_w.shape[0]
    w_cls = dw.reshape(n, c)
    eff = (w_cls.t()[:, :, None] * head_w.reshape(k, c).t()[:, None, :]).reshape(c, n * k)
    y = torch.matmul(x.reshape(b * h * w, c), eff.to(x.dtype))
    y = y.reshape(b, h, w, n, k).permute(0, 3, 1, 2, 4).reshape(b * n, h, w, k)
    if head_b is not None:
        y = y + head_b.to(y.dtype)
    return _activate(y, activation)


# ---------------------------------------------------------------------------
# detection forward
# ---------------------------------------------------------------------------


def detect_forward(
    spec: MetaSpec,
    params: dict[str, Params],
    x: torch.Tensor,
    dynamic_weights: list[torch.Tensor],
    *,
    fuse: bool = True,
) -> torch.Tensor:
    """Backbone + dynamic reweighting + head, at inference.

    x: (B, H, W, 3); dynamic_weights: list of (n_cls, kh, kw, Cd).
    Returns (B*n_cls, H/32, W/32, A*(5+nC)), image-major rows.

    Tuple routes (``concat=0``, darknet_meta.py:166-168) emit ``(x1, x2)``
    unchanged; a downstream dynamic conv consumes the pair as
    (input, dynamic_weight) — the in-graph counterpart of meta_forward's
    collected weight list.
    """
    dparams = params["darknet"]
    layers = spec.darknet.layers
    outputs: dict = {}

    dyn_cnt = 0
    dw_cursor = 0
    skip_next = False
    for li, layer in enumerate(layers):
        if skip_next:
            skip_next = False
            outputs[layer.index] = x
            continue
        kind = layer.kind
        if kind == "conv":
            if layer.dynamic:
                if isinstance(x, tuple):
                    # tuple route output (concat=0): the second element IS
                    # the dynamic weight, supplied in-graph instead of from
                    # meta_forward's list
                    x, dw_in = x
                else:
                    dw_in = dynamic_weights[dw_cursor]
                    dw_cursor += 1
                dw = _full_dynamic_weight(
                    layer, dparams[layer.index], dw_in, dw_in.shape[0]
                )
                is_first = dyn_cnt == 0
                nxt = layers[li + 1] if li + 1 < len(layers) else None
                if fuse and is_first and _can_fuse(layer, nxt, dw, x):
                    head_p = dparams[nxt.index]
                    x = fused_reweight_head(
                        x, dw, head_p["w"], head_p.get("b"), nxt.activation
                    )
                    skip_next = True
                else:
                    x = dynamic_conv_general(x, dw, layer, is_first=is_first)
                    if layer.batch_normalize:
                        x = batchnorm_apply(x, dparams[layer.index]["bn"])
                    x = _activate(x, layer.activation)
                dyn_cnt += 1
            else:
                x = apply_conv_layer(layer, dparams[layer.index], x)
        elif kind == "maxpool":
            x = maxpool_stride1(x) if layer.stride == 1 else maxpool(x, layer.size, layer.stride)
        elif kind == "reorg":
            x = reorg(x, layer.stride)
        elif kind == "route":
            if len(layer.sources) == 1:
                x = outputs[layer.sources[0]]
            else:
                a, b = (outputs[s] for s in layer.sources)
                if not layer.concat:
                    # tuple passthrough, no broadcast (darknet_meta.py:166-168);
                    # consumed by a downstream dynamic conv as
                    # (input, dynamic_weight)
                    x = (a, b)
                    outputs[layer.index] = x
                    continue
                # class-broadcast the smaller batch (maybe_repeat semantics)
                if a.shape[0] != b.shape[0]:
                    if a.shape[0] < b.shape[0]:
                        a = class_broadcast(a, b.shape[0] // a.shape[0])
                    else:
                        b = class_broadcast(b, a.shape[0] // b.shape[0])
                x = torch.cat([a, b], dim=-1)
        elif kind == "shortcut":
            x = outputs[layer.sources[0]] + outputs[layer.sources[1]]
            x = _activate(x, layer.activation)
        elif kind == "globalmax":
            x = global_maxpool(x)
        elif kind in ("globalavg", "avgpool"):
            x = global_avgpool(x)
        elif kind == "softmax":
            x = torch.softmax(x, dim=-1)
        elif kind in ("region", "cost"):
            pass
        else:
            raise ValueError(f"unhandled layer kind {kind!r} in detect_forward")
        outputs[layer.index] = x

    return x
