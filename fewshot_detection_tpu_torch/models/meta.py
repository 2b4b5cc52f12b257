"""Meta detector: reweighting learnet + dynamically-modulated YOLOv2 head.

Reference behavior being reproduced (file:line in the reference):
  * meta_forward — learnet over (support RGB [+ mask]) inputs, collecting one
    dynamic-weight tensor per [split] layer plus the final output
    (darknet_meta.py:107-128)
  * detect_forward — backbone walk where the dynamic conv consumes the class
    codes (darknet_meta.py:130-195) and routes broadcast across the class
    axis (maybe_repeat, darknet_meta.py:16-35); every static layer runs
    through models/darknet.py's `Walk`, which `_DetectWalk` extends
  * dynamic conv semantics — grouped conv whose filters ARE the class codes
    (dynamic_conv.py:110-168); with the shipped 1024->1024 1x1 depthwise
    config this is per-class channel reweighting

The shipped dconv+head pair is fused into a single (B*H*W, C) x (C, N*K)
matrix product, so the (B*n_cls, H, W, 1024) expansion is never
materialized. The general grouped-conv path is kept for nonstandard cfgs
(partial weights, multi-split learnets).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.int8_mm import int8_matmul
from ..ops.layers import _activate
from .darknet import Params, Walk, apply_network, conv2d, init_params
from .quant import QMAX, act_scale_inverse, device_scalar, quantize_act
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
    train: bool = False,
    s2d: bool = False,
    act_scales: dict[int, float] | None = None,
    observe=None,
) -> tuple[list[torch.Tensor], dict]:
    """Support branch: (N, Hm, Wm, 3|6) images + (N, Hmask, Wmask, 1) masks
    -> (list of per-class code tensors (N, 1, 1, C), one per learnet [split]
    plus the final output; aux with ``bn_updates`` keyed ``darknet_stem``
    (feat_layer > 0 only) and ``learnet``).

    ``act_scales``/``observe`` drive the int8 LEARNET path; keys are learnet
    layer indices. The feat_layer backbone stem, when active, stays on the
    float path. ``s2d`` runs the space-to-depth stem in the backbone stem and
    the learnet where their first layers allow it (`can_fuse_s2d_stem`)."""
    feat_layer = spec.learnet.feat_layer
    bn_updates: dict[str, dict] = {}
    if feat_layer > 0:
        # Run the first `feat_layer` backbone layers on the support image.
        # 6-channel inputs (metain_type 4: image + cropped object) are split
        # into two 3-channel stacks, run through the shared stem, and
        # re-concatenated channel-wise (darknet_meta.py:110-116).
        done_split = metax.shape[-1] == 6
        if done_split:
            metax = torch.cat([metax[..., :3], metax[..., 3:]], dim=0)
        metax, aux = apply_network(
            spec.darknet, params["darknet"], metax, train=train, stop=feat_layer, s2d_stem=s2d,
        )
        bn_updates["darknet_stem"] = aux["bn_updates"]
        if done_split:
            half = metax.shape[0] // 2
            metax = torch.cat([metax[:half], metax[half:]], dim=-1)
    if metain_type in (2, 3):
        if mask is None:
            raise ValueError(f"metain_type {metain_type} requires a mask input")
        metax = torch.cat([metax, mask.to(metax.dtype)], dim=-1)

    out, aux = apply_network(spec.learnet, params["learnet"], metax, train=train, s2d_stem=s2d,
                             act_scales=act_scales, observe=observe)
    bn_updates["learnet"] = aux["bn_updates"]
    return list(aux["splits"]) + [out], {"bn_updates": bn_updates}


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
    return (nxt is not None and nxt.kind == "conv" and not nxt.dynamic
            and layer.size == nxt.size == 1 and layer.partial is None
            and not layer.batch_normalize and not nxt.batch_normalize
            and layer.activation == "linear" and nxt.groups == 1 and nxt.stride == 1
            and tuple(dw.shape[1:]) == (1, 1, x.shape[-1]))


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


def head_int8_operands(
    x: torch.Tensor, dw: torch.Tensor, head_w: torch.Tensor, sx: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 operands of `fused_reweight_head_int8`: the input codes
    (B*H*W, C), the effective weight's codes (N*K, C) and its per-column
    scales (N*K,) float32.

    eff[c, n*K+k] = dw[n,c] * head_w[k,c] depends on the sweep's class
    codes, so it is quantized on the device at each call, per output column:
    scale = max(absmax, 1e-12) / 127 (not the weights' 0 -> 1 rule), taken
    as a product with float32(1/127) as XLA takes the JAX package's division
    by that constant."""
    b, h, w, c = x.shape
    n = dw.shape[0]
    k = head_w.shape[0]
    w_cls = dw.reshape(n, c).float()
    eff = (w_cls.t()[:, :, None] * head_w.reshape(k, c).t()[:, None, :].float()).reshape(c, n * k)
    inv127 = device_scalar(act_scale_inverse(QMAX), x.device)
    scale = torch.clamp(eff.abs().amax(dim=0), min=1e-12) * inv127
    effq = torch.clamp(torch.round(eff / scale), -QMAX, QMAX).to(torch.int8)
    xq = quantize_act(x, device_scalar(act_scale_inverse(sx), x.device))
    return xq.reshape(b * h * w, c), effq.t().contiguous(), scale


def fused_reweight_head_int8(
    x: torch.Tensor,
    dw: torch.Tensor,
    head_w: torch.Tensor,
    head_b: torch.Tensor | None,
    activation: str,
    sx: float,
) -> torch.Tensor:
    """int8 variant of `fused_reweight_head` (the models/quant.py scheme):
    the effective weight quantized per column at each call
    (`head_int8_operands`), the input at the calibrated per-tensor scale
    `sx`, one int8 product summed in int32 (N*K = 450 at 15 classes is
    padded to a multiple of 8 inside `int8_matmul`), dequantized in float32
    with the bias, then the activation."""
    b, h, w, _ = x.shape
    n = dw.shape[0]
    k = head_w.shape[0]
    xq, effq, scale = head_int8_operands(x, dw, head_w, sx)
    y = int8_matmul(xq, effq).float() * (device_scalar(sx, x.device) * scale)
    y = y.reshape(b, h, w, n, k).permute(0, 3, 1, 2, 4).reshape(b * n, h, w, k)
    if head_b is not None:
        y = y + head_b.float()
    return _activate(y.to(x.dtype), activation)


# ---------------------------------------------------------------------------
# detection forward
# ---------------------------------------------------------------------------


class _DetectWalk(Walk):
    """`models.darknet.Walk` with the meta semantics of `detect_forward`:
    the dynamic convs, the fused head, and the two-source routes."""

    def __init__(self, spec: NetSpec, params: Params, dynamic_weights, *, fuse: bool, **kw):
        super().__init__(spec, params, **kw)
        self.dynamic_weights = dynamic_weights
        self.fuse = fuse
        self.n_dynamic = 0  # dynamic convs run so far
        self.dw_cursor = 0  # class codes taken from dynamic_weights so far

    def dynamic_conv(self, layer: LayerSpec, x):
        if isinstance(x, tuple):
            # a tuple route's pair (concat=0): the second element IS the dynamic
            # weight, supplied in-graph instead of from meta_forward's list
            x, dw_in = x
        else:
            dw_in = self.dynamic_weights[self.dw_cursor]
            self.dw_cursor += 1
        p = self.params[layer.index]
        dw = _full_dynamic_weight(layer, p, dw_in, dw_in.shape[0])
        is_first = self.n_dynamic == 0
        self.n_dynamic += 1
        layers = self.spec.layers
        nxt = layers[layer.index + 1] if layer.index + 1 < len(layers) else None
        if self.fuse and is_first and _can_fuse(layer, nxt, dw, x):
            if self.observe is not None:
                self.observe(layer.index, x)
            head = self.params[nxt.index]
            args = (x, dw, head["w"], head.get("b"), nxt.activation)
            if self.act_scales is not None and layer.index in self.act_scales:
                x = fused_reweight_head_int8(*args, self.act_scales[layer.index])
            else:
                x = fused_reweight_head(*args)
            self.outputs[nxt.index] = x  # the head is done: the walk skips it
            return x
        return self.epilogue(layer, p, dynamic_conv_general(x, dw, layer, is_first=is_first))

    def join(self, layer: LayerSpec, a: torch.Tensor, b: torch.Tensor):
        if not layer.concat:
            # tuple passthrough, no broadcast (darknet_meta.py:166-168);
            # consumed by a downstream dynamic conv as (input, dynamic_weight)
            return (a, b)
        # class-broadcast the smaller batch (maybe_repeat semantics)
        if a.shape[0] < b.shape[0]:
            a = class_broadcast(a, b.shape[0] // a.shape[0])
        elif a.shape[0] > b.shape[0]:
            b = class_broadcast(b, a.shape[0] // b.shape[0])
        return super().join(layer, a, b)


def detect_forward(
    spec: MetaSpec,
    params: dict[str, Params],
    x: torch.Tensor,
    dynamic_weights: list[torch.Tensor],
    *,
    train: bool = False,
    fuse: bool = True,
    s2d: bool = False,
    act_scales: dict[int, float] | None = None,
    observe=None,
) -> tuple[torch.Tensor, dict]:
    """Backbone + dynamic reweighting + head.

    ``act_scales``/``observe`` serve the int8 path (models/quant.py): static
    convs whose params carry ``wq`` run the int8 product with the given
    activation scales, and so does the fused reweight+head when
    ``act_scales`` holds the dynamic conv's index; ``observe(idx, x)``
    records calibration inputs.

    x: (B, H, W, 3); dynamic_weights: list of (n_cls, kh, kw, Cd).
    Returns ((B*n_cls, H/32, W/32, A*(5+nC)) image-major rows, aux with
    ``bn_updates`` {layer_index: new stats} when train=True).

    Tuple routes (``concat=0``, darknet_meta.py:166-168) emit ``(x1, x2)``
    unchanged; a downstream dynamic conv consumes the pair as
    (input, dynamic_weight) — the in-graph counterpart of meta_forward's
    collected weight list. ``fuse=False`` runs the first dynamic conv and
    the head apart (the general path). ``s2d`` runs an eligible backbone
    stem in space-to-depth form (`can_fuse_s2d_stem`).
    """
    walk = _DetectWalk(spec.darknet, params["darknet"], dynamic_weights, fuse=fuse,
                       train=train, observe=observe, act_scales=act_scales)
    x = walk.run(x, s2d_stem=s2d)
    return x, {"bn_updates": walk.bn_updates}


def forward(
    spec: MetaSpec,
    params: dict[str, Params],
    x: torch.Tensor,
    metax: torch.Tensor,
    mask: torch.Tensor | None,
    *,
    metain_type: int = 2,
    train: bool = False,
    s2d: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Full episodic forward (darknet_meta.py:197-201); the reweighting and
    the head run fused wherever `_can_fuse` allows."""
    dynamic_weights, maux = meta_forward(
        spec, params, metax, mask, metain_type=metain_type, train=train, s2d=s2d
    )
    y, daux = detect_forward(spec, params, x, dynamic_weights, train=train, s2d=s2d)
    return y, {
        "bn_updates": {"darknet": daux["bn_updates"], **maux["bn_updates"]},
        "dynamic_weights": dynamic_weights,
    }
