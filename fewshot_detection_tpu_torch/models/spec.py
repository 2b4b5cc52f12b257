"""Immutable network specification compiled from darknet cfg blocks.

The reference builds a `nn.ModuleList` and re-interprets the raw block dicts
on every forward pass (reference darknet_meta.py:130-195, 208-353).
Here the block list is compiled ONCE into a tuple of frozen `LayerSpec`s with
all indices, channel counts, and flags resolved, so the apply function is a
straight-line walk without string dispatch.
"""

from __future__ import annotations

import dataclasses

from ..config.darkcfg import propagate_shapes


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """[region] block metadata (anchors in 32-px grid units)."""

    anchors: tuple[float, ...] = ()
    num_classes: int = 0
    num_anchors: int = 1
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    thresh: float = 0.6

    @property
    def anchor_step(self) -> int:
        return len(self.anchors) // self.num_anchors

    @property
    def anchor_wh(self) -> tuple[tuple[float, float], ...]:
        step = self.anchor_step
        return tuple(
            (self.anchors[step * n], self.anchors[step * n + 1])
            for n in range(self.num_anchors)
        )


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One resolved layer. Unused fields stay at their defaults."""

    index: int
    kind: str  # conv|maxpool|reorg|route|shortcut|connected|globalmax|
    #            globalavg|avgpool|softmax|split|region|cost
    in_channels: int = 0
    out_channels: int = 0
    # conv
    size: int = 0
    stride: int = 1
    pad: int = 0
    groups: int = 1
    batch_normalize: bool = False
    activation: str = "linear"
    bias: bool = True
    dynamic: bool = False
    partial: int | None = None
    # route/shortcut
    sources: tuple[int, ...] = ()
    concat: bool = True
    # split
    splits: tuple[int, ...] = ()
    # region
    region: RegionSpec | None = None

    @property
    def has_params(self) -> bool:
        if self.kind == "conv":
            if self.dynamic:
                # weight-less dynamic convs are skipped entirely by the
                # codec even when they carry BN (darknet_meta.py:374,440);
                # with a partial weight they store [BN params,] shared w
                return self.partial is not None
            return True
        return self.kind == "connected"


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """A compiled network graph plus its [net]/[learnet] header info."""

    layers: tuple[LayerSpec, ...]
    kind: str  # "net" or "learnet"
    width: int
    height: int
    channels: int
    feat_layer: int = 0  # learnet only

    @property
    def region(self) -> RegionSpec | None:
        for l in reversed(self.layers):
            if l.kind == "region":
                return l.region
        return None

    @property
    def out_channels(self) -> int:
        for l in reversed(self.layers):
            if l.kind not in ("region", "cost"):
                return l.out_channels
        return self.channels


def build_spec(blocks: list[dict[str, str]]) -> NetSpec:
    """Compile parsed cfg blocks into a NetSpec.

    Channel propagation mirrors create_network
    (reference darknet_meta.py:208-353); route/shortcut negative layer
    ids are resolved to absolute indices here.
    """
    header = blocks[0]
    if header["type"] not in ("net", "learnet"):
        raise ValueError("first block must be [net] or [learnet]")

    shapes = propagate_shapes(blocks)  # validates the graph
    del shapes

    layers: list[LayerSpec] = []
    prev_c = int(header["channels"])
    out_c: list[int] = []
    dynamic_count = 0

    for block in blocks[1:]:
        kind = block["type"]
        ind = len(layers)
        if kind == "convolutional":
            filters = int(block["filters"])
            size = int(block["size"])
            pad = (size - 1) // 2 if int(block["pad"]) else 0
            dynamic = int(block.get("dynamic", "0")) == 1
            partial = int(block["partial"]) if "partial" in block else None
            bn = bool(int(block["batch_normalize"]))
            layers.append(
                LayerSpec(
                    index=ind,
                    kind="conv",
                    in_channels=prev_c,
                    out_channels=filters,
                    size=size,
                    stride=int(block["stride"]),
                    pad=pad,
                    groups=int(block.get("groups", "1")),
                    batch_normalize=bn,
                    activation=block.get("activation", "linear"),
                    # non-BN convs default to bias=True (darknet_meta.py:229)
                    bias=bool(int(block["bias"])) if "bias" in block else not bn,
                    dynamic=dynamic,
                    partial=partial if dynamic else None,
                )
            )
            if dynamic:
                # is_first is derived from dynamic_count at apply time
                dynamic_count += 1
            prev_c = filters
        elif kind == "maxpool":
            layers.append(
                LayerSpec(
                    index=ind,
                    kind="maxpool",
                    in_channels=prev_c,
                    out_channels=prev_c,
                    size=int(block["size"]),
                    stride=int(block["stride"]),
                )
            )
        elif kind in ("avgpool", "globalavg", "globalmax", "softmax"):
            layers.append(
                LayerSpec(
                    index=ind, kind=kind, in_channels=prev_c, out_channels=prev_c
                )
            )
        elif kind == "cost":
            layers.append(LayerSpec(index=ind, kind="cost", out_channels=1))
            prev_c = 1
        elif kind == "reorg":
            stride = int(block["stride"])
            prev_c = stride * stride * prev_c
            layers.append(
                LayerSpec(
                    index=ind,
                    kind="reorg",
                    stride=stride,
                    out_channels=prev_c,
                )
            )
        elif kind == "route":
            srcs = tuple(
                int(i) if int(i) > 0 else int(i) + ind
                for i in block["layers"].split(",")
            )
            concat = int(block.get("concat", "1")) == 1
            if len(srcs) == 1:
                prev_c = out_c[srcs[0]]
            elif len(srcs) == 2:
                # tuple (concat=0) routes carry the first source's feature
                # map onward; concat routes sum channels
                prev_c = (
                    out_c[srcs[0]] + out_c[srcs[1]]
                    if concat
                    else out_c[srcs[0]]
                )
            else:
                raise ValueError("route supports 1 or 2 sources")
            layers.append(
                LayerSpec(
                    index=ind,
                    kind="route",
                    sources=srcs,
                    concat=concat,
                    out_channels=prev_c,
                )
            )
        elif kind == "shortcut":
            frm = int(block["from"])
            frm = frm if frm > 0 else frm + ind
            layers.append(
                LayerSpec(
                    index=ind,
                    kind="shortcut",
                    sources=(frm, ind - 1),
                    activation=block.get("activation", "linear"),
                    out_channels=out_c[ind - 1],
                )
            )
            prev_c = out_c[ind - 1]
        elif kind == "connected":
            filters = int(block["output"])
            layers.append(
                LayerSpec(
                    index=ind,
                    kind="connected",
                    in_channels=prev_c,
                    out_channels=filters,
                    activation=block.get("activation", "linear"),
                )
            )
            prev_c = filters
        elif kind == "split":
            splits = tuple(int(s) for s in block["splits"].split(","))
            layers.append(
                LayerSpec(
                    index=ind,
                    kind="split",
                    in_channels=prev_c,
                    splits=splits,
                    out_channels=splits[-1],
                )
            )
            prev_c = splits[-1]
        elif kind == "region":
            anchors = tuple(float(a) for a in block["anchors"].split(","))
            region = RegionSpec(
                anchors=anchors,
                num_classes=int(block["classes"]),
                num_anchors=int(block["num"]),
                object_scale=float(block.get("object_scale", "5")),
                noobject_scale=float(block.get("noobject_scale", "1")),
                class_scale=float(block.get("class_scale", "1")),
                coord_scale=float(block.get("coord_scale", "1")),
                thresh=float(block.get("thresh", "0.6")),
            )
            layers.append(
                LayerSpec(
                    index=ind, kind="region", out_channels=prev_c, region=region
                )
            )
        else:
            raise ValueError(f"unknown block type {kind!r}")
        out_c.append(prev_c)

    return NetSpec(
        layers=tuple(layers),
        kind=header["type"],
        width=int(header["width"]),
        height=int(header["height"]),
        channels=int(header["channels"]),
        feat_layer=int(header.get("feat_layer", "0")),
    )
