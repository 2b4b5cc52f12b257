"""A frozen reader of darknet `.cfg` files and the walk of their shapes.

The benchmark's own: it reads the configuration's cfg copies under
`benchmark/configs/cfg/` for the FLOP and byte counts and for the plain
reference, and shares no code with the program. `parse` gives the blocks,
`walk` one `Layer` per block after the header with its channels, its
sides in and out at a given input size, and the absolute indices of a
route's sources. Only the layer kinds of the benchmark's configurations
are known (convolutional, maxpool, reorg, route, globalmax, region); any
other raises.
"""

from __future__ import annotations

import dataclasses


def parse(path: str) -> list[dict]:
    """The cfg's blocks in order: `{"type": name, key: value, ...}`, values
    as strings, comments (`#`, `;`) and blank lines dropped."""
    blocks: list[dict] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].split(";")[0].strip()
            if not line:
                continue
            if line.startswith("["):
                blocks.append({"type": line.strip("[]").strip()})
            else:
                key, value = line.split("=", 1)
                blocks[-1][key.strip()] = value.strip()
    return blocks


@dataclasses.dataclass(frozen=True)
class Layer:
    index: int
    kind: str  # conv | maxpool | reorg | route | globalmax | region
    c_in: int = 0
    c_out: int = 0
    side_in: int = 0
    side_out: int = 0
    size: int = 0
    stride: int = 1
    pad: int = 0
    bn: bool = False
    activation: str = "linear"
    dynamic: bool = False
    sources: tuple = ()
    options: dict = dataclasses.field(default_factory=dict, compare=False)


def walk(blocks: list[dict], side: int | None = None) -> list[Layer]:
    """The layers of a parsed cfg at input side `side` (default: the
    header's width). A conv pads (size - 1) // 2 when `pad=1`; a maxpool
    floors; a route takes its sources' side and sums their channels."""
    header = blocks[0]
    side = int(header["width"]) if side is None else side
    c = int(header["channels"])
    out_c: list[int] = []
    out_side: list[int] = []
    layers: list[Layer] = []
    for i, b in enumerate(blocks[1:]):
        kind = b["type"]
        if kind == "convolutional":
            size, stride = int(b["size"]), int(b["stride"])
            pad = (size - 1) // 2 if int(b.get("pad", "0")) else 0
            s_out = (side + 2 * pad - size) // stride + 1
            layer = Layer(i, "conv", c, int(b["filters"]), side, s_out, size, stride, pad,
                          bool(int(b.get("batch_normalize", "0"))), b.get("activation", "linear"),
                          bool(int(b.get("dynamic", "0"))))
        elif kind == "maxpool":
            size, stride = int(b["size"]), int(b["stride"])
            s_out = side if stride == 1 else (side - size) // stride + 1
            layer = Layer(i, "maxpool", c, c, side, s_out, size, stride)
        elif kind == "reorg":
            s = int(b["stride"])
            layer = Layer(i, "reorg", c, c * s * s, side, side // s, stride=s)
        elif kind == "route":
            srcs = tuple(int(v) if int(v) > 0 else int(v) + i for v in b["layers"].split(","))
            layer = Layer(i, "route", c, sum(out_c[s] for s in srcs), side, out_side[srcs[0]],
                          sources=srcs)
        elif kind == "globalmax":
            layer = Layer(i, "globalmax", c, c, side, 1)
        elif kind == "region":
            layer = Layer(i, "region", c, c, side, side, options=dict(b))
        else:
            raise ValueError(f"layer {i}: the benchmark does not know the kind {kind!r}")
        layers.append(layer)
        c, side = layer.c_out, layer.side_out
        out_c.append(c)
        out_side.append(side)
    return layers


def region(layers: list[Layer]) -> dict:
    """The [region] block's numbers: anchors as (w, h) pairs in grid
    cells, the class count and the loss scales."""
    opts = next(l.options for l in layers if l.kind == "region")
    vals = [float(v) for v in opts["anchors"].split(",")]
    num = int(opts["num"])
    step = len(vals) // num
    return {
        "anchors": [(vals[step * n], vals[step * n + 1]) for n in range(num)],
        "classes": int(opts["classes"]),
        "object_scale": float(opts["object_scale"]),
        "noobject_scale": float(opts["noobject_scale"]),
        "class_scale": float(opts["class_scale"]),
        "coord_scale": float(opts["coord_scale"]),
        "thresh": float(opts["thresh"]),
    }
