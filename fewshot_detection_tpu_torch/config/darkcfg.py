"""Darknet `.cfg` / `.data` config parsing and static shape propagation.

Behavior-parity notes (vs the reference implementation):
  * block parsing semantics match reference cfg.py:198-228 —
    `[section]` headers open a new dict, `key=value` lines fill it, `#` and
    blank lines are skipped, a `type=` key inside a block is renamed to
    `_type` (it would clash with the block's own type tag), and
    `[convolutional]` blocks default to `batch_normalize=0`.
  * `.data` parsing matches reference utils.py:460-475, including the
    default `gpus=0,1,2,3` and `num_workers=10` entries.
  * shape propagation reproduces the arithmetic of the reference's
    `print_cfg` (reference cfg.py:230-409) as a pure function so model
    construction and tests can consume it; the reference only ever printed it.

Everything here is pure Python over immutable inputs — no global state.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


def _iter_cfg_lines(text: str) -> Iterable[str]:
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        yield line


def parse_cfg_text(text: str) -> list[dict[str, str]]:
    """Parse darknet cfg text into an ordered list of block dicts.

    Each block dict carries its section name under ``"type"``; all other
    entries are raw strings exactly as written (values are only stripped).
    """
    blocks: list[dict[str, str]] = []
    current: dict[str, str] | None = None
    for line in _iter_cfg_lines(text):
        if line.startswith("["):
            if current is not None:
                blocks.append(current)
            section = line.lstrip("[").rstrip("]")
            current = {"type": section}
            if section == "convolutional":
                current["batch_normalize"] = "0"
        else:
            if current is None:
                raise ValueError(f"cfg line outside any [section]: {line!r}")
            key, _, value = line.partition("=")
            key = key.strip()
            if key == "type":  # cost blocks use `type=` for the loss kind
                key = "_type"
            current[key] = value.strip()
    if current is not None:
        blocks.append(current)
    return blocks


def parse_cfg(cfgfile: str) -> list[dict[str, str]]:
    """Parse a darknet `.cfg` file into a list of block dicts."""
    with open(cfgfile, "r") as fp:
        return parse_cfg_text(fp.read())


def read_data_cfg(datacfg: str) -> dict[str, str]:
    """Parse a `.data` key=value file (reference defaults preserved)."""
    options = {"gpus": "0,1,2,3", "num_workers": "10"}
    with open(datacfg, "r") as fp:
        for line in _iter_cfg_lines(fp.read()):
            key, _, value = line.partition("=")
            options[key.strip()] = value.strip()
    return options


# ---------------------------------------------------------------------------
# Static shape propagation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Output geometry of one cfg block (spatial dims + channels)."""

    index: int
    kind: str
    width: int
    height: int
    filters: int


def propagate_shapes(
    blocks: list[dict[str, str]],
    width: int | None = None,
    height: int | None = None,
) -> list[LayerShape]:
    """Compute per-layer output shapes for a block list.

    Mirrors the arithmetic of the reference's table printer
    (reference cfg.py:230-409). The first block must be `[net]` or
    `[learnet]`; `width`/`height` override its spatial dims (used for the
    multi-scale schedule). Returns one entry per non-header block.
    """
    if not blocks or blocks[0]["type"] not in ("net", "learnet"):
        raise ValueError("cfg must start with a [net] or [learnet] block")

    header = blocks[0]
    w = int(width if width is not None else header["width"])
    h = int(height if height is not None else header["height"])
    c = int(header["channels"])
    if header["type"] == "learnet":
        factor = int(header.get("feat_layer", "0"))
        if factor:
            w //= factor
            h //= factor

    shapes: list[LayerShape] = []

    def push(kind: str) -> None:
        shapes.append(LayerShape(len(shapes), kind, w, h, c))

    for block in blocks[1:]:
        kind = block["type"]
        if kind == "convolutional":
            filters = int(block["filters"])
            size = int(block["size"])
            stride = int(block["stride"])
            pad = (size - 1) // 2 if int(block["pad"]) else 0
            w = (w + 2 * pad - size) // stride + 1
            h = (h + 2 * pad - size) // stride + 1
            c = filters
            dyn = int(block.get("dynamic", "0")) == 1
            push("dconv" if dyn else "conv")
        elif kind == "maxpool":
            stride = int(block["stride"])
            if stride > 1:
                w //= stride
                h //= stride
            # stride-1 maxpool keeps spatial dims (replicate-padded)
            push("max")
        elif kind in ("globalmax", "globalavg", "avgpool"):
            w = 1
            h = 1
            push({"globalmax": "glomax", "globalavg": "gloavg", "avgpool": "avg"}[kind])
        elif kind == "split":
            splits = [int(s) for s in block["splits"].split(",")]
            c = splits[-1]
            push("split")
        elif kind in ("softmax", "cost", "region"):
            push(kind)
        elif kind == "reorg":
            stride = int(block["stride"])
            c = stride * stride * c
            w //= stride
            h //= stride
            push("reorg")
        elif kind == "route":
            ind = len(shapes)
            layers = [int(i) if int(i) > 0 else int(i) + ind for i in block["layers"].split(",")]
            if len(layers) == 1:
                src = shapes[layers[0]]
                w, h, c = src.width, src.height, src.filters
            elif len(layers) == 2:
                a, b = shapes[layers[0]], shapes[layers[1]]
                if int(block.get("concat", "1")) == 0:
                    # tuple route (darknet_meta.py:166-168): nothing is
                    # concatenated, so no spatial constraint; the first
                    # element is the feature map that flows onward
                    w, h, c = a.width, a.height, a.filters
                else:
                    if (a.width, a.height) != (b.width, b.height):
                        raise ValueError(
                            f"route at layer {ind}: spatial mismatch {a} vs {b}"
                        )
                    w, h, c = a.width, a.height, a.filters + b.filters
            else:
                raise ValueError("route supports 1 or 2 source layers")
            push("route")
        elif kind == "shortcut":
            ind = len(shapes)
            frm = int(block["from"])
            frm = frm if frm > 0 else frm + ind
            src = shapes[frm]
            w, h, c = src.width, src.height, src.filters
            push("shortcut")
        elif kind == "connected":
            c = int(block["output"])
            w = 1
            h = 1
            push("connected")
        else:
            raise ValueError(f"unknown block type {kind!r}")

    return shapes


def format_net_table(blocks: list[dict[str, str]]) -> str:
    """Human-readable layer table (the reference printed this at startup)."""
    shapes = propagate_shapes(blocks)
    lines = ["layer     filters    size              input                output"]
    prev = LayerShape(
        -1,
        "net",
        int(blocks[0]["width"]),
        int(blocks[0]["height"]),
        int(blocks[0]["channels"]),
    )
    for s, block in zip(shapes, blocks[1:]):
        extra = ""
        if block["type"] == "convolutional":
            extra = f"{block['size']}x{block['size']}/{block['stride']}"
        elif block["type"] in ("maxpool", "reorg"):
            extra = f"/{block.get('stride', '1')}"
        elif block["type"] == "route":
            extra = block["layers"]
        lines.append(
            f"{s.index:5d} {s.kind:<8s} {extra:<10s} "
            f"{prev.width:4d} x{prev.height:4d} x{prev.filters:5d} -> "
            f"{s.width:4d} x{s.height:4d} x{s.filters:5d}"
        )
        prev = s
    return "\n".join(lines)
