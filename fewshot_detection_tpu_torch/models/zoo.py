"""Auxiliary model builders (reference models/ directory — off the main
path but part of the surface: models/tiny_yolo.py, models/resnet.py).

The port's own copy of the JAX package's models/zoo.py. Instead of
hand-coding module graphs, these emit darknet block lists and reuse the
compiled NetSpec executor (models/darknet.py) — the whole zoo rides the same
cfg -> spec -> executor pipeline (and the same .weights codec) as the
detector.
"""

from __future__ import annotations

from .spec import NetSpec, build_spec

VOC_ANCHORS = "1.08,1.19,3.42,4.41,6.63,11.38,9.42,5.11,16.62,10.52"


def _conv(filters, size=3, stride=1, bn=True, act="leaky", **extra):
    b = {
        "type": "convolutional",
        "batch_normalize": "1" if bn else "0",
        "filters": str(filters),
        "size": str(size),
        "stride": str(stride),
        "pad": "1",
        "activation": act,
    }
    b.update({k: str(v) for k, v in extra.items()})
    return b


def _maxpool(size=2, stride=2):
    return {"type": "maxpool", "size": str(size), "stride": str(stride)}


def tiny_yolo_blocks(num_classes: int = 20, num_anchors: int = 5) -> list[dict]:
    """Hardcoded TinyYOLO-VOC (models/tiny_yolo.py:9-70): 8 conv+BN+leaky
    stages with maxpools (the 6th is stride-1), then a linear 1x1 head."""
    num_output = (5 + num_classes) * num_anchors
    blocks = [
        {"type": "net", "batch": "1", "height": "416", "width": "416",
         "channels": "3"},
    ]
    for i, filters in enumerate([16, 32, 64, 128, 256, 512]):
        blocks.append(_conv(filters))
        blocks.append(_maxpool(2, 1 if filters == 512 else 2))
    blocks.append(_conv(1024))
    blocks.append(_conv(1024))
    blocks.append(_conv(num_output, size=1, bn=False, act="linear"))
    blocks.append(
        {
            "type": "region",
            "anchors": VOC_ANCHORS,
            "classes": str(num_classes),
            "num": str(num_anchors),
            "object_scale": "5",
            "noobject_scale": "1",
            "class_scale": "1",
            "coord_scale": "1",
            "thresh": "0.6",
        }
    )
    return blocks


def tiny_yolo_spec(num_classes: int = 20) -> NetSpec:
    return build_spec(tiny_yolo_blocks(num_classes))


# ---------------------------------------------------------------------------
# ResNet family via shortcut blocks (models/resnet.py equivalent)
# ---------------------------------------------------------------------------

_RESNET_LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}


def resnet_blocks(depth: int = 18, num_classes: int = 1000,
                  image_size: int = 224) -> list[dict]:
    """ResNet as darknet blocks: conv/shortcut/avgpool/connected/softmax.

    Projection shortcuts are expressed as an extra 1x1 conv on a `route`
    back to the block input followed by `shortcut` to the main branch —
    the same graph the torch version builds, flattened into block form."""
    kind, stages = _RESNET_LAYERS[depth]
    blocks = [
        {"type": "net", "batch": "1", "height": str(image_size),
         "width": str(image_size), "channels": "3"},
        _conv(64, size=7, stride=2, act="relu"),
        _maxpool(2, 2),  # approximation of the 3x3/2 padded maxpool
    ]
    widths = [64, 128, 256, 512]
    expansion = 1 if kind == "basic" else 4

    for si, (w, n_blocks) in enumerate(zip(widths, stages)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            needs_proj = bi == 0 and (si > 0 or expansion != 1)
            if kind == "basic":
                body = [
                    _conv(w, size=3, stride=stride, act="relu"),
                    _conv(w, size=3, stride=1, act="linear"),
                ]
            else:
                body = [
                    _conv(w, size=1, stride=1, act="relu"),
                    _conv(w, size=3, stride=stride, act="relu"),
                    _conv(w * expansion, size=1, stride=1, act="linear"),
                ]
            blocks.extend(body)
            if needs_proj:
                # route back to the block input, project, shortcut to body end
                blocks.append({"type": "route",
                               "layers": str(-(len(body) + 1))})
                blocks.append(
                    _conv(w * expansion, size=1, stride=stride, act="linear")
                )
                # add the projected input (prev layer) to the body output
                blocks.append({"type": "shortcut", "from": "-3",
                               "activation": "relu"})
            else:
                blocks.append({"type": "shortcut",
                               "from": str(-(len(body) + 1)),
                               "activation": "relu"})
    blocks.append({"type": "avgpool"})
    blocks.append({"type": "connected", "output": str(num_classes),
                   "activation": "linear"})
    blocks.append({"type": "softmax"})
    return blocks


def resnet_spec(depth: int = 18, num_classes: int = 1000) -> NetSpec:
    return build_spec(resnet_blocks(depth, num_classes))
