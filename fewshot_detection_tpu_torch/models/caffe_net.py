"""Caffe prototxt + caffemodel import (reference models/caffe_net.py:55-331).

The port's own copy of the JAX package's models/caffe_net.py (numpy and
text only; the port's executor, models/darknet.py, runs what it emits, and
models/convert.py carries the numpy HWIO tree it fills onto the device).

Parses a .prototxt network description and converts the layer graph into
darknet block form so the standard NetSpec executor runs it. Supported
layers: Convolution (+BatchNorm/Scale pairs), ReLU (merged into the
producing layer), Pooling (MAX / AVE / global), InnerProduct, Softmax,
Eltwise SUM (-> shortcut), Concat (-> route).

`.caffemodel` weight import (reference caffe_net.py:157-187, which needed a
full caffe runtime there) is implemented here WITHOUT caffe: the file is a
serialized `NetParameter` protobuf whose wire layout is stable, so
`read_caffemodel` decodes it with a ~60-line protobuf-wire reader (both the
new `layer` field 100 and the legacy V1 `layers` field 2), and
`load_caffemodel` fills a converted block graph's conv / BN+scale / fc
params from the named blobs exactly as the reference's
`load_weigths_from_caffe` did (conv weight+bias; BatchNorm running
mean/var divided by the scale factor; Scale gamma/beta; InnerProduct
weight+bias)."""

from __future__ import annotations

import re
import struct

import numpy as np


def parse_prototxt(protofile: str) -> dict:
    """Minimal recursive prototxt parser -> {props, layers: [dict]}.

    Repeated keys (e.g. `top`) collect into lists."""
    with open(protofile) as f:
        text = f.read()
    # strip comments
    text = re.sub(r"#.*", "", text)
    tokens = re.findall(r"\"[^\"]*\"|'[^']*'|[\w.+-]+|[{}:]", text)

    pos = 0

    def parse_block():
        nonlocal pos
        block: dict = {}
        while pos < len(tokens):
            tok = tokens[pos]
            if tok == "}":
                pos += 1
                return block
            key = tok
            pos += 1
            if pos < len(tokens) and tokens[pos] == ":":
                pos += 1
                val = tokens[pos]
                pos += 1
                val = val.strip("\"'")
                _insert(block, key, val)
            elif pos < len(tokens) and tokens[pos] == "{":
                pos += 1
                sub = parse_block()
                _insert(block, key, sub)
            else:
                _insert(block, key, True)
        return block

    def _insert(block, key, val):
        if key in block:
            if not isinstance(block[key], list):
                block[key] = [block[key]]
            block[key].append(val)
        else:
            block[key] = val

    top = parse_block()
    layers = top.pop("layer", [])
    if isinstance(layers, dict):
        layers = [layers]
    return {"props": top, "layers": layers}


def _as_list(v):
    return v if isinstance(v, list) else [v]


def caffe_to_blocks(protofile: str, height: int = 224, width: int = 224,
                    channels: int = 3,
                    meta_out: list | None = None) -> list[dict[str, str]]:
    """Convert a prototxt layer graph into darknet blocks.

    `meta_out`, when given, collects one dict per emitted (non-header)
    block with the contributing caffe layer names ({"conv": n, "bn": n,
    "scale": n} / {"fc": n}) — the key load_caffemodel uses to route
    blobs."""
    net = parse_prototxt(protofile)
    layers = net["layers"]

    blocks: list[dict[str, str]] = [
        {"type": "net", "batch": "1", "height": str(height),
         "width": str(width), "channels": str(channels)}
    ]
    # blob name -> index of the block producing it (in our block list,
    # 0-based over non-header blocks)
    producer: dict[str, int] = {}
    meta = meta_out if meta_out is not None else []

    def top_of(l):
        return _as_list(l.get("top", l.get("name")))[0]

    def bottoms(l):
        return _as_list(l.get("bottom", []))

    def emit(block, top_name, names=None):
        blocks.append(block)
        meta.append(names or {})
        producer[top_name] = len(blocks) - 2  # index among non-header blocks

    i = 0
    while i < len(layers):
        l = layers[i]
        ltype = l.get("type", "")
        if ltype in ("Input", "Data"):
            i += 1
            continue
        if ltype == "Convolution":
            p = l.get("convolution_param", {})
            size = int(p.get("kernel_size", 1))
            block = {
                "type": "convolutional",
                "batch_normalize": "0",
                "filters": str(p.get("num_output")),
                "size": str(size),
                "stride": str(p.get("stride", 1)),
                "pad": "1" if int(p.get("pad", 0)) else "0",
                "activation": "linear",
            }
            # absorb following BatchNorm/Scale/ReLU acting on the same blob
            j = i + 1
            top = top_of(l)
            names = {"conv": l.get("name")}
            while j < len(layers):
                nxt = layers[j]
                if bottoms(nxt) != [top] or top_of(nxt) != top:
                    break
                if nxt.get("type") == "BatchNorm":
                    block["batch_normalize"] = "1"
                    names["bn"] = nxt.get("name")
                elif nxt.get("type") == "Scale":
                    block["batch_normalize"] = "1"
                    names["scale"] = nxt.get("name")
                elif nxt.get("type") == "ReLU":
                    block["activation"] = "relu"
                else:
                    break
                j += 1
            emit(block, top, names)
            i = j
            continue
        if ltype == "ReLU":
            # in-place ReLU on an existing blob: retro-fit the producer
            top = top_of(l)
            src = producer.get(bottoms(l)[0])
            if src is not None and blocks[src + 1]["type"] in ("convolutional",
                                                               "shortcut"):
                blocks[src + 1]["activation"] = "relu"
                producer[top] = src
            i += 1
            continue
        if ltype == "Pooling":
            p = l.get("pooling_param", {})
            if p.get("global_pooling") in ("true", True):
                kind = "globalavg" if p.get("pool", "MAX") == "AVE" else "globalmax"
                emit({"type": kind}, top_of(l))
            else:
                emit(
                    {
                        "type": "maxpool",
                        "size": str(p.get("kernel_size", 2)),
                        "stride": str(p.get("stride", 2)),
                    },
                    top_of(l),
                )
            i += 1
            continue
        if ltype == "InnerProduct":
            p = l.get("inner_product_param", {})
            emit(
                {"type": "connected", "output": str(p.get("num_output")),
                 "activation": "linear"},
                top_of(l),
                {"fc": l.get("name")},
            )
            i += 1
            continue
        if ltype == "Softmax":
            emit({"type": "softmax"}, top_of(l))
            i += 1
            continue
        if ltype == "Eltwise":
            srcs = [producer[b] for b in bottoms(l)]
            cur = len(blocks) - 1  # index of current (to-be) block among non-header
            other = [s for s in srcs if s != cur - 0]
            frm = min(srcs)
            emit(
                {"type": "shortcut", "from": str(frm - len(blocks) + 1),
                 "activation": "linear"},
                top_of(l),
            )
            i += 1
            continue
        if ltype == "Concat":
            srcs = [producer[b] for b in bottoms(l)]
            rel = [str(s - (len(blocks) - 1)) for s in srcs]
            emit({"type": "route", "layers": ",".join(rel)}, top_of(l))
            i += 1
            continue
        if ltype == "Dropout":
            producer[top_of(l)] = producer.get(bottoms(l)[0], len(blocks) - 2)
            i += 1
            continue
        raise NotImplementedError(f"caffe layer type {ltype!r} not supported")

    return blocks


def build_caffe_spec(protofile: str, height: int = 224, width: int = 224,
                     channels: int = 3):
    from .spec import build_spec

    return build_spec(caffe_to_blocks(protofile, height, width, channels))


# ---------------------------------------------------------------------------
# .caffemodel (NetParameter protobuf) decoding — no caffe runtime needed
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one protobuf message.
    Length-delimited values come back as bytes; varints as int; fixed32/64
    as raw 4/8-byte slices."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:  # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _decode_blob(buf: bytes) -> np.ndarray:
    """BlobProto: data=5 (packed/unpacked float), double_data=8,
    shape=7 (BlobShape dim=1 packed varint), legacy num/ch/h/w = 1-4."""
    data: list[np.ndarray] = []
    shape: list[int] = []
    legacy = {}
    for field, wire, val in _iter_fields(buf):
        if field == 5:  # float data
            if wire == 2:
                data.append(np.frombuffer(val, "<f4"))
            else:
                data.append(np.frombuffer(bytes(val), "<f4"))
        elif field == 8:  # double data
            if wire == 2:
                data.append(np.frombuffer(val, "<f8").astype(np.float32))
        elif field == 7 and wire == 2:  # BlobShape
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        p = 0
                        while p < len(v2):
                            d, p = _read_varint(v2, p)
                            shape.append(d)
                    else:
                        shape.append(v2)
        elif field in (1, 2, 3, 4) and wire == 0:  # legacy dims
            legacy[field] = val
    arr = np.concatenate(data) if data else np.zeros(0, np.float32)
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


# V1LayerParameter.type enum values we care about (caffe.proto)
_V1_TYPES = {4: "Convolution", 14: "InnerProduct", 17: "Pooling",
             18: "ReLU", 20: "Softmax", 5: "Data", 33: "Eltwise", 3: "Concat"}


def read_caffemodel(path: str) -> dict[str, dict]:
    """Decode a .caffemodel into {layer_name: {"type": str, "blobs": [np]}}.
    Handles both the modern `layer` (field 100, LayerParameter: name=1,
    type=2, blobs=7) and legacy `layers` (field 2, V1LayerParameter:
    name=4, type=5 enum, blobs=6) encodings."""
    with open(path, "rb") as f:
        buf = f.read()
    out: dict[str, dict] = {}
    for field, wire, val in _iter_fields(buf):
        if field == 100 and wire == 2:  # LayerParameter
            name, ltype, blobs = None, None, []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    name = v2.decode()
                elif f2 == 2:
                    ltype = v2.decode()
                elif f2 == 7:
                    blobs.append(_decode_blob(v2))
            if name:
                out[name] = {"type": ltype, "blobs": blobs}
        elif field == 2 and wire == 2:  # V1LayerParameter
            name, ltype, blobs = None, None, []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 4:
                    name = v2.decode()
                elif f2 == 5:
                    ltype = _V1_TYPES.get(v2, str(v2))
                elif f2 == 6:
                    blobs.append(_decode_blob(v2))
            if name:
                out[name] = {"type": ltype, "blobs": blobs}
    return out


def load_caffemodel(protofile: str, caffemodel: str, params,
                    height: int = 224, width: int = 224, channels: int = 3):
    """Fill a converted block graph's params from a .caffemodel.

    Mirrors the reference's load_weigths_from_caffe (caffe_net.py:157-187):
    conv weight (OIHW -> our HWIO) + optional bias; BatchNorm running
    mean/var divided by the scale-factor blob, Scale gamma/beta; fc weight
    ((out,in) -> our (in,out)) + bias. `params` is the numpy tree from
    init_params over build_caffe_spec(protofile) and is returned updated
    (models/convert.from_jax_params puts it on the device).
    """
    meta: list = []
    blocks = caffe_to_blocks(protofile, height, width, channels, meta_out=meta)
    net_params = read_caffemodel(caffemodel)
    new_params = list(params)

    for idx, (block, names) in enumerate(zip(blocks[1:], meta)):
        p = dict(new_params[idx]) if new_params[idx] else None
        if block["type"] == "convolutional" and names.get("conv"):
            entry = net_params.get(names["conv"])
            if entry is None:
                continue
            blobs = entry["blobs"]
            w = blobs[0].reshape(p["w"].shape[3], p["w"].shape[2],
                                 p["w"].shape[0], p["w"].shape[1])
            p["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
            if len(blobs) > 1 and "bn" not in p:
                p["b"] = blobs[1].reshape(-1)
            if "bn" in p and names.get("bn") in net_params:
                bn_blobs = net_params[names["bn"]]["blobs"]
                sf = float(bn_blobs[2].reshape(-1)[0]) if len(bn_blobs) > 2 else 1.0
                sf = 1.0 / sf if sf != 0 else 0.0
                bn = dict(p["bn"])
                bn["mean"] = bn_blobs[0].reshape(-1) * sf
                bn["var"] = bn_blobs[1].reshape(-1) * sf
                if names.get("scale") in net_params:
                    sc = net_params[names["scale"]]["blobs"]
                    bn["gamma"] = sc[0].reshape(-1)
                    if len(sc) > 1:
                        bn["beta"] = sc[1].reshape(-1)
                p["bn"] = {k: np.asarray(v, np.float32) for k, v in bn.items()}
            new_params[idx] = {
                k: (v if isinstance(v, dict) else np.asarray(v, np.float32))
                for k, v in p.items()
            }
        elif block["type"] == "connected" and names.get("fc"):
            entry = net_params.get(names["fc"])
            if entry is None:
                continue
            blobs = entry["blobs"]
            w = blobs[0].reshape(p["w"].shape[1], p["w"].shape[0])
            p["w"] = np.ascontiguousarray(w.T).astype(np.float32)
            if len(blobs) > 1:
                p["b"] = blobs[1].reshape(-1).astype(np.float32)
            new_params[idx] = p
    return new_params
