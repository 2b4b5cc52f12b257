"""Darknet binary `.weights` codec — bit-compatible with the reference.

File layout (reference cfg.py:411-481, darknet_meta.py:355-479):
  * 4 x int32 header; header[3] is the `seen` sample counter
  * raw float32 stream, walked in block order — for the meta detector the
    backbone blocks first, then the learnet blocks, from the same buffer
  * per conv+BN layer:  bn.beta, bn.gamma, running_mean, running_var,
    conv.weight (torch OIHW order)
  * per plain conv:     [bias,] conv.weight
  * per connected:      bias, weight (torch (out, in) order)
  * dynamic convs without a `partial` shared weight store nothing; with
    `partial` they store the shared (partial, kH, kW) weight
  * loading stops when the buffer is exhausted at a block boundary — this is
    how `darknet19_448.conv.23` style truncated files initialize a prefix

This module converts between that stream and the numpy NHWC/HWIO parameter
tree (the layout of the JAX package, so a checkpoint means the same to both);
`models.convert.from_jax_params` turns that tree into device tensors.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .spec import LayerSpec, NetSpec

Params = list  # list[dict | None], aligned with NetSpec.layers


@dataclasses.dataclass
class WeightsHeader:
    major: int = 0
    minor: int = 0
    revision: int = 0
    seen: int = 0

    def to_array(self) -> np.ndarray:
        return np.array([self.major, self.minor, self.revision, self.seen], np.int32)


class _Reader:
    def __init__(self, buf: np.ndarray):
        self.buf = buf
        self.pos = 0

    @property
    def exhausted(self) -> bool:
        return self.pos >= self.buf.size

    def take(self, n: int) -> np.ndarray:
        if self.pos + n > self.buf.size:
            raise ValueError(
                f"weights buffer underrun: need {n} floats at {self.pos}, "
                f"have {self.buf.size}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


def _conv_weight_numel(layer: LayerSpec) -> int:
    if layer.dynamic:
        return (layer.partial or 0) * layer.size * layer.size
    return (
        layer.out_channels
        * (layer.in_channels // layer.groups)
        * layer.size
        * layer.size
    )


def _read_bn(reader: _Reader, c: int) -> dict:
    return {
        "beta": reader.take(c).copy(),
        "gamma": reader.take(c).copy(),
        "mean": reader.take(c).copy(),
        "var": reader.take(c).copy(),
    }


def _read_conv(reader: _Reader, layer: LayerSpec, p: dict) -> dict:
    p = dict(p) if p else {}
    if layer.dynamic:
        # mirror load_conv_bn on (BN, partial weight) — darknet_meta.py:376-381
        if layer.batch_normalize:
            p["bn"] = _read_bn(reader, layer.out_channels)
        w = reader.take(_conv_weight_numel(layer)).reshape(
            layer.partial, layer.size, layer.size
        )
        p["w"] = np.ascontiguousarray(w.transpose(1, 2, 0))  # (kh, kw, partial)
        return p
    cin = layer.in_channels // layer.groups
    if layer.batch_normalize:
        p["bn"] = _read_bn(reader, layer.out_channels)
    elif layer.bias:
        p["b"] = reader.take(layer.out_channels).copy()
    w = reader.take(_conv_weight_numel(layer)).reshape(
        layer.out_channels, cin, layer.size, layer.size
    )
    p["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    return p


def _read_fc(reader: _Reader, layer: LayerSpec, p: dict) -> dict:
    p = dict(p) if p else {}
    p["b"] = reader.take(layer.out_channels).copy()
    w = reader.take(layer.in_channels * layer.out_channels).reshape(
        layer.out_channels, layer.in_channels
    )
    p["w"] = np.ascontiguousarray(w.T)  # (out, in) -> (in, out)
    return p


def load_buffer(
    reader: _Reader, spec: NetSpec, params: Params
) -> Params:
    """Fill `params` (copied) from the reader, stopping at buffer end."""
    new_params = list(params)
    for layer in spec.layers:
        if reader.exhausted:
            break
        if layer.kind == "conv":
            if layer.dynamic and layer.partial is None:
                continue  # weight-less dynamic conv (darknet_meta.py:374)
            new_params[layer.index] = _read_conv(reader, layer, new_params[layer.index])
        elif layer.kind == "connected":
            new_params[layer.index] = _read_fc(reader, layer, new_params[layer.index])
    return new_params


def load_weights(
    path: str, specs: list[NetSpec], params_list: list[Params]
) -> tuple[list[Params], WeightsHeader]:
    """Load a `.weights` file into one or more networks sharing the buffer.

    For the meta detector pass [darknet_spec, learnet_spec]; the stream is
    walked backbone-first then learnet (darknet_meta.py:364)."""
    with open(path, "rb") as fp:
        header_arr = np.fromfile(fp, count=4, dtype=np.int32)
        buf = np.fromfile(fp, dtype=np.float32)
    header = WeightsHeader(*(int(v) for v in header_arr))
    reader = _Reader(buf)
    out = [load_buffer(reader, spec, params) for spec, params in zip(specs, params_list)]
    return out, header


def _write_bn(chunks: list[np.ndarray], bn: dict) -> None:
    for key in ("beta", "gamma", "mean", "var"):
        chunks.append(np.asarray(bn[key], np.float32).ravel())


def _write_conv(chunks: list[np.ndarray], layer: LayerSpec, p: dict) -> None:
    if layer.dynamic:
        if layer.batch_normalize:
            _write_bn(chunks, p["bn"])
        w = np.asarray(p["w"], np.float32)
        chunks.append(np.ascontiguousarray(w.transpose(2, 0, 1)).ravel())
        return
    if layer.batch_normalize:
        _write_bn(chunks, p["bn"])
    elif "b" in p:
        chunks.append(np.asarray(p["b"], np.float32).ravel())
    w = np.asarray(p["w"], np.float32)
    chunks.append(np.ascontiguousarray(w.transpose(3, 2, 0, 1)).ravel())  # HWIO->OIHW


def _write_fc(chunks: list[np.ndarray], p: dict) -> None:
    chunks.append(np.asarray(p["b"], np.float32).ravel())
    chunks.append(np.ascontiguousarray(np.asarray(p["w"], np.float32).T).ravel())


def save_weights(
    path: str,
    specs: list[NetSpec],
    params_list: list[Params],
    seen: int = 0,
    cutoff: int = 0,
) -> None:
    """Write a `.weights` file. `cutoff` truncates after that many layers
    counted across all networks (partial.py-style backbone extraction);
    0 means everything."""
    total_layers = sum(len(s.layers) for s in specs)
    if cutoff <= 0:
        cutoff = total_layers
    chunks: list[np.ndarray] = [WeightsHeader(seen=seen).to_array().view(np.float32)]
    written = 0
    for spec, params in zip(specs, params_list):
        for layer in spec.layers:
            if written >= cutoff:
                break
            written += 1
            if layer.kind == "conv":
                if layer.dynamic and layer.partial is None:
                    continue
                _write_conv(chunks, layer, params[layer.index])
            elif layer.kind == "connected":
                _write_fc(chunks, params[layer.index])
    # atomic write: a SIGKILL mid-save (host OOM, a killed worker) must
    # never leave a truncated .weights behind — the codec deliberately
    # accepts short buffers (prefix loading, darknet_meta.py:367), so a
    # partial checkpoint would silently resume with random tail layers
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fp:
        np.concatenate(chunks).tofile(fp)
    os.replace(tmp, path)


def read_bf16_gz(path: str) -> bytes:
    """Decode a tracked ``.weights.bf16.gz`` artifact into `.weights` bytes.

    The artifact is a gzip stream holding the 16-byte int32 header as it
    was, followed by the float payload truncated to bfloat16 (the upper 16
    bits of each float32, as uint16). Widening puts those bits back on top
    of a zero mantissa tail, which is exact."""
    import gzip

    with gzip.open(path, "rb") as fi:
        blob = fi.read()
    if len(blob) < 16 or (len(blob) - 16) % 2:
        raise ValueError(f"{path}: not a bf16 .weights artifact")
    payload = np.frombuffer(blob, dtype=np.uint16, offset=16).astype(np.uint32) << 16
    return blob[:16] + payload.tobytes()


def load_weights_bf16_gz(
    path: str, specs: list[NetSpec], params_list: list[Params]
) -> tuple[list[Params], WeightsHeader]:
    """`load_weights` for a ``.weights.bf16.gz`` artifact, without a
    temporary file."""
    blob = read_bf16_gz(path)
    header = WeightsHeader(*(int(v) for v in np.frombuffer(blob, np.int32, 4)))
    reader = _Reader(np.frombuffer(blob, np.float32, offset=16))
    out = [load_buffer(reader, spec, params) for spec, params in zip(specs, params_list)]
    return out, header
