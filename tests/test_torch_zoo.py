"""The port's framework-free model builders (`models/zoo.py`,
`models/caffe_net.py`) and `ops/focal_loss.py` against the JAX package's,
on the CPU.

- zoo and caffe_net: the block lists, the compiled specs and (for a
  `.caffemodel`, in the modern and the legacy encoding) the numpy
  parameter trees EQUAL; the port's executor runs each built network on the
  same input and parameters as the JAX package's within 1e-5 of the
  largest output (float32 convolutions sum in another order).
- focal_loss: values and gradients with respect to the logits within 1e-6
  relative, with and without alpha, averaged and summed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.models import caffe_net as j_caffe
from fewshot_detection_tpu.models import zoo as j_zoo
from fewshot_detection_tpu.models.darknet import apply_network as j_apply
from fewshot_detection_tpu.ops.focal_loss import focal_loss as j_focal_loss
from fewshot_detection_tpu_torch.models import caffe_net, zoo
from fewshot_detection_tpu_torch.models.convert import from_jax_params
from fewshot_detection_tpu_torch.models.darknet import apply_network, init_params
from fewshot_detection_tpu_torch.ops.focal_loss import focal_loss

from test_caffe import PROTO, PROTO_BN, _layer_new, _layer_v1, _make_blobs
from torch_port_util import t, to_jnp_tree

FWD_TOL = 1e-5


def _same_spec(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _same_forward(spec, jspec, params, x):
    got, _ = apply_network(spec, from_jax_params(spec, params, "cpu"), t(x))
    want, _ = j_apply(jspec, to_jnp_tree(params), jnp.asarray(x))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_TOL * np.abs(want).max())
    return want


def test_tiny_yolo_equals_jax():
    assert zoo.tiny_yolo_blocks(7, 3) == j_zoo.tiny_yolo_blocks(7, 3)
    spec, jspec = zoo.tiny_yolo_spec(), j_zoo.tiny_yolo_spec()
    _same_spec(spec, jspec)
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    assert _same_forward(spec, jspec, init_params(spec, 0), x).shape == (1, 2, 2, 125)


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_resnet_equals_jax(depth):
    assert zoo.resnet_blocks(depth, 10, 64) == j_zoo.resnet_blocks(depth, 10, 64)
    spec, jspec = zoo.resnet_spec(depth, 10), j_zoo.resnet_spec(depth, 10)
    _same_spec(spec, jspec)
    if depth in (18, 50):
        x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
        y = _same_forward(spec, jspec, init_params(spec, 1), x)
        np.testing.assert_allclose(y.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("proto", [PROTO, PROTO_BN], ids=["toy", "toybn"])
def test_caffe_graph_equals_jax(tmp_path, proto):
    path = tmp_path / "net.prototxt"
    path.write_text(proto)
    assert caffe_net.parse_prototxt(str(path)) == j_caffe.parse_prototxt(str(path))
    meta, jmeta = [], []
    blocks = caffe_net.caffe_to_blocks(str(path), 32, 32, meta_out=meta)
    assert blocks == j_caffe.caffe_to_blocks(str(path), 32, 32, meta_out=jmeta)
    assert meta == jmeta
    spec = caffe_net.build_caffe_spec(str(path), 32, 32)
    jspec = j_caffe.build_caffe_spec(str(path), 32, 32)
    _same_spec(spec, jspec)
    x = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    _same_forward(spec, jspec, init_params(spec, 0), x)


@pytest.mark.parametrize("encoding", ["modern", "legacy_v1"])
def test_caffemodel_equals_jax(tmp_path, encoding):
    blobs = _make_blobs(np.random.RandomState(3))
    if encoding == "modern":
        model = (_layer_new("conv1", "Convolution", [blobs["conv_w"]])
                 + _layer_new("bn1", "BatchNorm", [blobs["bn_mean"], blobs["bn_var"], blobs["sf"]])
                 + _layer_new("scale1", "Scale", [blobs["gamma"], blobs["beta"]])
                 + _layer_new("fc", "InnerProduct", [blobs["fc_w"], blobs["fc_b"]]))
    else:
        model = (_layer_v1("conv1", 4, [blobs["conv_w"]])
                 + _layer_v1("bn1", 0, [blobs["bn_mean"], blobs["bn_var"], blobs["sf"]])
                 + _layer_v1("scale1", 0, [blobs["gamma"], blobs["beta"]])
                 + _layer_v1("fc", 14, [blobs["fc_w"], blobs["fc_b"]]))
    proto, cm = tmp_path / "toybn.prototxt", tmp_path / "toybn.caffemodel"
    proto.write_text(PROTO_BN)
    cm.write_bytes(model)

    got_raw, want_raw = caffe_net.read_caffemodel(str(cm)), j_caffe.read_caffemodel(str(cm))
    assert sorted(got_raw) == sorted(want_raw)
    for name in want_raw:
        for g, w in zip(got_raw[name]["blobs"], want_raw[name]["blobs"], strict=True):
            np.testing.assert_array_equal(g, w)

    spec = caffe_net.build_caffe_spec(str(proto), 8, 8)
    init = init_params(spec, 0)
    got = caffe_net.load_caffemodel(str(proto), str(cm), init, 8, 8)
    want = j_caffe.load_caffemodel(str(proto), str(cm), init, 8, 8)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    x = np.random.default_rng(4).random((1, 8, 8, 3), dtype=np.float32)
    _same_forward(spec, j_caffe.build_caffe_spec(str(proto), 8, 8), got, x)


@pytest.mark.parametrize("gamma", [0.0, 2.0, 0.5])
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("size_average", [True, False])
def test_focal_loss_values_and_gradients_equal_jax(gamma, alpha, size_average):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((12, 6)) * 3).astype(np.float32)
    targets = rng.integers(0, 6, 12)
    a = rng.uniform(0.25, 1.0, 6).astype(np.float32) if alpha else None

    def j_loss(x):
        return j_focal_loss(x, jnp.asarray(targets), gamma, None if a is None else jnp.asarray(a),
                            size_average)

    want, want_grad = jax.value_and_grad(j_loss)(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    got = focal_loss(x, torch.from_numpy(targets), gamma, None if a is None else t(a),
                     size_average)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0,
                               atol=1e-6 * np.abs(want_grad).max())
