"""Parameter carrying and the `.weights` codec of the PyTorch port."""

import gzip
import os

import numpy as np
import pytest
import torch

from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import weights_io as j_wio
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import weights_io as t_wio
from fewshot_detection_tpu_torch.models.convert import from_jax_params, to_jax_params
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
from fewshot_detection_tpu_torch.models.spec import build_spec

from torch_port_util import REPO, cfg, jax_spec_fields, randomize_bn


def _assert_tree_equal(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        if p is None:
            assert q is None
            continue
        assert set(p) == set(q)
        for k in p:
            if k == "bn":
                for s in p["bn"]:
                    np.testing.assert_array_equal(p["bn"][s], q["bn"][s])
            else:
                np.testing.assert_array_equal(p[k], q[k])


@pytest.mark.parametrize("name", ["tiny_darknet_dynamic.cfg", "tiny_reweighting.cfg", "tiny-yolo-voc.cfg"])
def test_params_round_trip(name):
    spec = build_spec(parse_cfg(cfg(name)))
    params = randomize_bn(init_params(spec, 3), np.random.default_rng(4))
    tree = from_jax_params(spec, params, device="cpu")
    for layer, p in zip(spec.layers, tree):
        if p and "w" in p and layer.kind == "conv" and not layer.dynamic:
            hwio = params[layer.index]["w"]
            assert tuple(p["w"].shape) == (hwio.shape[3], hwio.shape[2], hwio.shape[0], hwio.shape[1])
            assert p["w"].dtype == torch.float32
    _assert_tree_equal(to_jax_params(spec, tree), params)


def test_spec_equals_jax_spec():
    """The port's own copy of the cfg compiler gives the JAX package's spec."""
    import dataclasses

    for name in ("darknet_dynamic.cfg", "reweighting_net.cfg", "tiny_darknet_dynamic.cfg"):
        a = build_spec(parse_cfg(cfg(name)))
        b = j_build_spec(j_parse_cfg(cfg(name)))
        assert jax_spec_fields(a) == dataclasses.asdict(b)


def test_weights_file_byte_equal_to_jax_package(tmp_path):
    spec = MetaSpec(build_spec(parse_cfg(cfg("tiny_darknet_dynamic.cfg"))),
                    build_spec(parse_cfg(cfg("tiny_reweighting.cfg"))))
    params = init_meta_params(spec, 1)
    randomize_bn(params["darknet"], np.random.default_rng(5))
    randomize_bn(params["learnet"], np.random.default_rng(6))
    specs = [spec.darknet, spec.learnet]
    trees = [params["darknet"], params["learnet"]]
    a, b = str(tmp_path / "a.weights"), str(tmp_path / "b.weights")
    t_wio.save_weights(a, specs, trees, seen=4242)
    jspecs = [j_build_spec(j_parse_cfg(cfg("tiny_darknet_dynamic.cfg"))),
              j_build_spec(j_parse_cfg(cfg("tiny_reweighting.cfg")))]
    j_wio.save_weights(b, jspecs, trees, seen=4242)
    assert open(a, "rb").read() == open(b, "rb").read()

    blank = [init_params(s, 9) for s in specs]
    (dp, lp), header = t_wio.load_weights(a, specs, blank)
    assert header.seen == 4242
    _assert_tree_equal(dp, params["darknet"])
    _assert_tree_equal(lp, params["learnet"])
    (jdp, jlp), jheader = j_wio.load_weights(b, jspecs, blank)
    assert jheader.seen == header.seen
    _assert_tree_equal(dp, jdp)
    _assert_tree_equal(lp, jlp)


def test_truncated_weights_load_a_prefix(tmp_path):
    spec = build_spec(parse_cfg(cfg("tiny_darknet_dynamic.cfg")))
    params = init_params(spec, 1)
    path = str(tmp_path / "cut.weights")
    t_wio.save_weights(path, [spec], [params], seen=7, cutoff=3)
    blank = init_params(spec, 2)
    (got,), _ = t_wio.load_weights(path, [spec], [blank])
    np.testing.assert_array_equal(got[0]["w"], params[0]["w"])
    np.testing.assert_array_equal(got[4]["w"], blank[4]["w"])


def test_bf16_gz_reader(tmp_path):
    rng = np.random.default_rng(0)
    payload = rng.standard_normal(1000).astype(np.float32)
    header = np.array([0, 2, 0, 123456], np.int32)
    u = payload.view(np.uint32)
    bf16 = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    path = str(tmp_path / "x.weights.bf16.gz")
    with gzip.open(path, "wb") as f:
        f.write(header.tobytes() + bf16.tobytes())
    blob = t_wio.read_bf16_gz(path)
    assert np.frombuffer(blob[:16], np.int32)[3] == 123456
    got = np.frombuffer(blob[16:], np.float32)
    want = (bf16.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(got, want)
    # truncation to bf16 keeps 8 bits of mantissa
    assert np.max(np.abs(got - payload) / np.abs(payload)) < 2 ** -8


def test_tracked_artifact_header_reads_seen():
    """Header of the tracked flagship checkpoint, without widening the
    payload (which is 100 MB)."""
    path = os.path.join(REPO, "artifacts/flagship_base_novel0/base_latest.weights.bf16.gz")
    with gzip.open(path, "rb") as f:
        head = f.read(16)
    assert t_wio.WeightsHeader(*np.frombuffer(head, np.int32)).seen == 59220
