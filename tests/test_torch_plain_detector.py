"""`PlainDetector` of the PyTorch port against the JAX package's, on the CPU.

The reference network is cfg/yolo-voc.cfg at full width (Darknet-19, reorg
and route, the 125-channel region head), cut to 64x64 pixels; tiny-yolo-voc
adds the stride-1 maxpool. One `.weights` file with random BN statistics
goes to both detectors, which fold BN into the convolutions once at load.
float32: the raw head outputs agree to rtol 1e-4 with a floor of 1e-4 of the
largest value (the port's usual tolerance; convolution sums run in another
order). bfloat16 rounds the FOLDED weights, so it agrees with JAX's bfloat16
only in kind; it is held against the port's own float32 within 5e-2 of the
largest value."""

import gzip

import numpy as np
import pytest
import torch

from fewshot_detection_tpu.eval.detector import PlainDetector as JPlainDetector
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.eval.detector import PlainDetector
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec

from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import cfg, randomize_bn

SIZE = 64


def _cfg_at(src, dst, size):
    with open(cfg(src)) as f:
        txt = f.read()
    with open(dst, "w") as f:
        f.write(txt.replace("height=416", f"height={size}").replace("width=416", f"width={size}"))
    return dst


@pytest.fixture(scope="module", params=["yolo-voc.cfg", "tiny-yolo-voc.cfg"])
def net(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("plain_det")
    netcfg = _cfg_at(request.param, str(root / request.param), SIZE)
    spec = build_spec(parse_cfg(netcfg))
    params = init_params(spec, 1)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.45  # keep activations O(1) through the stack
    randomize_bn(params, np.random.default_rng(2))
    weights = str(root / "net.weights")
    weights_io.save_weights(weights, [spec], [params], seen=640)
    images = np.random.default_rng(3).random((2, SIZE, SIZE, 3), dtype=np.float32)
    return dict(cfg=netcfg, weights=weights, images=images, name=request.param)


@pytest.fixture(scope="module")
def f32_detector(net):
    return PlainDetector(net["cfg"], net["weights"], device="cpu")


@pytest.fixture(scope="module")
def f32_output(net, f32_detector):
    return f32_detector(net["images"])


def test_float32_output_matches_jax(net, f32_output):
    want = np.asarray(JPlainDetector(net["cfg"], net["weights"])(net["images"]))
    got = f32_output
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == want.shape == (2, SIZE // 32, SIZE // 32, 125)
    scale = np.abs(want).max()
    assert scale > 1.0  # not a collapsed output
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)


def test_bfloat16_output_stays_near_float32(net, f32_output):
    m = PlainDetector(net["cfg"], net["weights"], compute_dtype=torch.bfloat16, device="cpu")
    got = m(net["images"])
    assert got.dtype == torch.float32
    want = f32_output.numpy()
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert 0 < err <= 5e-2


def test_loader_reads_header_folds_bn_and_keeps_the_geometry(f32_detector):
    m = f32_detector
    assert m.header.seen == 640
    assert (m.width, m.height) == (SIZE, SIZE) and m.region.num_classes == 20
    assert all("bn" not in p for p in m.params if p)
    assert not any(l.batch_normalize for l in m.fspec.layers)


def test_bf16_gz_checkpoint_loads_like_its_widened_weights(tmp_path):
    """A `.weights.bf16.gz` is read directly: the same detector as the
    `.weights` file holding the widened bfloat16 values (the small plain
    cfg of the end-to-end test keeps the file small)."""
    netcfg = str(tmp_path / "tiny_plain.cfg")
    with open(netcfg, "w") as f:
        f.write(TINY_PLAIN_CFG)
    spec = build_spec(parse_cfg(netcfg))
    params = randomize_bn(init_params(spec, 4), np.random.default_rng(5))
    weights = str(tmp_path / "net.weights")
    weights_io.save_weights(weights, [spec], [params], seen=320)
    raw = np.fromfile(weights, np.uint8)
    header, payload = raw[:16], raw[16:].view(np.float32)
    u = payload.view(np.uint32)
    bf16 = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    gz = str(tmp_path / "net.weights.bf16.gz")
    with gzip.open(gz, "wb") as f:
        f.write(header.tobytes() + bf16.tobytes())
    wide = str(tmp_path / "wide.weights")
    np.concatenate([header, (bf16.astype(np.uint32) << 16).view(np.uint8)]).tofile(wide)
    images = np.random.default_rng(6).random((2, 96, 96, 3), dtype=np.float32)
    a = PlainDetector(netcfg, gz, device="cpu")
    b = PlainDetector(netcfg, wide, device="cpu")
    assert a.header.seen == b.header.seen == 320
    assert torch.equal(a(images), b(images))


def test_entry_point_defaults_to_cuda_and_raises_without_one(net):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlainDetector(net["cfg"], net["weights"])
