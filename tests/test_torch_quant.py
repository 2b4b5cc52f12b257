"""int8 serving of the PyTorch port (`models/quant.py`, `ops/int8_mm.py`,
`models/meta.py:fused_reweight_head_int8`) against the JAX package's, on the
CPU, on one numpy parameter tree and one numpy input.

The JAX package serves through `jax.jit` with the activation scales baked
in, and XLA rewrites a division by a constant as a product with the float32
reciprocal: the reference's int8 codes are those of the jitted functions,
which the port reproduces on purpose (a true division differs on a few
codes of every input here, see `test_codes_follow_the_jitted_reference`).

- `quantize_weights`: int8 weights and scales EQUAL (a channel of zeros
  takes the scale 1.0).
- `conv_int8` and `fused_reweight_head_int8` (15 classes: N = 450, padded
  to 456 on the card; 20 classes: 600) fed the same float input: the int8
  codes and the int32 products EQUAL; the float output within 1e-6 of its
  largest value (float32 dequantization in another order). In bfloat16 the
  conv's output is held to one bfloat16 step (2^-8) of its largest value:
  the JAX package's bfloat16 leaky slope is 0.1 rounded to bfloat16
  (0.10009765625), PyTorch's the float32 0.1, so negative outputs may round
  one step apart after the same float32 dequantization.
- `calibrate_act_scales`: the scales within 1e-6 relative (float32
  convolutions sum in another order on the two sides).
- `int8_matmul`'s padding to `torch._int_mm`'s shape rules, run through
  `torch._int_mm` on the CPU: equal to the plain int64 product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import meta as j_meta
from fewshot_detection_tpu.models import quant as j_quant
from fewshot_detection_tpu.models.darknet import fold_batchnorm as j_fold
from fewshot_detection_tpu.models.darknet import folded_spec as j_folded_spec
from fewshot_detection_tpu.models.darknet import init_params as j_init_params
from fewshot_detection_tpu.models.spec import LayerSpec as JLayerSpec
from fewshot_detection_tpu.models.spec import NetSpec as JNetSpec
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import quant
from fewshot_detection_tpu_torch.models.convert import from_jax_params
from fewshot_detection_tpu_torch.models.darknet import folded_spec
from fewshot_detection_tpu_torch.models.meta import (
    fused_reweight_head_int8,
    head_int8_operands,
)
from fewshot_detection_tpu_torch.models.spec import LayerSpec, build_spec
from fewshot_detection_tpu_torch.ops.int8_mm import (
    im2col,
    int8_matmul,
    int8_matmul_reference,
    padded_int_mm,
)

from torch_port_util import cfg, randomize_bn, t

REL = 1e-6


def _folded_tree(name, seed):
    """A folded float32 numpy tree of cfg `name` (random BN statistics, one
    output channel of conv 2 all zeros) and the specs of both sides."""
    jspec = j_build_spec(j_parse_cfg(cfg(name)))
    params = j_init_params(jspec, seed)
    params = [dict(p, w=np.asarray(p["w"]) * 2.45) if p and "w" in p else p for p in params]
    randomize_bn(params, np.random.default_rng(seed))
    params[2]["w"][..., 0] = 0.0
    folded = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), j_fold(jspec, params))
    return folded, j_folded_spec(jspec), folded_spec(build_spec(parse_cfg(cfg(name))))


def test_quantize_weights_equal_jax():
    folded, jfspec, fspec = _folded_tree("tiny-yolo-voc.cfg", 0)
    want = j_quant.quantize_weights(jfspec, folded)
    got = quant.quantize_weights(fspec, from_jax_params(fspec, folded, "cpu"))
    flags = [quant._is_quantizable(fspec, l) for l in fspec.layers]
    assert flags == [j_quant._is_quantizable(jfspec, l) for l in jfspec.layers]
    assert sum(flags) == 7 and not flags[0]
    for layer, flag, g, w in zip(fspec.layers, flags, got, want):
        if not flag:
            assert g is None or "wq" not in g
            continue
        wq = np.asarray(w["wq"])  # HWIO
        assert g["wq"].dtype == torch.int8
        np.testing.assert_array_equal(g["wq"].numpy(), wq.reshape(-1, wq.shape[-1]).T)
        np.testing.assert_array_equal(g["wscale"].numpy(), np.asarray(w["wscale"]))
        np.testing.assert_array_equal(g["b"].numpy(), np.asarray(w["b"]))
    assert float(got[2]["wscale"][0]) == 1.0  # the channel of zeros


def _layer(size, stride, cin, cout, activation="leaky"):
    kw = dict(index=0, kind="conv", in_channels=cin, out_channels=cout, size=size,
              stride=stride, pad=size // 2, activation=activation, bias=True)
    return LayerSpec(**kw), JLayerSpec(**kw)


def _jax_quantized(jlayer, w, b):
    """The JAX package's quantize_weights on `jlayer` followed by a head."""
    head = JLayerSpec(index=1, kind="conv", in_channels=jlayer.out_channels, out_channels=8,
                      size=1)
    spec = JNetSpec(layers=(jlayer, head), kind="net", width=0, height=0, channels=3)
    return j_quant.quantize_weights(spec, [{"w": w, "b": b}, None])[0]


def _jax_codes(x, sx):
    """The first line of the JAX package's conv_int8, jitted with sx baked
    in as the detectors bake it."""
    return np.asarray(jax.jit(lambda a: jnp.clip(
        jnp.round(a.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8))(x))


def test_codes_follow_the_jitted_reference():
    """Values at and around every half-way point k + 1/2 of the scale, where
    a product with the reciprocal and a division round apart."""
    sx = 3.7 / 127
    half = ((np.arange(-127, 127) + 0.5) * sx).astype(np.float32)
    x = np.concatenate([np.nextafter(half, np.float32(np.inf * s)) if s else half
                        for s in (-1, 0, 1)] + [np.random.default_rng(4).standard_normal(
                            100_000).astype(np.float32) * 3])
    got = quant.quantize_act(t(x), torch.tensor(quant.act_scale_inverse(sx))).numpy()
    np.testing.assert_array_equal(got, _jax_codes(x, sx))
    divided = np.clip(np.round(x / np.float32(sx)), -127, 127).astype(np.int8)
    assert (divided != got).sum() > 0  # a true division would not match


@pytest.mark.parametrize("geom", [(3, 1, 16, 24), (1, 1, 32, 16), (3, 2, 8, 16), (3, 1, 12, 40)],
                         ids=["3x3", "1x1", "3x3_stride2", "3x3_k108"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_int8_equals_jax(geom, dtype):
    size, stride, cin, cout = geom
    layer, jlayer = _layer(size, stride, cin, cout)
    rng = np.random.default_rng(size * 100 + cin)
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    w = (rng.standard_normal((size, size, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    sx = float(np.abs(x).max()) / 127.0
    jtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ttype = getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jtype)
    xt = t(x).to(ttype)
    jq = _jax_quantized(jlayer, w, b)
    tq = {"wq": t(np.asarray(jq["wq"]).reshape(-1, cout).T, torch.int8),
          "wscale": t(np.asarray(jq["wscale"])), "b": t(b)}

    codes = quant.quantize_act(xt, torch.tensor(quant.act_scale_inverse(sx)))
    np.testing.assert_array_equal(codes.numpy(), _jax_codes(xj, sx))
    a, (n, ho, wo) = im2col(codes, size, stride, layer.pad)
    got_int = int8_matmul(a, tq["wq"]).reshape(n, ho, wo, cout)
    want_int = jax.lax.conv_general_dilated(
        jnp.asarray(codes.numpy()), jq["wq"], window_strides=(stride, stride),
        padding=[(layer.pad, layer.pad)] * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got_int.numpy(), np.asarray(want_int))

    got = quant.conv_int8(layer, tq, xt, sx)
    want = jax.jit(lambda a, p: j_quant.conv_int8(jlayer, p, a, sx))(xj, jq)
    assert got.dtype == ttype
    want = np.asarray(want.astype(jnp.float32))
    tol = REL if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n_cls", [15, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_reweight_head_int8_equals_jax(n_cls, dtype):
    rng = np.random.default_rng(n_cls)
    c, k = 64, 30
    x = np.maximum(rng.standard_normal((2, 5, 5, c)), -0.1).astype(np.float32)
    dw = rng.standard_normal((n_cls, 1, 1, c)).astype(np.float32)
    head_w = (rng.standard_normal((1, 1, c, k)) * 0.1).astype(np.float32)  # HWIO
    head_b = rng.standard_normal(k).astype(np.float32)
    sx = float(np.abs(x).max()) / 127.0
    jtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ttype = getattr(torch, dtype)
    xj, dwj = jnp.asarray(x).astype(jtype), jnp.asarray(dw).astype(jtype)
    xt, dwt = t(x).to(ttype), t(dw).to(ttype)
    head_t = t(head_w.transpose(3, 2, 0, 1))  # OIHW

    xq, effq, scale = head_int8_operands(xt, dwt, head_t, sx)

    def jax_operands(a, d):
        # the lines of the JAX package's fused_reweight_head_int8, jitted
        eff = (d.reshape(n_cls, c).T[:, :, None] * head_w.reshape(c, 1, k)).reshape(
            c, n_cls * k).astype(jnp.float32)
        s = jnp.maximum(jnp.max(jnp.abs(eff), axis=0), 1e-12) / 127.0
        eq = jnp.clip(jnp.round(eff / s), -127, 127).astype(jnp.int8)
        aq = jnp.clip(jnp.round(a.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
        return aq, eq, s, jnp.einsum("bhwc,cm->bhwm", aq, eq, preferred_element_type=jnp.int32)

    jxq, jeffq, jscale, jprod = (np.asarray(v) for v in jax.jit(jax_operands)(xj, dwj))
    np.testing.assert_array_equal(xq.numpy(), jxq.reshape(-1, c))
    np.testing.assert_array_equal(effq.numpy(), jeffq.T)
    np.testing.assert_array_equal(scale.numpy(), jscale)
    np.testing.assert_array_equal(int8_matmul(xq, effq).numpy(), jprod.reshape(-1, n_cls * k))

    got = fused_reweight_head_int8(xt, dwt, head_t, t(head_b), "linear", sx)
    want = jax.jit(lambda a, d: j_meta.fused_reweight_head_int8(
        a, d, jnp.asarray(head_w), jnp.asarray(head_b), "linear", sx))(xj, dwj)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == ttype and got.shape == want.shape == (2 * n_cls, 5, 5, k)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=REL * np.abs(want).max())


def test_calibrated_scales_equal_jax():
    folded, jfspec, fspec = _folded_tree("tiny-yolo-voc.cfg", 1)
    images = np.random.default_rng(2).random((5, 64, 64, 3), dtype=np.float32)
    want = j_quant.calibrate_act_scales(jfspec, folded, images, batch=2)
    got = quant.calibrate_act_scales(fspec, from_jax_params(fspec, folded, "cpu"), images, batch=2)
    assert sorted(got) == sorted(want) and len(got) == 7
    for idx in want:
        assert abs(got[idx] - want[idx]) <= REL * want[idx], idx


@pytest.mark.parametrize("shape", [(1, 8, 8), (16, 24, 450), (17, 12, 5), (40, 288, 64),
                                   (3, 1024, 600)])
def test_int_mm_padding_keeps_the_product(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = t(rng.integers(-127, 128, (m, k)), torch.int8)
    w = t(rng.integers(-127, 128, (n, k)), torch.int8)
    want = a.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
    np.testing.assert_array_equal(int8_matmul_reference(a, w).numpy(), want)
    got = padded_int_mm(a, w)  # torch._int_mm runs on the CPU too
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
