"""Meta model of the PyTorch port against the JAX package's, on the CPU.

One numpy parameter tree, one numpy input. float32 on both sides; the
convolutions and the fused product sum in another order in the two
libraries: atol/rtol 1e-4 on O(1) values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.config.darkcfg import parse_cfg_text as j_parse_text
from fewshot_detection_tpu.models import meta as jm
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.config.darkcfg import parse_cfg_text
from fewshot_detection_tpu_torch.models import meta as tm
from fewshot_detection_tpu_torch.models.convert import from_jax_params
from fewshot_detection_tpu_torch.models.spec import build_spec

from torch_port_util import cfg, randomize_bn, t, to_jnp_tree

TOL = dict(rtol=1e-4, atol=1e-4)
N_CLS = 5


def _gain(params, g):
    """Scale weights so activations stay O(1) through the stack (plain
    fan-in init collapses towards 0 with depth and would make the
    comparison vacuous)."""
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * g
    return params


def _specs(dk_blocks, ln_blocks, jdk, jln):
    return (tm.MetaSpec(build_spec(dk_blocks), build_spec(ln_blocks)),
            jm.MetaSpec(j_build_spec(jdk), j_build_spec(jln)))


@pytest.fixture(scope="module")
def tiny():
    spec, jspec = _specs(parse_cfg(cfg("tiny_darknet_dynamic.cfg")), parse_cfg(cfg("tiny_reweighting.cfg")),
                         j_parse_cfg(cfg("tiny_darknet_dynamic.cfg")), j_parse_cfg(cfg("tiny_reweighting.cfg")))
    params = tm.init_meta_params(spec, 0)
    rng = np.random.default_rng(1)
    for k in params:
        randomize_bn(_gain(params[k], 2.0), rng)
    tp = {k: from_jax_params(getattr(spec, k), v, "cpu") for k, v in params.items()}
    jp = {k: to_jnp_tree(v) for k, v in params.items()}
    return spec, jspec, tp, jp


def _support(rng, n, size):
    metax = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, size, size, 1)) > 0.6).astype(np.float32)
    return metax, mask


def test_meta_forward_matches_jax(tiny):
    spec, jspec, tp, jp = tiny
    metax, mask = _support(np.random.default_rng(2), N_CLS, 64)
    with torch.no_grad():
        got = tm.meta_forward(spec, tp, t(metax), t(mask))
    want, _ = jm.meta_forward(jspec, jp, jnp.asarray(metax), jnp.asarray(mask))
    assert len(got) == len(want) == 1
    assert tuple(got[0].shape) == (N_CLS, 1, 1, 64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


def test_meta_forward_requires_mask(tiny):
    spec, _, tp, _ = tiny
    with pytest.raises(ValueError):
        tm.meta_forward(spec, tp, torch.zeros(1, 64, 64, 3), None, metain_type=2)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "general"])
def test_detect_forward_matches_jax(tiny, fuse):
    spec, jspec, tp, jp = tiny
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    dw = rng.standard_normal((N_CLS, 1, 1, 64)).astype(np.float32)
    with torch.no_grad():
        got = tm.detect_forward(spec, tp, t(x), [t(dw)], fuse=fuse)
    want, _ = jm.detect_forward(jspec, jp, jnp.asarray(x), [jnp.asarray(dw)], fuse=fuse)
    assert tuple(got.shape) == tuple(want.shape) == (2 * N_CLS, 2, 2, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_head_equals_general_path(tiny):
    """The one-product head computes what the materializing grouped conv
    followed by the 1x1 head computes (image-major rows)."""
    spec, _, tp, _ = tiny
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    dw = rng.standard_normal((N_CLS, 1, 1, 64)).astype(np.float32)
    with torch.no_grad():
        a = tm.detect_forward(spec, tp, t(x), [t(dw)], fuse=True)
        b = tm.detect_forward(spec, tp, t(x), [t(dw)], fuse=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_fused_reweight_head_matches_jax_and_general():
    rng = np.random.default_rng(5)
    b, h, w, c, n, k = 2, 3, 3, 16, 4, 6
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dw = rng.standard_normal((n, 1, 1, c)).astype(np.float32)
    hw = rng.standard_normal((1, 1, c, k)).astype(np.float32)  # HWIO
    hb = rng.standard_normal((k,)).astype(np.float32)
    got = tm.fused_reweight_head(t(x), t(dw), t(hw.transpose(3, 2, 0, 1)), t(hb), "linear")
    want = jm.fused_reweight_head(jnp.asarray(x), jnp.asarray(dw), jnp.asarray(hw), jnp.asarray(hb), "linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # against the definition, row b*n+j = head(x[b] * dw[j])
    ref = np.einsum("bhwc,nc,ck->bnhwk", x, dw.reshape(n, c), hw.reshape(c, k)) + hb
    np.testing.assert_allclose(got.numpy(), ref.reshape(b * n, h, w, k), rtol=1e-4, atol=1e-4)


def test_dynamic_conv_general_matches_jax_not_first():
    """Second dynamic conv: input already carries the B*n_cls batch."""
    from fewshot_detection_tpu.models.spec import LayerSpec as JL
    from fewshot_detection_tpu_torch.models.spec import LayerSpec as TL

    kw = dict(index=0, kind="conv", in_channels=8, out_channels=8, size=3, stride=1, pad=1, dynamic=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2 * 3, 5, 5, 8)).astype(np.float32)
    dw = rng.standard_normal((3, 3, 3, 16)).astype(np.float32)  # group size 2
    got = tm.dynamic_conv_general(t(x), t(dw), TL(**kw), is_first=False)
    want = jm.dynamic_conv_general(jnp.asarray(x), jnp.asarray(dw), JL(**kw), is_first=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_PARTIAL_DK = (
    "[net]\nbatch=1\nheight=32\nwidth=32\nchannels=3\n"
    "[convolutional]\nbatch_normalize=1\nfilters=8\nsize=3\nstride=1\npad=1\nactivation=leaky\n"
    "[maxpool]\nsize=2\nstride=2\n"
    "[convolutional]\ndynamic=1\npartial=8\nbatch_normalize=1\nsize=1\nstride=1\npad=1\nfilters=8\nactivation=leaky\n"
    "[route]\nlayers=-1,1\n"
    "[convolutional]\nsize=1\nstride=1\npad=1\nfilters=6\nactivation=linear\n"
    "[region]\nanchors=1.0,1.0\nclasses=1\nnum=1\n"
)
_PARTIAL_LN = (
    "[learnet]\nfeat_layer=0\nchannels=4\nheight=32\nwidth=32\n"
    "[convolutional]\nbatch_normalize=1\nfilters=8\nsize=3\nstride=1\npad=1\nactivation=leaky\n"
    "[globalmax]\n"
)


def test_partial_weight_bn_and_class_broadcast_route_match_jax():
    """A dynamic conv with a shared `partial` weight and BN, followed by a
    concat route whose second source still has batch B (class-broadcast)."""
    spec, jspec = _specs(parse_cfg_text(_PARTIAL_DK), parse_cfg_text(_PARTIAL_LN),
                         j_parse_text(_PARTIAL_DK), j_parse_text(_PARTIAL_LN))
    params = tm.init_meta_params(spec, 7)
    randomize_bn(params["darknet"], np.random.default_rng(8))
    tp = {k: from_jax_params(getattr(spec, k), v, "cpu") for k, v in params.items()}
    jp = {k: to_jnp_tree(v) for k, v in params.items()}
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    dw = rng.standard_normal((3, 1, 1, 8)).astype(np.float32)
    with torch.no_grad():
        got = tm.detect_forward(spec, tp, t(x), [t(dw)])
    want, _ = jm.detect_forward(jspec, jp, jnp.asarray(x), [jnp.asarray(dw)])
    assert tuple(got.shape) == tuple(want.shape) == (6, 16, 16, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_feat_layer_stem_with_six_channel_support_matches_jax():
    """feat_layer > 0: the support image runs through the backbone's first
    layers; a 6-channel input is split, run twice and re-joined."""
    ln = ("[learnet]\nfeat_layer=2\nchannels=16\nheight=32\nwidth=32\n"
          "[convolutional]\nbatch_normalize=1\nfilters=8\nsize=3\nstride=1\npad=1\nactivation=leaky\n"
          "[globalmax]\n")
    spec, jspec = _specs(parse_cfg_text(_PARTIAL_DK), parse_cfg_text(ln),
                         j_parse_text(_PARTIAL_DK), j_parse_text(ln))
    params = tm.init_meta_params(spec, 10)
    tp = {k: from_jax_params(getattr(spec, k), v, "cpu") for k, v in params.items()}
    jp = {k: to_jnp_tree(v) for k, v in params.items()}
    metax = np.random.default_rng(11).uniform(0, 1, (3, 32, 32, 6)).astype(np.float32)
    with torch.no_grad():
        got = tm.meta_forward(spec, tp, t(metax), None, metain_type=4)
    want, _ = jm.meta_forward(jspec, jp, jnp.asarray(metax), None, metain_type=4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


def test_class_broadcast_is_image_major():
    x = torch.arange(3)[:, None] * torch.ones(1, 2)
    out = tm.class_broadcast(x, 4)
    assert out[:, 0].tolist() == [0] * 4 + [1] * 4 + [2] * 4
    want = jm.class_broadcast(jnp.arange(3)[:, None] * jnp.ones((1, 2)), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
