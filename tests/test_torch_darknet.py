"""Static executor of the PyTorch port against the JAX package's, on the CPU.

One numpy parameter tree and one numpy input through both `apply_network`s.
float32 convolutions sum in another order in the two libraries, and the
error grows with depth: atol/rtol 1e-4 on O(1) activations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.models import darknet as jd
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import darknet as td
from fewshot_detection_tpu_torch.models.convert import from_jax_params, to_jax_params
from fewshot_detection_tpu_torch.models.spec import build_spec

from torch_port_util import cfg, randomize_bn, t, to_jnp_tree

TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(name, seed):
    spec = build_spec(parse_cfg(cfg(name)))
    jspec = j_build_spec(j_parse_cfg(cfg(name)))
    params = randomize_bn(td.init_params(spec, seed), np.random.default_rng(seed + 1))
    return spec, jspec, params


@pytest.mark.parametrize("name,size", [("tiny_reweighting.cfg", 64), ("tiny-yolo-voc.cfg", 64)])
def test_apply_network_matches_jax(name, size):
    spec, jspec, params = _setup(name, 0)
    x = np.random.default_rng(2).uniform(0, 1, (2, size, size, spec.channels)).astype(np.float32)
    with torch.no_grad():
        got, _ = td.apply_network(spec, from_jax_params(spec, params, "cpu"), t(x))
    want, _ = jd.apply_network(jspec, to_jnp_tree(params), jnp.asarray(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_network_start_stop_matches_jax():
    spec, jspec, params = _setup("tiny_darknet_dynamic.cfg", 3)
    x = np.random.default_rng(4).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    tp, jp = from_jax_params(spec, params, "cpu"), to_jnp_tree(params)
    with torch.no_grad():
        mid, _ = td.apply_network(spec, tp, t(x), stop=4)
        got, _ = td.apply_network(spec, tp, mid, start=4, stop=11)
    jmid, _ = jd.apply_network(jspec, jp, jnp.asarray(x), stop=4)
    want, _ = jd.apply_network(jspec, jp, jmid, start=4, stop=11)
    np.testing.assert_allclose(mid.numpy(), np.asarray(jmid), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_network_rejects_dynamic_conv():
    spec, _, params = _setup("tiny_darknet_dynamic.cfg", 3)
    with pytest.raises(ValueError):
        td.apply_network(spec, from_jax_params(spec, params, "cpu"), torch.zeros(1, 64, 64, 3))


def test_split_outputs_match_jax():
    """[split] layers emit their first slice as a dynamic weight."""
    text = (
        "[learnet]\nfeat_layer=0\nchannels=4\nheight=32\nwidth=32\n"
        "[convolutional]\nbatch_normalize=1\nfilters=12\nsize=3\nstride=1\npad=1\nactivation=leaky\n"
        "[maxpool]\nsize=2\nstride=2\n"
        "[split]\nsplits=4,8\n"
        "[convolutional]\nfilters=6\nsize=1\nstride=1\npad=1\nactivation=linear\n"
        "[globalmax]\n"
    )
    from fewshot_detection_tpu.config.darkcfg import parse_cfg_text as j_text
    from fewshot_detection_tpu_torch.config.darkcfg import parse_cfg_text

    spec, jspec = build_spec(parse_cfg_text(text)), j_build_spec(j_text(text))
    params = randomize_bn(td.init_params(spec, 5), np.random.default_rng(6))
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 4)).astype(np.float32)
    with torch.no_grad():
        got, aux = td.apply_network(spec, from_jax_params(spec, params, "cpu"), t(x))
    want, jaux = jd.apply_network(jspec, to_jnp_tree(params), jnp.asarray(x))
    assert len(aux["splits"]) == len(jaux["splits"]) == 1
    np.testing.assert_allclose(aux["splits"][0].numpy(), np.asarray(jaux["splits"][0]), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fold_batchnorm_matches_jax_and_unfolded():
    spec, jspec, params = _setup("tiny_reweighting.cfg", 8)
    tp = from_jax_params(spec, params, "cpu")
    folded = td.fold_batchnorm(spec, tp)
    jfolded = jd.fold_batchnorm(jspec, to_jnp_tree(params))
    back = to_jax_params(td.folded_spec(spec), folded)
    for p, q in zip(back, jfolded):
        if p is None:
            assert q is None
            continue
        assert set(p) == set(q) and "bn" not in p
        # one multiply per weight in float32 on both sides
        np.testing.assert_allclose(p["w"], np.asarray(q["w"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(p["b"], np.asarray(q["b"]), rtol=1e-5, atol=1e-6)
    x = np.random.default_rng(9).uniform(0, 1, (2, 64, 64, 4)).astype(np.float32)
    with torch.no_grad():
        a, _ = td.apply_network(spec, tp, t(x))
        b, _ = td.apply_network(td.folded_spec(spec), folded, t(x))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_init_params_is_seeded_and_shaped_like_jax():
    spec, jspec, _ = _setup("tiny_darknet_dynamic.cfg", 0)
    a, b = td.init_params(spec, 11), td.init_params(spec, 11)
    j = jd.init_params(jspec, 0)
    for p, q, r in zip(a, b, j):
        if p is None:
            assert q is None and r is None
            continue
        assert set(p) == set(r)
        for k in p:
            if k == "bn":
                continue
            np.testing.assert_array_equal(p[k], q[k])
            assert p[k].shape == tuple(r[k].shape) and p[k].dtype == np.float32
