"""Layer ops of the PyTorch port against the JAX package's, on the CPU.

Same numpy input through both. reorg and the max pools only move or select
values, so they must agree exactly; batchnorm_apply is a float32 affine whose
rsqrt differs in the last bit between the two libraries (rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.ops import layers as jl
from fewshot_detection_tpu_torch.ops import layers as tl

from torch_port_util import t


@pytest.fixture
def x():
    return np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(np.float32)


@pytest.mark.parametrize("stride", [2, 4])
def test_reorg_matches_jax(x, stride):
    got = tl.reorg(t(x), stride).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.reorg(jnp.asarray(x), stride)))


def test_reorg_is_not_pixel_unshuffle(x):
    ours = tl.reorg(t(x), 2)
    pu = torch.pixel_unshuffle(t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert ours.shape == pu.shape and not torch.equal(ours, pu)


def test_reorg_rejects_indivisible():
    with pytest.raises(ValueError):
        tl.reorg(torch.zeros(1, 5, 4, 2), 2)


@pytest.mark.parametrize("size,stride,hw", [(2, 2, (8, 12)), (2, 2, (7, 9)), (3, 2, (9, 9))])
def test_maxpool_matches_jax(size, stride, hw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    got = tl.maxpool(t(x), size, stride).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.maxpool(jnp.asarray(x), size, stride)))


def test_maxpool_stride1_matches_jax(x):
    got = tl.maxpool_stride1(t(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, np.asarray(jl.maxpool_stride1(jnp.asarray(x))))


def test_global_pools_match_jax(x):
    np.testing.assert_array_equal(
        tl.global_maxpool(t(x)).numpy(), np.asarray(jl.global_maxpool(jnp.asarray(x))))
    # a mean sums in another order: float32 rounding, rtol 1e-6
    np.testing.assert_allclose(
        tl.global_avgpool(t(x)).numpy(), np.asarray(jl.global_avgpool(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7)


def test_leaky_relu_matches_jax(x):
    np.testing.assert_array_equal(
        tl.leaky_relu(t(x)).numpy(), np.asarray(jl.leaky_relu(jnp.asarray(x))))


def _bn(c, rng):
    return {
        "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "beta": rng.uniform(-0.3, 0.3, c).astype(np.float32),
        "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
    }


def test_batchnorm_apply_matches_jax_fp32(x):
    bn = _bn(5, np.random.default_rng(2))
    got = tl.batchnorm_apply(t(x), {k: t(v) for k, v in bn.items()}).numpy()
    want = np.asarray(jl.batchnorm_apply(jnp.asarray(x), {k: jnp.asarray(v) for k, v in bn.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_batchnorm_apply_bf16_casts_where_jax_does(x):
    """In bf16 the affine pair is cast to bf16 before the multiply on both
    sides; results agree to one bf16 ulp (2^-8 relative) of the larger
    term."""
    bn = _bn(5, np.random.default_rng(3))
    got = tl.batchnorm_apply(
        t(x).to(torch.bfloat16), {k: t(v) for k, v in bn.items()})
    assert got.dtype == torch.bfloat16
    want = jl.batchnorm_apply(
        jnp.asarray(x).astype(jnp.bfloat16), {k: jnp.asarray(v) for k, v in bn.items()})
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=2 ** -7)
