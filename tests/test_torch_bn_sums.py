"""`bn_sums` and `batchnorm_train` of the PyTorch port against the JAX package,
on the CPU.

On a CPU tensor the port's wrapper runs its plain version, which is what the
CUDA kernels are held against on the card (`chip_smoke.py`). Here the plain
version is held against the JAX package's `_sums_reference` AND against its
Pallas kernel in interpret mode, at that kernel's test shapes. Both sides
accumulate in float32 but add in another order: rtol 1e-5 / atol 1e-4 on
sums of a few thousand O(1) values, the JAX package's own tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.ops import layers as jl
from fewshot_detection_tpu.ops.bn_pallas import _bn_sums_impl, _sums_reference
from fewshot_detection_tpu.ops.bn_pallas import bn_sums as j_bn_sums
from fewshot_detection_tpu_torch.ops import layers as tl
from fewshot_detection_tpu_torch.ops.bn_sums import (
    bn_sums,
    bn_sums_backward_reference,
    bn_sums_reference,
    row_blocks,
)

from torch_port_util import t

SHAPES = [
    (2, 8, 8, 32),
    (2, 16, 16, 3),
    (4, 4, 4, 256),
    (2, 8, 8, 96),
    (3, 13, 13, 1024),
    (1, 8, 8, 4, 16),
    (7, 30),  # odd M, C = 30: no counterpart of the TPU kernel's fallback
]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_bn_sums_matches_jax_reference_and_pallas_interpret(shape):
    x = _x(shape, len(shape) + shape[-1])
    s, q = bn_sums(t(x))
    assert s.dtype == q.dtype == torch.float32 and tuple(s.shape) == (shape[-1],)
    sr, qr = _sums_reference(jnp.asarray(x).reshape(-1, shape[-1]))
    sp, qp = _bn_sums_impl(jnp.asarray(x), interpret=True)
    for got, want in ((s, sr), (q, qr), (s, sp), (q, qp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_bn_sums_bfloat16_accumulates_in_float32():
    """The case of the JAX package's own bf16 test: the input is rounded to
    bfloat16 once, then both sides sum those values in float32."""
    x32 = _x((4, 16, 16, 32), 2)
    xj = jnp.asarray(x32, jnp.bfloat16)
    xt = t(x32).to(torch.bfloat16)
    np.testing.assert_array_equal(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)))
    s, q = bn_sums(xt)
    assert s.dtype == q.dtype == torch.float32
    sr, qr = j_bn_sums(xj)
    sp, qp = _bn_sums_impl(xj, interpret=True)
    # rtol 1e-5: a bfloat16 accumulator would be off by about 1e-2
    for got, want in ((s, sr), (q, qr), (s, sp), (q, qp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_sums_gradient_matches_jax_grad(dtype):
    """d/dx of a scalar function of (sum, sumsq) against jax.grad through the
    JAX package's custom VJP. The backward is elementwise, dsum + 2*x*dsq
    rounded once to x's dtype: float32 agrees to 1e-5 (dsq carries the
    sums' own rounding), bfloat16 to one rounding step (2^-8 relative)."""
    x32 = _x((2, 4, 4, 8), 3)
    a = np.linspace(-1, 1, 8).astype(np.float32)
    b = np.linspace(0.5, 2, 8).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    def loss(x):
        s, q = j_bn_sums(x)
        return jnp.sum(s * a + 1e-2 * jnp.square(q) * b)

    want = jax.grad(loss)(jnp.asarray(x32, jdt))
    xt = t(x32).to(tdt).requires_grad_(True)
    s, q = bn_sums(xt)
    (got,) = torch.autograd.grad(torch.sum(s * t(a) + 1e-2 * torch.square(q) * t(b)), xt)
    assert got.dtype == tdt and got.shape == xt.shape
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_bn_sums_none_gradients_count_as_zeros():
    x = t(_x((3, 5, 8), 4)).requires_grad_(True)
    s, q = bn_sums(x)
    (g_s,) = torch.autograd.grad(s.sum(), x, retain_graph=True)  # sumsq unused
    np.testing.assert_array_equal(g_s.numpy(), np.ones((3, 5, 8), np.float32))
    (g_q,) = torch.autograd.grad(q.sum(), x)  # sum unused
    np.testing.assert_allclose(g_q.numpy(), 2 * x.detach().numpy(), rtol=1e-6)
    xd = x.detach()
    np.testing.assert_array_equal(
        bn_sums_backward_reference(xd, None, None).numpy(), np.zeros((3, 5, 8), np.float32))


def test_bn_sums_counts_layout_copies_and_launches_nothing_on_cpu():
    x = t(_x((6, 16), 5))
    before = (bn_sums.launches, bn_sums.backward_launches, bn_sums.layout_copies)
    bn_sums(x)
    assert (bn_sums.launches, bn_sums.backward_launches, bn_sums.layout_copies) == before
    view = x[:, ::2]
    assert not view.is_contiguous()
    s, q = bn_sums(view)
    assert bn_sums.layout_copies == before[2] + 1
    assert bn_sums.launches == before[0]  # a CPU tensor never launches
    sr, qr = bn_sums_reference(view.contiguous())
    np.testing.assert_array_equal(s.numpy(), sr.numpy())
    np.testing.assert_array_equal(q.numpy(), qr.numpy())
    with pytest.raises(TypeError):
        bn_sums(x.double())


@pytest.mark.parametrize("m,c,want", [
    (64 * 416 * 416, 32, 1056),  # tall and narrow: as many blocks as the card holds
    (64 * 13 * 13, 1024, 33),    # 32 channel tiles x 33 row blocks
    (1, 1, 1),
    (7, 1280, 1),
    (100, 3, 2),                 # C=3: a warp takes 10 rows, a block 80
])
def test_row_blocks_fill_the_card_once(m, c, want):
    assert row_blocks(m, c) == want


def _bn(rng, c):
    return {
        "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "beta": rng.uniform(-0.3, 0.3, c).astype(np.float32),
        "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
    }


@pytest.mark.parametrize("darknet_mode", [False, True], ids=["torch_mode", "darknet_mode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(monkeypatch, darknet_mode, dtype):
    """y, the new running statistics and the gradients to x, gamma and beta,
    in both running-statistics modes. float32: 1e-5. bfloat16: x is rounded
    once on both sides, the statistics stay float32 (1e-5), y and dx are
    bfloat16 values (two rounding steps, 2^-7 relative; the sum over dy of
    one channel's dx terms cancels, so dx gets an absolute floor); the
    tolerance of dgamma and dbeta is stated where they are compared."""
    if darknet_mode:
        monkeypatch.setenv("FSD_BN_DARKNET", "1")
    else:
        monkeypatch.delenv("FSD_BN_DARKNET", raising=False)
    assert tl.bn_train_config() == jl.bn_train_config()
    rng = np.random.RandomState(6)
    c = 16
    x32 = (rng.randn(2, 5, 5, c) * 1.5 + 0.3).astype(np.float32)
    w = rng.randn(2, 5, 5, c).astype(np.float32)
    bn = _bn(rng, c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x, gamma, beta):
        y, stats = jl.batchnorm_train(x, {**{k: jnp.asarray(v) for k, v in bn.items()},
                                          "gamma": gamma, "beta": beta})
        return jnp.sum(y.astype(jnp.float32) * w), (y, stats)

    (_, (jy, jstats)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x32, jdt), jnp.asarray(bn["gamma"]), jnp.asarray(bn["beta"]))

    xt = t(x32).to(tdt).requires_grad_(True)
    tbn = {k: t(v) for k, v in bn.items()}
    tbn["gamma"].requires_grad_(True)
    tbn["beta"].requires_grad_(True)
    y, stats = tl.batchnorm_train(xt, tbn)
    assert y.dtype == tdt and not stats["mean"].requires_grad
    grads = torch.autograd.grad(torch.sum(y.float() * t(w)), (xt, tbn["gamma"], tbn["beta"]))

    f32 = dict(rtol=1e-5, atol=1e-5)
    low = f32 if dtype == "float32" else dict(rtol=2.0 ** -7, atol=2.0 ** -7)
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)), **low)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), **f32)
    np.testing.assert_allclose(
        grads[0].float().numpy(), np.asarray(jgrads[0].astype(jnp.float32)),
        **(f32 if dtype == "float32" else dict(rtol=2.0 ** -6, atol=2.0 ** -5)))
    for got, want in zip(grads[1:], jgrads[1:]):
        assert got.dtype == torch.float32
        want = np.asarray(want)
        # bfloat16: the gradient reaches gamma and beta through the cast of
        # inv/bias, as a bfloat16 sum over the batch whose terms cancel; the
        # frameworks round it at the magnitude of its largest channel
        tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
               else dict(rtol=2.0 ** -6, atol=2.0 ** -6 * np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, **tol)
