"""Optimizer pieces of the PyTorch port against the JAX package's, on the CPU.
Elementwise float32 arithmetic in the same order: rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.train import optim as jo
from fewshot_detection_tpu_torch.train import optim as to

from torch_port_util import t

STEPS = (-1, 500, 40000, 60000)
SCALES = (0.1, 10, 0.1, 0.1)


def _tree(rng):
    return {"net": [
        {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)},
        None,
        {"w": rng.randn(2, 4).astype(np.float32),
         "bn": {k: rng.rand(2).astype(np.float32) + 0.5 for k in ("gamma", "beta", "mean", "var")}},
    ]}


def _tt(tree):
    return to.tree_map(lambda a: t(a).clone(), tree)


def _assert_trees_close(got, want, rtol=1e-6):
    gl = dict(to.tree_leaves_with_path(got))
    wl = dict(to.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, want)))
    assert gl.keys() == wl.keys()
    for k in gl:
        np.testing.assert_allclose(gl[k].numpy(), wl[k], rtol=rtol, atol=1e-7, err_msg=str(k))


@pytest.mark.parametrize("decay_bn_and_bias", [True, False])
@pytest.mark.parametrize("clip_norm", [0.0, 0.5])
def test_sgd_update_matches_jax_over_three_steps(decay_bn_and_bias, clip_norm):
    rng = np.random.RandomState(0)
    params, grads = _tree(rng), _tree(rng)
    kw = dict(momentum=0.9, weight_decay=5e-4, decay_bn_and_bias=decay_bn_and_bias,
              clip_norm=clip_norm)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    jm = jo.init_momentum(jp)
    tp, tg = _tt(params), _tt(grads)
    tm = to.init_momentum(tp)
    for _ in range(3):
        jp, jm = jo.sgd_update(jp, jg, jm, 0.01, **kw)
        out = to.sgd_update(tp, tg, tm, 0.01, **kw)
        assert out[0] is tp and out[1] is tm  # updated in place
    _assert_trees_close(tp, jp)
    _assert_trees_close(tm, jm)
    # BN running statistics are state: untouched, and they gather no momentum
    bn = tp["net"][2]["bn"]
    np.testing.assert_array_equal(bn["mean"].numpy(), params["net"][2]["bn"]["mean"])
    np.testing.assert_array_equal(bn["var"].numpy(), params["net"][2]["bn"]["var"])
    assert float(tm["net"][2]["bn"]["mean"].abs().sum()) == 0.0


@pytest.mark.parametrize("decay_bn_and_bias", [True, False])
def test_sgd_update_gives_the_bits_of_a_loop_over_the_leaves(decay_bn_and_bias):
    """The update runs as lists (`torch._foreach_*`); each leaf takes the
    operations a loop over the leaves takes, so the bits are the loop's."""
    rng = np.random.RandomState(1)
    params, grads = _tree(rng), _tree(rng)
    tp, tg = _tt(params), _tt(grads)
    tm = to.init_momentum(tp)
    lp, lm = _tt(params), to.init_momentum(_tt(params))
    g = dict(to.tree_leaves_with_path(tg))
    m = dict(to.tree_leaves_with_path(lm))
    for lr in (0.01, 0.003, 0.001):
        to.sgd_update(tp, tg, tm, lr, momentum=0.9, weight_decay=5e-4,
                      decay_bn_and_bias=decay_bn_and_bias)
        for path, p in to.tree_leaves_with_path(lp):
            if to._is_bn_stat(path):
                continue
            wd = 0.0 if not decay_bn_and_bias and to._is_no_decay(path) else 5e-4
            d = g[path] + wd * p if wd else g[path]
            m[path].mul_(0.9).add_(d)
            p.sub_(lr * m[path])
    for got, want in ((tp, lp), (tm, lm)):
        gl, wl = dict(to.tree_leaves_with_path(got)), dict(to.tree_leaves_with_path(want))
        assert gl.keys() == wl.keys() and all(torch.equal(gl[k], wl[k]) for k in gl)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.RandomState(1)
    grads = _tree(rng)
    for max_norm in (0.1, 100.0):
        want = jo.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
        _assert_trees_close(to.clip_by_global_norm(_tt(grads), max_norm), want)


def test_lr_schedule_and_neg_ratio_factor_equal_jax():
    for n in (0, 1, 499, 500, 501, 39999, 40000, 59999, 60000, 70000):
        assert to.lr_schedule(n, 0.001, STEPS, SCALES) == jo.lr_schedule(n, 0.001, STEPS, SCALES)
    assert to.lr_schedule(7, 0.5, (10.0,), ()) == jo.lr_schedule(7, 0.5, (10.0,), ()) == 0.5
    for ratio in ("full", 0, 1, 5, 2, 0.5):
        assert to.neg_ratio_lr_factor(ratio, 17) == jo.neg_ratio_lr_factor(ratio, 17)


def test_init_momentum_is_zeros_of_the_parameters_shape():
    tp = _tt(_tree(np.random.RandomState(2)))
    tm = to.init_momentum(tp)
    assert tm["net"][1] is None
    for (pa, a), (pb, b) in zip(to.tree_leaves_with_path(tp), to.tree_leaves_with_path(tm)):
        assert pa == pb and a.shape == b.shape and float(b.abs().sum()) == 0.0
