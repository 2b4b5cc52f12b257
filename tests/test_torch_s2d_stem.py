"""The space-to-depth stem of the PyTorch port against the JAX package's, on
the CPU, from the same numpy inputs: `ops/layers.py` (`space_to_depth`,
`s2d_stem_weight`, `stem_s2d_conv_pool` in eval and training, the new
running statistics included), `models/darknet.py` (`can_fuse_s2d_stem`,
`apply_network(s2d_stem=True)`), `models/meta.py` (`forward(s2d=True)`), and
1 and 3 steps of both trainers with `s2d=True`.

Bounds: 1e-5 for the ops and the forwards (tests/test_s2d_stem.py's own),
and tests/test_torch_trainer.py's rtol 1e-4 with an absolute floor of 1e-4
of a leaf's largest value for the trainer steps. The s2d stem is also held
against the port's own plain stem (the same function, reassociated), and its
training BN goes through `bn_sums` as often as the plain stem's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import darknet as jd
from fewshot_detection_tpu.models import meta as jm
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu.ops import layers as jl
from fewshot_detection_tpu.train import MetaTrainer as JMetaTrainer
from fewshot_detection_tpu.train import PlainTrainer as JPlainTrainer
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import darknet as td
from fewshot_detection_tpu_torch.models import meta as tm
from fewshot_detection_tpu_torch.models.convert import from_jax_params, to_jax_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops import bn_sums as bn_mod
from fewshot_detection_tpu_torch.ops import layers as tl
from fewshot_detection_tpu_torch.train import MetaTrainer, PlainTrainer

import test_torch_plain_trainer as plain_t
import test_torch_trainer as meta_t
from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import cfg, randomize_bn, to_jnp_tree

TOL = dict(rtol=1e-5, atol=1e-5)


def stem_inputs(seed, B=2, H=32, W=48, C=3, K=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, K) * 0.2).astype(np.float32)  # HWIO, the JAX layout
    bn = {"gamma": rng.randn(K).astype(np.float32), "beta": rng.randn(K).astype(np.float32),
          "mean": (rng.randn(K) * 0.1).astype(np.float32),
          "var": (rng.rand(K) + 0.5).astype(np.float32)}
    bias = rng.randn(K).astype(np.float32)
    return x, w, bn, bias


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def test_space_to_depth_and_weight_equal_jax():
    x, w, _, _ = stem_inputs(0)
    np.testing.assert_array_equal(tl.space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(tl._S2D_T, jl._s2d_selector())
    want = np.asarray(jl.s2d_stem_weight(jnp.asarray(w)))  # (3, 3, 4C, 4K)
    got = tl.s2d_stem_weight(oihw(w)).numpy()  # (4K, 4C, 3, 3)
    np.testing.assert_array_equal(got.transpose(2, 3, 1, 0), want)
    with pytest.raises(ValueError, match="not divisible"):
        tl.space_to_depth(torch.zeros(1, 5, 4, 3))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["bn", "bias"])
@pytest.mark.parametrize("activation", ["leaky", "relu", "linear"])
def test_stem_op_equals_jax_and_the_plain_stem(train, norm, activation):
    x, w, bn, bias = stem_inputs(1)
    jbn = {k: jnp.asarray(v) for k, v in bn.items()} if norm == "bn" else None
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()} if norm == "bn" else None
    jb = jnp.asarray(bias) if norm == "bias" else None
    tb = torch.from_numpy(bias) if norm == "bias" else None
    want, jstats = jl.stem_s2d_conv_pool(jnp.asarray(x), jnp.asarray(w), jbn, activation, jb,
                                         train)
    got, tstats = tl.stem_s2d_conv_pool(torch.from_numpy(x), oihw(w), tbn, activation, tb, train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (tstats is None) == (jstats is None) == (not (train and norm == "bn"))
    if tstats is not None:
        for k in ("mean", "var"):
            np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), **TOL)
    # the port's plain stem: conv, BN, activation, pool
    y = td.conv2d(torch.from_numpy(x), oihw(w), 1, 1)
    if norm == "bn" and train:
        y, pstats = tl.bn_train_activate(y, tbn, activation)
        for k in ("mean", "var"):
            np.testing.assert_allclose(tstats[k].numpy(), pstats[k].numpy(), **TOL)
    else:
        y = tl.batchnorm_apply(y, tbn) if norm == "bn" else y + tb
        y = tl._activate(y, activation)
    np.testing.assert_allclose(got.numpy(), tl.maxpool(y, 2, 2).numpy(), **TOL)


def test_stem_gradients_equal_the_plain_stem():
    """The einsum lifts the 3x3 weight differentiably: the stem's gradients
    (input, weight, BN affine) equal the plain stem's."""
    x, w, bn, _ = stem_inputs(2)
    grads = []
    for s2d in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        wt = oihw(w).requires_grad_()
        bnt = {k: torch.from_numpy(v).requires_grad_(k in ("gamma", "beta"))
               for k, v in bn.items()}
        if s2d:
            y, _ = tl.stem_s2d_conv_pool(xt, wt, bnt, "leaky", None, True)
        else:
            y, _ = tl.bn_train_activate(td.conv2d(xt, wt, 1, 1), bnt, "leaky")
            y = tl.maxpool(y, 2, 2)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        grads.append([xt.grad, wt.grad, bnt["gamma"].grad, bnt["beta"].grad])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


INELIGIBLE = {
    "stride2": ("stride=1", "stride=2", 1),
    "size1": ("size=3", "size=1", 1),
    "pool3": ("[maxpool]\nsize=2", "[maxpool]\nsize=3", 1),
}


def tiny_plain(tmp_path, edit=None):
    text = TINY_PLAIN_CFG
    if edit is not None:
        old, new, count = edit
        text = text.replace(old, new, count)
    path = str(tmp_path / "tiny_plain.cfg")
    with open(path, "w") as f:
        f.write(text)
    return build_spec(parse_cfg(path)), j_build_spec(j_parse_cfg(path))


@pytest.mark.parametrize("name", sorted(INELIGIBLE) + ["eligible"])
def test_can_fuse_equals_jax_and_an_ineligible_net_takes_the_plain_stem(tmp_path, name):
    spec, jspec = tiny_plain(tmp_path, INELIGIBLE.get(name))
    assert td.can_fuse_s2d_stem(spec) == jd.can_fuse_s2d_stem(jspec) == (name == "eligible")
    params = td.init_params(spec, 3)
    tp = from_jax_params(spec, params, "cpu")
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 96, 96, 3).astype(np.float32))
    a, _ = td.apply_network(spec, tp, x, s2d_stem=True)
    b, _ = td.apply_network(spec, tp, x)
    if name == "eligible":
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    else:
        assert torch.equal(a, b)


def test_can_fuse_equals_jax_on_every_cfg_of_the_repo():
    for name in ("darknet_dynamic.cfg", "reweighting_net.cfg", "yolo-voc.cfg", "yolo.cfg",
                 "tiny-yolo-voc.cfg", "darknet19_448.cfg", "tiny_darknet_dynamic.cfg",
                 "tiny_reweighting.cfg"):
        assert (td.can_fuse_s2d_stem(build_spec(parse_cfg(cfg(name))))
                == jd.can_fuse_s2d_stem(j_build_spec(j_parse_cfg(cfg(name))))), name


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_apply_network_s2d_equals_jax(tmp_path, train):
    spec, jspec = tiny_plain(tmp_path)
    params = td.init_params(spec, 5)
    randomize_bn(params, np.random.default_rng(6))
    x = np.random.RandomState(7).rand(2, 96, 96, 3).astype(np.float32)
    got, taux = td.apply_network(spec, from_jax_params(spec, params, "cpu"), torch.from_numpy(x),
                                 train=train, s2d_stem=True)
    want, jaux = jd.apply_network(jspec, to_jnp_tree(params), jnp.asarray(x), train=train,
                                  s2d_stem=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert taux["bn_updates"].keys() == jaux["bn_updates"].keys()
    for i, stats in taux["bn_updates"].items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jaux["bn_updates"][i][k]),
                                       **TOL)


@pytest.fixture(scope="module")
def meta_tiny():
    names = ("tiny_darknet_dynamic.cfg", "tiny_reweighting.cfg")
    spec = tm.MetaSpec(*(build_spec(parse_cfg(cfg(n))) for n in names))
    jspec = jm.MetaSpec(*(j_build_spec(j_parse_cfg(cfg(n))) for n in names))
    params = tm.init_meta_params(spec, 0)
    rng = np.random.default_rng(1)
    for k in meta_t.NETS:
        for p in params[k]:
            if p and "w" in p:
                p["w"] = p["w"] * 2.0  # keep activations O(1) through the stack
        randomize_bn(params[k], rng)
    mom = {k: [None if p is None else jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), p)
        for p in params[k]] for k in meta_t.NETS}
    return spec, jspec, params, mom


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_meta_forward_s2d_equals_jax(meta_tiny, train):
    spec, jspec, params, _ = meta_tiny
    b = meta_t._batch(8, R=1, b=2)
    tp = {k: from_jax_params(getattr(spec, k), params[k], "cpu") for k in meta_t.NETS}
    jp = {k: to_jnp_tree(params[k]) for k in meta_t.NETS}
    got, taux = tm.forward(spec, tp, *(torch.from_numpy(b[k][0]) for k in ("x", "metax", "mask")),
                           train=train, s2d=True)
    want, jaux = jm.forward(jspec, jp, *(jnp.asarray(b[k][0]) for k in ("x", "metax", "mask")),
                            train=train, s2d=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain, _ = tm.forward(spec, tp, *(torch.from_numpy(b[k][0]) for k in ("x", "metax", "mask")),
                          train=train)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    for net in ("darknet", "learnet"):
        t_up, j_up = taux["bn_updates"][net], jaux["bn_updates"][net]
        assert t_up.keys() == j_up.keys() and (0 in t_up) == train
        for i in t_up:
            for k in ("mean", "var"):
                np.testing.assert_allclose(t_up[i][k].numpy(), np.asarray(j_up[i][k]), **TOL)


def test_meta_trainer_s2d_one_and_three_steps_equal_jax(meta_tiny):
    spec, jspec, params, mom = meta_tiny
    tp, tmom = meta_t._torch_state(spec, params, mom)
    jp = {k: to_jnp_tree(params[k]) for k in meta_t.NETS}
    jmom = {k: to_jnp_tree(mom[k]) for k in meta_t.NETS}
    tr = MetaTrainer(spec, weight_decay=5e-4, s2d=True, device="cpu")
    jt = JMetaTrainer(jspec, weight_decay=5e-4, s2d=True, donate=False)
    for step in range(3):
        batch = meta_t._batch(20 + step, R=2, b=2)
        seen = 20000 + 4 * (step + 1)
        _, _, m = tr.step(tp, tmom, batch, seen, 1e-3)
        jp, jmom, jmet = jt.step(jp, jmom, batch, seen, 1e-3)
        meta_t._assert_metrics_close(m, jmet)
        if step in (0, 2):
            assert meta_t._assert_state_close(spec, tp, tmom, jp, jmom) > 30


def test_plain_trainer_s2d_one_and_three_steps_equal_jax(tmp_path):
    spec, jspec = tiny_plain(tmp_path)
    params = td.init_params(spec, 0)
    rng = np.random.default_rng(1)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.0
    randomize_bn(params, rng)
    tp, tmom = plain_t._torch_state(spec, params)
    jp = to_jnp_tree(params)
    jmom = jax.tree_util.tree_map(jnp.zeros_like, jp)
    tr = PlainTrainer(spec, weight_decay=1e-3, s2d=True, device="cpu")
    jt = JPlainTrainer(jspec, weight_decay=1e-3, s2d=True, donate=False)
    for step in range(3):
        batch = plain_t._batch(30 + step, R=2, b=2)
        seen = 20000 + 4 * (step + 1)
        _, _, m = tr.step(tp, tmom, batch, seen, 1e-3)
        jp, jmom, jmet = jt.step(jp, jmom, batch, seen, 1e-3)
        plain_t._assert_metrics_close(m, jmet)
        if step in (0, 2):
            plain_t._assert_state_close(spec, tp, tmom, jp, jmom)


def test_s2d_steps_equal_the_plain_stem_and_launch_bn_sums_as_often(meta_tiny, monkeypatch):
    """One meta step with and without s2d from one state: the same
    parameters (the trainers' bound), and the same number of `bn_sums`
    forwards and backwards (here its plain versions, CPU tensors)."""
    spec, _, params, mom = meta_tiny
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = bn_mod.bn_sums_reference, bn_mod.bn_sums_backward_reference

    def count(key, fn):
        def run(*a):
            calls[key] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(bn_mod, "bn_sums_reference", count("fwd", fwd))
    monkeypatch.setattr(bn_mod, "bn_sums_backward_reference", count("bwd", bwd))
    batch = meta_t._batch(40, R=1, b=2)
    states, counts = [], []
    for s2d in (False, True):
        tp, tmom = meta_t._torch_state(spec, params, mom)
        MetaTrainer(spec, s2d=s2d, device="cpu").step(tp, tmom, batch, 20004, 1e-3)
        states.append(tp)
        counts.append(dict(calls))
        calls.update(fwd=0, bwd=0)
    assert counts[0] == counts[1] and counts[0]["fwd"] > 0
    for k in meta_t.NETS:
        got = to_jax_params(getattr(spec, k), states[1][k])
        want = to_jax_params(getattr(spec, k), states[0][k])
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
