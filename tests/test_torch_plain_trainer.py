"""`PlainTrainer` of the PyTorch port against the JAX package's, on the CPU.

One numpy (params, momentum, batch) goes to both trainers; after the steps
every parameter, every momentum leaf, the BN running statistics and every
metric are compared. float32 on both sides; convolutions and sums run in
another order in the two libraries and the difference compounds through
momentum: rtol 1e-4 with an absolute floor of 1e-4 of the leaf's largest
value, after one step and after three (the bound of the meta trainer's
test, tests/test_torch_trainer.py). The network is the small plain cfg of
tests/test_e2e_plain.py: five conv+BN+leaky layers and a region head."""

import jax
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu.train import PlainTrainer as JPlainTrainer
from fewshot_detection_tpu.train import init_momentum as j_init_momentum
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models.convert import (
    from_jax_momentum,
    from_jax_params,
    require_grads,
    to_jax_momentum,
    to_jax_params,
)
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops import bn_sums as bn_mod
from fewshot_detection_tpu_torch.train import PlainTrainer, init_momentum
from fewshot_detection_tpu_torch.train.optim import tree_leaves_with_path

from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import randomize_bn, to_jnp_tree

SIZE = 96
N_BN = 5  # BN layers of the cfg
METRICS = ("nGT", "nCorrect", "nProposals", "loss_x", "loss_y", "loss_w", "loss_h",
           "loss_conf", "loss_cls", "loss")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plain_trainer") / "tiny_plain.cfg")
    with open(path, "w") as f:
        f.write(TINY_PLAIN_CFG)
    spec, jspec = build_spec(parse_cfg(path)), j_build_spec(j_parse_cfg(path))
    params = init_params(spec, 0)
    rng = np.random.default_rng(1)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.0  # keep activations O(1) through the stack
    randomize_bn(params, rng)
    mom = [None if p is None else jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), p) for p in params]
    return spec, jspec, params, mom


def _batch(seed, R, b):
    r = np.random.RandomState(seed)
    target = np.zeros((R, b, 50, 5), np.float32)
    for g in range(R):
        for i in range(b):
            for j in range(r.randint(1, 3)):
                target[g, i, j] = [r.randint(20), r.uniform(0.3, 0.7), r.uniform(0.3, 0.7),
                                   r.uniform(0.1, 0.4), r.uniform(0.1, 0.4)]
    keep = np.ones((R, b), np.float32)
    keep[0, -1] = 0.0  # one image's loss dropped by the neg filter
    return {"x": r.rand(R, b, SIZE, SIZE, 3).astype(np.float32), "target": target, "keep": keep}


def _torch_state(spec, params, mom=None):
    tp = require_grads(from_jax_params(spec, params, "cpu"))
    return tp, (init_momentum(tp) if mom is None else from_jax_momentum(spec, mom, "cpu"))


def _assert_state_close(spec, tp, tmom, jp, jmom, rtol=1e-4, floor=1e-4):
    n = 0
    for got, want in ((to_jax_params(spec, tp), jp), (to_jax_momentum(spec, tmom), jmom)):
        gl = dict(tree_leaves_with_path(got))
        wl = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, list(want))))
        assert gl.keys() == wl.keys()
        for path in gl:
            np.testing.assert_allclose(gl[path], wl[path], rtol=rtol,
                                       atol=floor * np.abs(wl[path]).max(), err_msg=str(path))
            n += 1
    return n


def _assert_metrics_close(m, jmet):
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jmet[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_one_and_three_steps_match_jax_with_two_groups(tiny):
    """R = 2 groups (each with its own batch statistics, running statistics
    averaged), a momentum tree that is not zero, seen past the warm-up."""
    spec, jspec, params, mom = tiny
    tp, tmom = _torch_state(spec, params, mom)
    jp, jmom = to_jnp_tree(params), to_jnp_tree(mom)
    kw = dict(weight_decay=5e-4 * 4)
    tr = PlainTrainer(spec, device="cpu", **kw)
    jt = JPlainTrainer(jspec, donate=False, **kw)
    before = to_jax_params(spec, tp)[0]["bn"]["mean"].copy()
    for step in range(3):
        batch = _batch(10 + step, R=2, b=2)
        seen = 20000 + 4 * (step + 1)
        out = tr.step(tp, tmom, batch, seen, 1e-3 / 4)
        assert out[0] is tp and out[1] is tmom  # in place
        jp, jmom, jmet = jt.step(jp, jmom, batch, seen, 1e-3 / 4)
        _assert_metrics_close(out[2], jmet)
        assert all(v.ndim == 0 for v in out[2].values())
        if step in (0, 2):
            assert _assert_state_close(spec, tp, tmom, jp, jmom) > 30
    after = to_jax_params(spec, tp)[0]["bn"]["mean"]
    assert np.abs(after - before).max() > 1e-3  # the running statistics moved


@pytest.mark.parametrize("zero_tcls", [False, True], ids=["classes", "metayolo_zero_tcls"])
def test_warmup_step_with_clip_norm_matches_jax(tiny, zero_tcls):
    """seen below the warm-up, gradient clipping on, one group, zero
    momentum; and the metayolo branch that zeroes the class targets."""
    spec, jspec, params, _ = tiny
    tp, tmom = _torch_state(spec, params)
    jp = to_jnp_tree(params)
    kw = dict(weight_decay=1e-3, momentum=0.8, clip_norm=5.0, warmup_seen=12800,
              zero_tcls=zero_tcls)
    batch = _batch(20, R=1, b=3)
    _, _, m = PlainTrainer(spec, device="cpu", **kw).step(tp, tmom, batch, 64, 1e-2)
    jp, jmom, jmet = JPlainTrainer(jspec, donate=False, **kw).step(
        jp, j_init_momentum(jp), batch, 64, 1e-2)
    _assert_metrics_close(m, jmet)
    _assert_state_close(spec, tp, tmom, jp, jmom)


def test_weight_decay_spares_bn_affine_and_biases(tiny):
    """One plain SGD step (no momentum, lr 1): conv weights move by
    -(g + wd*p), BN gamma and beta and the head's bias by -g alone
    (reference train.py:132-138)."""
    spec, _, params, _ = tiny
    tr = PlainTrainer(spec, momentum=0.0, weight_decay=0.5, device="cpu")
    batch = _batch(30, R=1, b=2)
    _, grads, _, _ = tr.loss_and_grads(_torch_state(spec, params)[0], batch, 20000)
    tp, tmom = _torch_state(spec, params)
    tr.step(tp, tmom, batch, 20000, 1.0)
    g = dict(tree_leaves_with_path(grads))
    for path, leaf in tree_leaves_with_path(tp):
        if path[-1] in ("mean", "var"):
            continue
        want = params[path[0]]["bn"][path[-1]] if path[1] == "bn" else params[path[0]][path[-1]]
        if path[-1] == "w":
            want = torch.from_numpy(want).permute(3, 2, 0, 1)  # HWIO -> OIHW
            expect = want * 0.5 - g[path]
        else:
            expect = torch.as_tensor(want) - g[path]
        np.testing.assert_allclose(leaf.detach().numpy(), expect.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))


def _run(spec, params, batches, seens, lrs, **kw):
    tp, tmom = _torch_state(spec, params)
    tr = PlainTrainer(spec, weight_decay=5e-4, device="cpu", **kw)
    ms = []
    for b, s, l in zip(batches, seens, lrs):
        tp, tmom, m = tr.step(tp, tmom, b, s, l)
        ms.append(m)
    return tp, tmom, ms


def test_remat_equals_no_remat(tiny):
    """`remat=True` is accepted, as the JAX trainer's keyword, and changes
    nothing: training BN keeps only what rematerialization keeps. Bit-equal
    on the CPU."""
    spec, _, params, _ = tiny
    batches = [_batch(40 + i, R=2, b=1) for i in range(2)]
    args = (batches, [20002, 20004], [1e-3, 2e-3])
    a, b = _run(spec, params, *args), _run(spec, params, *args, remat=True)
    for (pa, x), (pb, y) in zip(tree_leaves_with_path([a[0], a[1]]),
                                tree_leaves_with_path([b[0], b[1]])):
        assert pa == pb and torch.equal(x, y), pa
    for ma, mb in zip(a[2], b[2]):
        assert all(torch.equal(ma[k], mb[k]) for k in METRICS)


def test_every_training_bn_goes_through_bn_sums(tiny, monkeypatch):
    """One forward and one backward of the `bn_sums` function (here its
    plain versions, CPU tensors) a BN layer and group."""
    spec, _, params, _ = tiny
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = bn_mod.bn_sums_reference, bn_mod.bn_sums_backward_reference

    def count(key, fn):
        def run(*a):
            calls[key] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(bn_mod, "bn_sums_reference", count("fwd", fwd))
    monkeypatch.setattr(bn_mod, "bn_sums_backward_reference", count("bwd", bwd))
    tp, tmom = _torch_state(spec, params)
    PlainTrainer(spec, device="cpu").step(tp, tmom, _batch(50, R=2, b=1), 20002, 1e-3)
    assert calls == {"fwd": 2 * N_BN, "bwd": 2 * N_BN}


def test_uint8_and_bfloat16_inputs(tiny):
    """uint8-shipped images decode to value/255 on the device (same step as
    float inputs holding those values, 1e-5); a bfloat16 step keeps float32
    parameters, statistics and loss."""
    spec, _, params, _ = tiny
    batch = _batch(60, R=1, b=2)
    q = np.round(batch["x"] * 255).astype(np.uint8)
    a = _run(spec, params, [{**batch, "x": q}], [20002], [1e-3])
    b = _run(spec, params, [{**batch, "x": q.astype(np.float32) / np.float32(255.0)}],
             [20002], [1e-3])
    for (_, x), (_, y) in zip(tree_leaves_with_path(a[0]), tree_leaves_with_path(b[0])):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-6)
    b16 = {**batch, "x": torch.from_numpy(batch["x"]).to(torch.bfloat16)}
    tp, _, (m,) = _run(spec, params, [b16], [20002], [1e-3], image_dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for _, t in tree_leaves_with_path(tp))
    assert m["loss"].dtype == torch.float32 and bool(torch.isfinite(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(b[2][0]["loss"]), rtol=5e-2)


def test_space_to_depth_stem_is_refused(tiny):
    """No longer refused: `s2d=True` runs the space-to-depth stem, and a
    step equals the JAX trainer's `s2d=True` step (the bounds of the steps
    above; more in tests/test_torch_s2d_stem.py)."""
    spec, jspec, params, mom = tiny
    tp, tmom = _torch_state(spec, params, mom)
    jp, jmom = to_jnp_tree(params), to_jnp_tree(mom)
    batch = _batch(70, R=1, b=2)
    _, _, m = PlainTrainer(spec, s2d=True, device="cpu").step(tp, tmom, batch, 20002, 1e-3)
    jp, jmom, jmet = JPlainTrainer(jspec, s2d=True, donate=False).step(
        jp, jmom, batch, 20002, 1e-3)
    _assert_metrics_close(m, jmet)
    _assert_state_close(spec, tp, tmom, jp, jmom)
