"""`MetaTrainer` of the PyTorch port against the JAX package's, on the CPU.

One numpy (params, momentum, batch) goes to both trainers; after the steps
every parameter, every momentum leaf, the BN running statistics (they are
leaves of the parameter tree) and every metric are compared. float32 on both
sides; convolutions and sums run in another order in the two libraries and
the difference compounds through momentum: rtol 1e-4, with an absolute floor
of 1e-4 of the leaf's largest value, after one step and after three. (The
floor is for the first layers' momentum, i.e. their gradients: sums over
every pixel whose terms cancel. Measured worst deviation on this fixture
after three steps: 3e-5 of a leaf's largest value in the momentum, 4e-7 in
the parameters.)"""

import jax
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.models import meta as jm
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu.train import MetaTrainer as JMetaTrainer
from fewshot_detection_tpu.train import init_momentum as j_init_momentum
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.models import meta as tm
from fewshot_detection_tpu_torch.models.convert import (
    from_jax_momentum,
    from_jax_params,
    require_grads,
    to_jax_momentum,
    to_jax_params,
)
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.train import MetaTrainer, init_momentum
from fewshot_detection_tpu_torch.train.optim import tree_leaves_with_path
from fewshot_detection_tpu_torch.train.trainer import apply_meta_bn_updates

from torch_port_util import cfg, randomize_bn, to_jnp_tree

N_CLS, SIZE = 3, 64
METRICS = ("nGT", "nCorrect", "nProposals", "loss_x", "loss_y", "loss_w", "loss_h",
           "loss_conf", "loss_cls", "loss")
NETS = ("darknet", "learnet")


@pytest.fixture(scope="module")
def tiny():
    names = ("tiny_darknet_dynamic.cfg", "tiny_reweighting.cfg")
    spec = tm.MetaSpec(*(build_spec(parse_cfg(cfg(n))) for n in names))
    jspec = jm.MetaSpec(*(j_build_spec(j_parse_cfg(cfg(n))) for n in names))
    params = tm.init_meta_params(spec, 0)
    rng = np.random.default_rng(1)
    for k in NETS:
        for p in params[k]:
            if p and "w" in p:
                p["w"] = p["w"] * 2.0  # keep activations O(1) through the stack
        randomize_bn(params[k], rng)
    mom = {k: [None if p is None else jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), p)
        for p in params[k]] for k in NETS}
    return spec, jspec, params, mom


def _batch(seed, R, b, dtype=np.float32):
    r = np.random.RandomState(seed)
    target = np.zeros((R, b, N_CLS, 50, 5), np.float32)
    for g in range(R):
        for i in range(b):
            c = r.randint(N_CLS)
            target[g, i, c, 0] = [c, r.uniform(0.3, 0.7), r.uniform(0.3, 0.7), 0.3, 0.3]
    keep = np.ones((R, b * N_CLS), np.float32)
    keep[:, 1] = (target.reshape(R, b * N_CLS, -1)[:, 1] != 0).any(-1)  # drop one negative copy
    return {
        "x": r.rand(R, b, SIZE, SIZE, 3).astype(dtype),
        "metax": r.rand(R, N_CLS, SIZE, SIZE, 3).astype(dtype),
        "mask": (r.rand(R, N_CLS, SIZE, SIZE, 1) > 0.5).astype(dtype),
        "target": target,
        "keep": keep,
    }


def _torch_state(spec, params, mom=None):
    tp = require_grads({k: from_jax_params(getattr(spec, k), params[k], "cpu") for k in NETS})
    if mom is None:
        return tp, init_momentum(tp)
    return tp, {k: from_jax_momentum(getattr(spec, k), mom[k], "cpu") for k in NETS}


def _assert_state_close(spec, tp, tmom, jp, jmom, rtol=1e-4, floor=1e-4):
    n = 0
    for k in NETS:
        for got, want in ((to_jax_params(getattr(spec, k), tp[k]), jp[k]),
                          (to_jax_momentum(getattr(spec, k), tmom[k]), jmom[k])):
            gl = dict(tree_leaves_with_path(got))
            wl = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, list(want))))
            assert gl.keys() == wl.keys()
            for path in gl:
                np.testing.assert_allclose(gl[path], wl[path], rtol=rtol,
                                           atol=floor * np.abs(wl[path]).max(),
                                           err_msg=f"{k}{path}")
                n += 1
    return n


def _assert_metrics_close(m, jmet, rtol=1e-4):
    for k in METRICS:
        np.testing.assert_allclose(np.asarray(m[k].cpu()), np.asarray(jmet[k]), rtol=rtol,
                                   atol=1e-5, err_msg=k)


def test_one_and_three_steps_match_jax_with_two_groups(tiny):
    """R = 2 groups (each with its own batch statistics, running statistics
    averaged), a momentum tree that is not zero, seen past the warm-up."""
    spec, jspec, params, mom = tiny
    tp, tmom = _torch_state(spec, params, mom)
    jp = {k: to_jnp_tree(params[k]) for k in NETS}
    jmom = {k: to_jnp_tree(mom[k]) for k in NETS}
    tr = MetaTrainer(spec, weight_decay=5e-4, device="cpu")
    jt = JMetaTrainer(jspec, weight_decay=5e-4, donate=False)
    before = to_jax_params(spec.darknet, tp["darknet"])[0]["bn"]["mean"].copy()
    for step in range(3):
        batch = _batch(10 + step, R=2, b=2)
        seen = 20000 + 4 * (step + 1)
        out = tr.step(tp, tmom, batch, seen, 1e-4)
        assert out[0] is tp and out[1] is tmom  # in place
        jp, jmom, jmet = jt.step(jp, jmom, batch, seen, 1e-4)
        _assert_metrics_close(out[2], jmet)
        assert all(v.ndim == 0 for v in out[2].values())
        if step in (0, 2):
            assert _assert_state_close(spec, tp, tmom, jp, jmom) > 100
    after = to_jax_params(spec.darknet, tp["darknet"])[0]["bn"]["mean"]
    assert np.abs(after - before).max() > 1e-3  # the running statistics moved


@pytest.mark.parametrize("darknet_mode", [False, True], ids=["torch_bn", "darknet_bn"])
def test_warmup_step_with_clip_norm_matches_jax_in_both_bn_modes(tiny, monkeypatch, darknet_mode):
    """seen below the warm-up (every cell pulled to the box prior), gradient
    clipping on, one group, zero momentum, and both running-statistics modes."""
    if darknet_mode:
        monkeypatch.setenv("FSD_BN_DARKNET", "1")
    else:
        monkeypatch.delenv("FSD_BN_DARKNET", raising=False)
    spec, jspec, params, _ = tiny
    tp, tmom = _torch_state(spec, params)
    jp = {k: to_jnp_tree(params[k]) for k in NETS}
    kw = dict(weight_decay=1e-3, momentum=0.8, clip_norm=5.0, warmup_seen=12800)
    batch = _batch(20, R=1, b=3)
    _, _, m = MetaTrainer(spec, device="cpu", **kw).step(tp, tmom, batch, 64, 1e-3)
    jp, jmom, jmet = JMetaTrainer(jspec, donate=False, **kw).step(
        jp, j_init_momentum(jp), batch, 64, 1e-3)
    _assert_metrics_close(m, jmet)
    _assert_state_close(spec, tp, tmom, jp, jmom)


def _run(spec, params, batches, seens, lrs, multi=False, **kw):
    tp, tmom = _torch_state(spec, params)
    tr = MetaTrainer(spec, weight_decay=5e-4, device="cpu", **kw)
    if multi:
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        tp, tmom, ms = tr.multi_step(tp, tmom, stacked, seens, lrs)
        return tp, tmom, [{k: v[i] for k, v in ms.items()} for i in range(len(batches))]
    ms = []
    for b, s, l in zip(batches, seens, lrs):
        tp, tmom, m = tr.step(tp, tmom, b, s, l)
        ms.append(m)
    return tp, tmom, ms


def _assert_runs_equal(a, b, rtol=0.0, atol=0.0):
    for (pa, x), (pb, y) in zip(tree_leaves_with_path([a[0], a[1]]),
                                tree_leaves_with_path([b[0], b[1]])):
        assert pa == pb
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=rtol, atol=atol,
                                   err_msg=str(pa))
    for ma, mb in zip(a[2], b[2]):
        for k in METRICS:
            np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=max(rtol, 1e-7), err_msg=k)


@pytest.fixture(scope="module")
def two_steps(tiny):
    spec, _, params, _ = tiny
    batches = [_batch(30 + i, R=2, b=1) for i in range(2)]
    seens, lrs = [20002, 20004], [1e-4, 2e-4]
    return batches, seens, lrs, _run(spec, params, batches, seens, lrs)


def test_remat_equals_no_remat(tiny, two_steps):
    """`remat=True` is accepted, as the JAX trainer's keyword, and changes
    nothing: training BN keeps only what rematerialization keeps. Bit-equal
    on the CPU."""
    batches, seens, lrs, base = two_steps
    _assert_runs_equal(_run(tiny[0], tiny[2], batches, seens, lrs, remat=True), base)


def test_multi_step_equals_sequential_steps(tiny, two_steps):
    batches, seens, lrs, base = two_steps
    got = _run(tiny[0], tiny[2], batches, seens, lrs, multi=True)
    _assert_runs_equal(got, base)
    assert len(got[2]) == 2


def test_uint8_inputs_equal_float_inputs(tiny, two_steps):
    """uint8-shipped images decode on the device to value/255: the same
    step as on float inputs holding those values (1e-6: x/255 against the
    host's float32 division)."""
    batches, seens, lrs, _ = two_steps
    u8, f32 = [], []
    for b in batches:
        q = {k: np.round(b[k] * 255).astype(np.uint8) for k in ("x", "metax", "mask")}
        u8.append({**b, **q})
        f32.append({**b, **{k: v.astype(np.float32) / np.float32(255.0) for k, v in q.items()}})
    spec, _, params, _ = tiny
    _assert_runs_equal(_run(spec, params, u8, seens, lrs), _run(spec, params, f32, seens, lrs),
                       rtol=1e-5, atol=1e-6)


def test_bfloat16_step_keeps_float32_parameters_statistics_and_loss(tiny):
    spec, _, params, _ = tiny
    batch = _batch(40, R=1, b=2)
    tp, tmom = _torch_state(spec, params)
    b16 = {k: (torch.from_numpy(v).to(torch.bfloat16) if k in ("x", "metax", "mask") else v)
           for k, v in batch.items()}
    tr = MetaTrainer(spec, image_dtype=torch.bfloat16, device="cpu")
    _, _, m16 = tr.step(tp, tmom, b16, 20000, 1e-4)
    assert all(t.dtype == torch.float32 for _, t in tree_leaves_with_path([tp, tmom]))
    assert m16["loss"].dtype == torch.float32 and bool(torch.isfinite(m16["loss"]))
    tp2, tmom2 = _torch_state(spec, params)
    _, _, m32 = MetaTrainer(spec, device="cpu").step(tp2, tmom2, batch, 20000, 1e-4)
    # bfloat16 keeps 8 bits: the loss agrees with float32 to a few percent
    np.testing.assert_allclose(float(m16["loss"]), float(m32["loss"]), rtol=5e-2)


def test_apply_meta_bn_updates_stem_first_detect_pass_wins():
    def bn(v):
        return {"bn": {"mean": torch.full((2,), v), "var": torch.full((2,), v)}}

    params = {"darknet": [bn(0.0), bn(0.0), None], "learnet": [bn(0.0)]}
    upd = lambda v: {"mean": torch.full((2,), v), "var": torch.full((2,), v + 0.5)}
    apply_meta_bn_updates(params, {
        "darknet_stem": {0: upd(1.0), 1: upd(2.0)},
        "darknet": {1: upd(3.0)},
        "learnet": {0: upd(4.0)},
    })
    assert params["darknet"][0]["bn"]["mean"].tolist() == [1.0, 1.0]
    assert params["darknet"][1]["bn"]["mean"].tolist() == [3.0, 3.0]
    assert params["darknet"][1]["bn"]["var"].tolist() == [3.5, 3.5]
    assert params["learnet"][0]["bn"]["mean"].tolist() == [4.0, 4.0]


def test_require_grads_leaves_running_statistics_out(tiny):
    spec, _, params, _ = tiny
    tp, _ = _torch_state(spec, params)
    for path, leaf in tree_leaves_with_path(tp):
        assert leaf.requires_grad == (path[-1] not in ("mean", "var")), path
