"""Region losses of the PyTorch port against the JAX package's, on the CPU.

The same numpy head output, targets and keep weights go through both; every
metric and the gradient to `output` are compared. float32 on both sides,
sums over a few hundred cells in another order: rtol 1e-5 on the losses,
rtol 1e-5 / atol 1e-6 on the gradient. Counts are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.models.spec import RegionSpec as JRegion
from fewshot_detection_tpu.ops import region_loss as jrl
from fewshot_detection_tpu_torch.models.spec import RegionSpec
from fewshot_detection_tpu_torch.ops import region_loss as trl

from torch_port_util import t

ANCHORS = (1.3221, 1.73145, 3.19275, 4.00944, 5.05587, 8.09892)
KW1 = dict(anchors=ANCHORS, num_classes=1, num_anchors=3)
KW4 = dict(anchors=ANCHORS, num_classes=4, num_anchors=3)
LOSSES = ("loss_x", "loss_y", "loss_w", "loss_h", "loss_conf", "loss_cls", "loss")
COUNTS = ("nGT", "nCorrect", "nProposals")


def _box(rng, cls):
    return [cls, rng.uniform(0.08, 0.92), rng.uniform(0.08, 0.92),
            rng.uniform(0.05, 0.4), rng.uniform(0.05, 0.4)]


def _meta_targets(rng, bs, cs):
    """Copy c holds only class-c boxes; some copies are empty negatives."""
    tgt = np.zeros((bs, cs, 50, 5), np.float32)
    for b in range(bs):
        for c in range(cs):
            if rng.rand() < 0.5:
                continue
            for i in range(rng.randint(1, 3)):
                tgt[b, c, i] = _box(rng, c)
    return tgt


def _plain_targets(rng, n, n_cls):
    tgt = np.zeros((n, 50, 5), np.float32)
    for b in range(n):
        for i in range(rng.randint(0, 4)):
            tgt[b, i] = _box(rng, rng.randint(0, n_cls))
    return tgt


def _compare(jfn, tfn, out, name):
    """Run both losses on `out` (nB, H, W, ch); compare metrics and d/d out."""
    (jloss, jmetrics), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(out))
    o = t(out).requires_grad_(True)
    loss, metrics = tfn(o)
    (grad,) = torch.autograd.grad(loss, o)
    metrics = {k: v.detach() for k, v in metrics.items()}
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name}: {k}")
    for k in COUNTS:
        assert int(metrics[k]) == int(jmetrics[k]), f"{name}: {k}"
    assert float(loss.detach()) == float(metrics["loss"])
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6,
                               err_msg=f"{name}: gradient")
    return metrics


def _v2(out, target, keep, seen, cs, **kw):
    jfn = lambda o: jrl.region_loss_v2(o, jnp.asarray(target), jnp.asarray(keep),
                                       jnp.asarray(seen), JRegion(**KW1), cs, **kw)
    tfn = lambda o: trl.region_loss_v2(o, t(target), t(keep), seen, RegionSpec(**KW1), cs, **kw)
    return _compare(jfn, tfn, out, f"v2 seen={seen}")


@pytest.mark.parametrize("seen", [0, 12799, 12800, 20000])
def test_region_loss_v2_matches_jax_below_and_above_warmup(seen):
    rng = np.random.RandomState(2)
    bs, cs, H, W = 2, 4, 5, 5
    out = (rng.randn(bs * cs, H, W, 18) * 0.5).astype(np.float32)
    m = _v2(out, _meta_targets(rng, bs, cs), np.ones(bs * cs, np.float32), seen, cs)
    assert int(m["nGT"]) > 0


def test_region_loss_v2_warmup_seen_argument_matches_jax():
    rng = np.random.RandomState(3)
    bs, cs = 1, 3
    out = (rng.randn(bs * cs, 4, 4, 18) * 0.5).astype(np.float32)
    tgt = _meta_targets(rng, bs, cs)
    a = _v2(out, tgt, np.ones(bs * cs, np.float32), 0, cs, warmup_seen=0)
    b = _v2(out, tgt, np.ones(bs * cs, np.float32), 0, cs)
    assert float(a["loss_x"]) != pytest.approx(float(b["loss_x"]))


def test_sample_neg_keep_equals_jax_for_one_random_state():
    rng = np.random.RandomState(4)
    tgt = _meta_targets(rng, 4, 5).reshape(20, -1)
    for ratio in ("full", 0, 1, 5, 0.5):
        a = trl.sample_neg_keep(tgt, ratio, np.random.RandomState(7))
        b = jrl.sample_neg_keep(tgt, ratio, np.random.RandomState(7))
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32
    assert 0 < trl.sample_neg_keep(tgt, 0.5, np.random.RandomState(7)).sum() < 20


def test_region_loss_v2_with_sampled_keep_matches_jax():
    rng = np.random.RandomState(5)
    bs, cs = 2, 5
    out = (rng.randn(bs * cs, 4, 4, 18) * 0.5).astype(np.float32)
    tgt = _meta_targets(rng, bs, cs)
    keep = trl.sample_neg_keep(tgt.reshape(bs * cs, -1), 1, np.random.RandomState(7))
    assert 0 < keep.sum() < bs * cs  # some negatives dropped
    _v2(out, tgt, keep, 20000, cs)


def test_region_loss_v2_duplicate_cells_last_write_wins():
    """Two, then three, gts of one copy in one cell with one best anchor: the
    last one owns the targets (the case of the JAX package's
    test_duplicate_cell_last_write_wins), here through both frameworks."""
    rng = np.random.RandomState(6)
    bs, cs = 1, 2
    out = (rng.randn(bs * cs, 4, 4, 18) * 0.3).astype(np.float32)
    tgt = np.zeros((bs, cs, 50, 5), np.float32)
    tgt[0, 0, 0] = [0, 0.55, 0.55, 0.2, 0.2]
    tgt[0, 0, 1] = [0, 0.60, 0.60, 0.2, 0.2]
    tgt[0, 1, 0] = [1, 0.30, 0.30, 0.2, 0.2]
    tgt[0, 1, 1] = [1, 0.32, 0.31, 0.2, 0.2]
    tgt[0, 1, 2] = [1, 0.34, 0.33, 0.2, 0.2]
    m = _v2(out, tgt, np.ones(2, np.float32), 20000, cs)
    assert int(m["nGT"]) == 5
    # the planes hold the LAST duplicate's offsets
    pred = trl._decode_pred_boxes(trl._split_output(t(out), RegionSpec(**KW1))[0], RegionSpec(**KW1))
    planes = trl.build_targets(pred, t(tgt.reshape(2, 50, 5)), RegionSpec(**KW1), 4, 4, 20000)
    assert float(planes["coord_mask"].sum()) == 2.0
    np.testing.assert_allclose(float(planes["tx"][0].sum()), 0.60 * 4 - 2, rtol=1e-5)
    np.testing.assert_allclose(float(planes["tx"][1].sum()), 0.34 * 4 - 1, rtol=1e-5)


def test_region_loss_v2_cell_marked_by_two_copies():
    """Two kept copies mark one (anchor, cell): the cell is masked out of the
    cross-entropy; with one of them dropped by `keep` it counts again. With
    copies 0 and 1 the summed label (0 + 1) is in range and both packages
    agree. With copies 1 and 2 it is 3, out of range for 3 copies: the port
    replaces the label under the mask before it gathers (on the card an
    out-of-range gather is a device-side assert) and gives 0 for the cell,
    where the JAX package's gather fills NaN and NaN * 0 makes its loss NaN."""
    rng = np.random.RandomState(7)
    bs, cs = 1, 3
    out = (rng.randn(bs * cs, 4, 4, 18) * 0.5).astype(np.float32)
    tgt = np.zeros((bs, cs, 50, 5), np.float32)
    tgt[0, 0, 0] = [0, 0.55, 0.55, 0.2, 0.2]
    tgt[0, 1, 0] = [1, 0.57, 0.56, 0.2, 0.2]
    both = _v2(out, tgt, np.ones(3, np.float32), 20000, cs)
    assert float(both["loss_cls"]) == 0.0
    one = _v2(out, tgt, np.asarray([1, 0, 1], np.float32), 20000, cs)
    assert float(one["loss_cls"]) > 0.0

    tgt = np.zeros((bs, cs, 50, 5), np.float32)
    tgt[0, 1, 0] = [1, 0.55, 0.55, 0.2, 0.2]
    tgt[0, 2, 0] = [2, 0.57, 0.56, 0.2, 0.2]
    region = RegionSpec(**KW1)
    o = t(out).requires_grad_(True)
    loss, m = trl.region_loss_v2(o, t(tgt), torch.ones(3), 20000, region, cs)
    (g,) = torch.autograd.grad(loss, o)
    assert float(m["loss_cls"].detach()) == 0.0 and np.isfinite(float(loss.detach()))
    assert bool(torch.isfinite(g).all())
    _, jm = jrl.region_loss_v2(jnp.asarray(out), jnp.asarray(tgt), jnp.ones(3),
                               jnp.asarray(20000), JRegion(**KW1), cs)
    for k in ("loss_x", "loss_y", "loss_w", "loss_h", "loss_conf"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=1e-5, err_msg=k)
    assert np.isnan(float(jm["loss_cls"]))  # the difference recorded in ROADMAP Queue 3
    _v2(out, tgt, np.asarray([1, 1, 0], np.float32), 20000, cs)  # one copy dropped: parity again


def test_region_loss_v2_all_padding_target():
    rng = np.random.RandomState(8)
    bs, cs = 2, 3
    out = (rng.randn(bs * cs, 3, 3, 18) * 0.5).astype(np.float32)
    for seen in (0, 20000):
        m = _v2(out, np.zeros((bs, cs, 50, 5), np.float32), np.ones(bs * cs, np.float32), seen, cs)
        assert int(m["nGT"]) == 0 and float(m["loss_cls"]) == 0.0


def test_region_loss_v2_takes_bfloat16_output_and_computes_in_float32():
    rng = np.random.RandomState(9)
    bs, cs = 1, 3
    out = (rng.randn(bs * cs, 4, 4, 18) * 0.5).astype(np.float32)
    tgt = _meta_targets(rng, bs, cs)
    o16 = t(out).to(torch.bfloat16).requires_grad_(True)
    loss, _ = trl.region_loss_v2(o16, t(tgt), torch.ones(3), 20000, RegionSpec(**KW1), cs)
    assert loss.dtype == torch.float32
    (g,) = torch.autograd.grad(loss, o16)
    assert g.dtype == torch.bfloat16
    want, _ = trl.region_loss_v2(o16.detach().float(), t(tgt), torch.ones(3), 20000,
                                 RegionSpec(**KW1), cs)
    assert float(loss.detach()) == float(want)
    with pytest.raises(NotImplementedError):
        trl.region_loss_v2(t(out), t(tgt), torch.ones(3), 0, RegionSpec(**KW4), cs)


@pytest.mark.parametrize("seen,zero_tcls", [(0, False), (20000, False), (20000, True)])
def test_region_loss_plain_matches_jax(seen, zero_tcls):
    rng = np.random.RandomState(10)
    nB, H, W = 3, 5, 5
    out = (rng.randn(nB, H, W, 27) * 0.5).astype(np.float32)
    tgt = _plain_targets(rng, nB, 4)
    tgt[0, 0] = [2, 0.55, 0.55, 0.2, 0.2]  # a duplicate cell, last write wins
    tgt[0, 1] = [3, 0.60, 0.60, 0.2, 0.2]
    keep = np.asarray([1, 0, 1], np.float32)
    jfn = lambda o: jrl.region_loss(o, jnp.asarray(tgt), jnp.asarray(keep), jnp.asarray(seen),
                                    JRegion(**KW4), zero_tcls=zero_tcls)
    tfn = lambda o: trl.region_loss(o, t(tgt), t(keep), seen, RegionSpec(**KW4),
                                    zero_tcls=zero_tcls)
    _compare(jfn, tfn, out, f"plain seen={seen}")
