"""The plain YOLOv2 device pipeline of the PyTorch port (per-anchor softmax,
argmax class id, decode -> rank -> NMS per image) and its host decode.

Against the JAX package's DevicePipeline, once through its lax NMS and once
through its Pallas kernel in interpret mode, and against the port's own host
path (`get_region_boxes` + `nms`). Kept boxes must be the same boxes in the
same order with the same class ids; coordinates and confidences agree to
1e-5 (sigmoid/exp/softmax differ in the last float32 bits between the
libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.eval.device_pipeline import DevicePipeline as JPipe
from fewshot_detection_tpu.ops import boxes as jb
from fewshot_detection_tpu_torch.eval.device_pipeline import DevicePipeline, _decode_rank
from fewshot_detection_tpu_torch.ops import boxes as tb
from fewshot_detection_tpu_torch.ops.nms_device import nms_rows

from torch_port_util import t

TOL = 1e-5


class _Region:
    anchor_wh = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38))
    num_classes = 6


def _random_output(rng, b=3, h=5, w=5):
    a = len(_Region.anchor_wh)
    return rng.standard_normal((b, h, w, a * (5 + _Region.num_classes))).astype(np.float32)


def _assert_same_boxes(got, want):
    assert len(got) == len(want)
    total = 0
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"image {r}: {len(g)} vs {len(w)} kept boxes"
        for gb, wb in zip(g, w):
            assert len(gb) == len(wb)
            assert gb[6::2] == [int(v) for v in wb[6::2]]  # class ids, extra pairs' too
            np.testing.assert_allclose(gb, [float(v) for v in wb], rtol=TOL, atol=TOL)
            total += 1
    return total


def _host(out, conf, nms_thresh, validation):
    lists = tb.get_region_boxes(t(out), conf, _Region.num_classes, _Region.anchor_wh,
                                only_objectness=not validation, validation=validation)
    return [tb.nms(bl, nms_thresh) for bl in lists]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["lax", "pallas_interpret"])
@pytest.mark.parametrize("validation", [False, True], ids=["serving", "validation"])
def test_pipeline_matches_jax_and_the_host_path(use_pallas, validation):
    """`__call__` and `eval_boxes`: serving thresholds objectness alone,
    validation det*max_cls_conf and adds the extra (cls_conf, cls_id)
    pairs."""
    out = _random_output(np.random.default_rng(0))
    kw = dict(conf_thresh=0.1 if validation else 0.5, nms_thresh=0.45, top_k=4096,
              validation=validation)
    jpipe = JPipe(_Region, use_pallas=use_pallas, interpret=True, **kw)
    pipe = DevicePipeline(_Region, **kw)
    got, want = pipe(t(out)), jpipe(jnp.asarray(out))
    assert _assert_same_boxes(got, want) > 10
    evals = pipe.eval_boxes(t(out))
    assert _assert_same_boxes(evals, jpipe.eval_boxes(jnp.asarray(out))) > 10
    assert _assert_same_boxes(evals, _host(out, kw["conf_thresh"], 0.45, validation)) > 10
    assert any(len(b) > 7 for row in evals for b in row) == validation
    # the most candidates above the threshold in any image, before the NMS
    pre = tb.get_region_boxes(t(out), kw["conf_thresh"], _Region.num_classes,
                              _Region.anchor_wh, only_objectness=not validation)
    assert pipe.max_candidates == max(map(len, pre)) > 10


def test_empty_image():
    out = _random_output(np.random.default_rng(1), b=2)
    kw = dict(conf_thresh=0.999, nms_thresh=0.4, top_k=16)
    pipe = DevicePipeline(_Region, **kw)
    assert pipe(t(out)) == [[], []]
    assert pipe.eval_boxes(t(out)) == [[], []] == JPipe(_Region, **kw).eval_boxes(jnp.asarray(out))


def test_truncation_reported_and_kept_like_jax():
    """More candidates than the buffer: `eval_boxes` says so (None), and
    `__call__` keeps the top_k highest-objectness ones, as JAX does."""
    out = _random_output(np.random.default_rng(2), b=2)
    kw = dict(conf_thresh=0.2, nms_thresh=0.45, top_k=8, validation=True)
    jpipe = JPipe(_Region, use_pallas=True, interpret=True, **kw)
    pipe = DevicePipeline(_Region, **kw)
    assert pipe.eval_boxes(t(out)) is None and jpipe.eval_boxes(jnp.asarray(out)) is None
    assert pipe.max_candidates > 8
    assert _assert_same_boxes(pipe(t(out)), jpipe(jnp.asarray(out))) > 0
    # nothing suppressed: exactly the 8 highest-objectness candidates
    wide = DevicePipeline(_Region, conf_thresh=0.2, nms_thresh=2.0, top_k=8, validation=True)
    host = _host(out, 0.2, 2.0, True)
    for got, every in zip(wide(t(out)), host):
        assert len(got) == 8
        np.testing.assert_allclose([b[4] for b in got], sorted((b[4] for b in every),
                                                                reverse=True)[:8], rtol=TOL)


def test_tied_class_logits_take_the_first_class():
    """Two classes tie for the maximum: the class id is the first of them
    (numpy and JAX argmax), which decides the result file; the other one
    comes back as an extra pair."""
    out = _random_output(np.random.default_rng(3), b=1)
    o = out.reshape(1, 5, 5, 3, 5 + _Region.num_classes)
    o[..., 5:] = -1.0
    o[..., 5 + 2] = o[..., 5 + 4] = 2.0  # classes 2 and 4 tie everywhere
    out = o.reshape(out.shape)
    kw = dict(conf_thresh=0.05, nms_thresh=0.45, top_k=4096, validation=True)
    got = DevicePipeline(_Region, **kw).eval_boxes(t(out))
    want = JPipe(_Region, use_pallas=False, **kw).eval_boxes(jnp.asarray(out))
    assert _assert_same_boxes(got, want) > 0
    assert _assert_same_boxes(got, _host(out, 0.05, 0.45, True)) > 0
    assert all(b[6] == 2 and b[8] == 4 for b in got[0])
    _, _, _, cid, _, _ = _decode_rank(t(out), None, _Region.anchor_wh, _Region.num_classes,
                                      0.05, 75)
    assert cid.dtype == torch.int64 and set(cid.flatten().tolist()) == {2}


def test_ranking_is_stable_on_tied_objectness():
    """Equal objectness everywhere: the buffer lists candidates in flat
    (cy, cx, anchor) order, as the host's stable argsort does."""
    out = _random_output(np.random.default_rng(4), b=2)
    o = out.reshape(2, 5, 5, 3, -1)
    o[..., 4] = 0.3
    out = o.reshape(out.shape)
    bsel, dsel, _, _, counts, _ = _decode_rank(t(out), None, _Region.anchor_wh,
                                               _Region.num_classes, 0.0, 40, False)
    assert counts.tolist() == [75, 75]
    flat = tb.decode_region_output(t(out), _Region.anchor_wh, _Region.num_classes)["boxes"]
    assert torch.equal(bsel, flat.permute(0, 2, 3, 1, 4).reshape(2, -1, 4)[:, :40])
    kw = dict(conf_thresh=0.0, nms_thresh=0.45, top_k=4096)
    assert _assert_same_boxes(DevicePipeline(_Region, **kw)(t(out)),
                              JPipe(_Region, **kw)(jnp.asarray(out))) > 0


@pytest.mark.parametrize("only_objectness,validation", [(True, False), (False, False), (False, True)])
def test_get_region_boxes_matches_jax(only_objectness, validation):
    out = _random_output(np.random.default_rng(5))
    got = tb.get_region_boxes(t(out), 0.2, _Region.num_classes, _Region.anchor_wh,
                              only_objectness, validation)
    want = jb.get_region_boxes(out, 0.2, _Region.num_classes, _Region.anchor_wh,
                               only_objectness, validation)
    assert _assert_same_boxes(got, want) > 20


def test_region_scores_v1_is_a_per_anchor_softmax():
    out = _random_output(np.random.default_rng(6))
    dec = tb.region_scores_v1(tb.decode_region_output(t(out), _Region.anchor_wh, 6))
    np.testing.assert_allclose(dec["cls_confs"].sum(-1).numpy(), 1.0, rtol=1e-6)
    jdec = jb.region_scores_v1(jb.decode_region_output(jnp.asarray(out), _Region.anchor_wh, 6))
    np.testing.assert_allclose(dec["cls_confs"].numpy(), np.asarray(jdec["cls_confs"]),
                               rtol=TOL, atol=1e-7)


def test_pipeline_goes_through_nms_rows_without_a_launch_on_cpu():
    out = _random_output(np.random.default_rng(7))
    before = nms_rows.launches
    DevicePipeline(_Region, conf_thresh=0.3)(t(out))
    assert nms_rows.launches == before
