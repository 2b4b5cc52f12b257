"""Device pipeline of the PyTorch port (decode -> rank -> NMS per row).

Against the JAX package's MetaDevicePipeline run with its Pallas kernel in
interpret mode, and against the port's own host path. Kept boxes must be the
same boxes in the same order; coordinates and confidences agree to 1e-5
(sigmoid/exp/softmax differ in the last float32 bits between libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.eval.device_pipeline import MetaDevicePipeline as JPipe
from fewshot_detection_tpu.ops import boxes as jb
from fewshot_detection_tpu_torch.eval.device_pipeline import (
    MetaDevicePipeline,
    _decode_rank,
)
from fewshot_detection_tpu_torch.ops import boxes as tb
from fewshot_detection_tpu_torch.ops.nms_device import nms_rows

from torch_port_util import t

N_CLS = 4


class _Region:
    anchor_wh = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38))
    num_classes = 1  # metayolo single-class head per copy


class _Region3(_Region):
    num_classes = 3


def _random_output(rng, region, b=2, h=5, w=5):
    a = len(region.anchor_wh)
    return rng.standard_normal((b * N_CLS, h, w, a * (5 + region.num_classes))).astype(np.float32)


def _assert_same_boxes(got, want, tol=1e-5):
    assert len(got) == len(want)
    total = 0
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"row {r}: {len(g)} vs {len(w)} kept boxes"
        for gb, wb in zip(g, w):
            assert len(gb) == len(wb)
            np.testing.assert_allclose(gb, [float(v) for v in wb], rtol=tol, atol=tol)
            total += 1
    return total


@pytest.mark.parametrize("top_k", [64, 4096], ids=["k64", "kall"])
def test_call_matches_jax_pipeline_with_pallas_interpret(top_k):
    out = _random_output(np.random.default_rng(0), _Region)
    kw = dict(conf_thresh=0.15, nms_thresh=0.45, top_k=top_k)
    want = JPipe(_Region, N_CLS, use_pallas=True, interpret=True, **kw)(jnp.asarray(out))
    got = MetaDevicePipeline(_Region, N_CLS, **kw)(t(out))
    assert _assert_same_boxes(got, want) > 0
    for r, row in enumerate(got):
        assert all(box[6] == r % N_CLS for box in row)


def test_eval_boxes_matches_jax_pipeline_and_host_path():
    """validation format incl. the extra (cls_conf, cls_id) pairs of a
    multi-class head."""
    out = _random_output(np.random.default_rng(1), _Region3)
    kw = dict(conf_thresh=0.05, nms_thresh=0.45, top_k=4096)
    want = JPipe(_Region3, N_CLS, use_pallas=True, interpret=True, **kw).eval_boxes(jnp.asarray(out))
    got = MetaDevicePipeline(_Region3, N_CLS, **kw).eval_boxes(t(out))
    assert want is not None and got is not None
    assert _assert_same_boxes(got, want) > 0
    assert any(len(b) > 7 for row in got for b in row), "no extra class pairs: vacuous"
    # the port's host path: decode + filter + host nms
    host = tb.get_region_boxes_v2(t(out), N_CLS, 0.05, 3, _Region3.anchor_wh,
                                  only_objectness=False, validation=True)
    host = [tb.nms(bl, 0.45) for bl in host]
    for g, h in zip(got, host):
        assert len(g) == len(h)
        for gb, hb in zip(g, h):
            # column 6 differs by design: class-copy index vs argmax id
            np.testing.assert_allclose(gb[:6], hb[:6], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(gb[7:], hb[7:], rtol=1e-6, atol=1e-7)


def test_eval_boxes_reports_truncation_like_jax():
    out = _random_output(np.random.default_rng(2), _Region)
    kw = dict(conf_thresh=0.005, nms_thresh=0.45, top_k=8)
    assert JPipe(_Region, N_CLS, use_pallas=False, interpret=True, **kw).eval_boxes(jnp.asarray(out)) is None
    assert MetaDevicePipeline(_Region, N_CLS, **kw).eval_boxes(t(out)) is None


def test_empty_rows():
    out = _random_output(np.random.default_rng(3), _Region, b=1)
    pipe = MetaDevicePipeline(_Region, N_CLS, conf_thresh=0.999, nms_thresh=0.45, top_k=16)
    assert pipe(t(out)) == [[] for _ in range(N_CLS)]


def test_ranking_is_stable_on_tied_objectness():
    """All candidates share one objectness logit: the buffer must list them
    in flat (cy, cx, anchor) order, as jax.lax.top_k and the host's stable
    argsort do. torch.topk gives no such promise."""
    rng = np.random.default_rng(4)
    out = _random_output(rng, _Region, b=1, h=6, w=6)
    o = out.reshape(N_CLS, 6, 6, 3, 6)
    o[..., 4] = 0.3  # equal det everywhere
    o[..., 5] = 0.0  # equal class logits: cls = 1/N_CLS on every copy
    out = o.reshape(out.shape)
    bsel, dsel, _, cid, counts, _ = _decode_rank(t(out), N_CLS, _Region.anchor_wh, 1, 0.005, 50)
    assert counts.tolist() == [108] * N_CLS
    decoded = tb.decode_region_output(t(out), _Region.anchor_wh, 1)
    flat = decoded["boxes"].permute(0, 2, 3, 1, 4).reshape(N_CLS, -1, 4)
    assert torch.equal(bsel, flat[:, :50])
    assert cid.dtype in (torch.int32, torch.int64)
    kw = dict(conf_thresh=0.005, nms_thresh=0.45, top_k=4096)
    want = JPipe(_Region, N_CLS, use_pallas=True, interpret=True, **kw)(jnp.asarray(out))
    got = MetaDevicePipeline(_Region, N_CLS, **kw)(t(out))
    assert _assert_same_boxes(got, want) > 0


def test_class_index_exact_past_256_rows_from_bf16_output():
    """A bf16 head output must not make the class index inexact (bf16 holds
    integers only up to 256)."""
    n_cls, b = 20, 15  # 300 rows
    rng = np.random.default_rng(5)
    out = rng.standard_normal((b * n_cls, 2, 2, 3 * 6)).astype(np.float32)
    pipe = MetaDevicePipeline(_Region, n_cls, conf_thresh=0.0, nms_thresh=2.0, top_k=4)
    rows, keep = pipe.device_call(t(out).to(torch.bfloat16))
    assert rows.dtype == torch.float32
    want = (torch.arange(b * n_cls) % n_cls).float()[:, None].expand(-1, 4)
    assert torch.equal(rows[..., 6], want)


def test_cross_copy_softmax_is_over_the_class_copies():
    out = _random_output(np.random.default_rng(6), _Region3, b=2)
    dec = tb.region_scores_v2(tb.decode_region_output(t(out), _Region3.anchor_wh, 3), N_CLS)
    conf = dec["cls_confs"].reshape(2, N_CLS, *dec["cls_confs"].shape[1:])
    np.testing.assert_allclose(conf.sum(1).numpy(), 1.0, rtol=1e-5)
    jdec = jb.region_scores_v2(jb.decode_region_output(jnp.asarray(out), _Region3.anchor_wh, 3), N_CLS)
    for k in ("boxes", "det_conf", "cls_confs"):
        np.testing.assert_allclose(dec[k].numpy(), np.asarray(jdec[k]), rtol=1e-5, atol=1e-6)


def test_pipeline_goes_through_nms_rows_without_a_launch_on_cpu():
    out = _random_output(np.random.default_rng(7), _Region)
    before = nms_rows.launches
    MetaDevicePipeline(_Region, N_CLS, conf_thresh=0.15, top_k=32)(t(out))
    assert nms_rows.launches == before
