"""Plain version of the port's batched NMS against the JAX package's three:
the Pallas kernel (interpret mode), the lax loop, and the host list NMS.
Keep sets must be exactly equal: every path takes the decision
`iou > thresh` on the same float32 value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.ops.boxes import iou_xywh_jnp
from fewshot_detection_tpu.ops.boxes import nms as j_host_nms
from fewshot_detection_tpu.ops.nms_device import nms_jax, nms_pallas
from fewshot_detection_tpu_torch.ops.boxes import iou_xywh, iou_xywh_t
from fewshot_detection_tpu_torch.ops.boxes import nms as t_host_nms
from fewshot_detection_tpu_torch.ops import nms_device
from fewshot_detection_tpu_torch.ops.nms_device import MAX_K, nms_rows, nms_rows_reference

from torch_port_util import t

THRESH = 0.45


def _rows(rng, r, k, n_valid=None, cluster=True):
    """Rows of boxes, confidence-descending, slots past n_valid masked."""
    centers = rng.uniform(0.2, 0.8, (r, 8, 2)) if cluster else None
    boxes = np.empty((r, k, 4), np.float32)
    if cluster:
        which = rng.integers(0, 8, (r, k))
        boxes[..., :2] = np.take_along_axis(centers, which[..., None].repeat(2, -1), 1) \
            + rng.normal(0, 0.03, (r, k, 2))
    else:
        boxes[..., :2] = rng.uniform(0, 1, (r, k, 2))
    boxes[..., 2:] = rng.uniform(0.05, 0.4, (r, k, 2))
    conf = -np.sort(-rng.uniform(0.01, 1.0, (r, k)).astype(np.float32), axis=1)
    if n_valid is not None:
        for i, n in enumerate(n_valid):
            conf[i, n:] = 0.0
    return boxes.astype(np.float32), conf.astype(np.float32)


def _jax_keep(fn, boxes, conf, **kw):
    """Per-row JAX NMS on the valid prefix (its own sort is the identity on
    a descending row with distinct or tied keys, being stable)."""
    out = np.zeros(conf.shape, bool)
    for r in range(conf.shape[0]):
        n = int((conf[r] > 0).sum())
        if n == 0:
            continue
        keep, order = fn(jnp.asarray(boxes[r, :n]), jnp.asarray(conf[r, :n]), THRESH, **kw)
        np.testing.assert_array_equal(np.asarray(order), np.arange(n))
        out[r, :n] = np.asarray(keep)
    return out


def _host_keep(nms, boxes, conf):
    out = np.zeros(conf.shape, bool)
    for r in range(conf.shape[0]):
        lst = [[float(v) for v in boxes[r, j]] + [float(conf[r, j]), float(j)]
               for j in range(conf.shape[1]) if conf[r, j] > 0]
        for kept in nms(lst, THRESH):
            out[r, int(kept[5])] = True
    return out


CASES = {
    "clustered": dict(r=6, k=48, n_valid=[48, 40, 17, 1, 0, 33]),
    "spread": dict(r=4, k=32, n_valid=None, cluster=False),
    "all_masked": dict(r=3, k=16, n_valid=[0, 0, 0]),
    "single": dict(r=1, k=1, n_valid=[1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax_package(case):
    boxes, conf = _rows(np.random.default_rng(sorted(CASES).index(case)), **CASES[case])
    got = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    assert got.dtype == bool and got.shape == conf.shape
    assert not got[conf <= 0].any()
    np.testing.assert_array_equal(got, _jax_keep(nms_pallas, boxes, conf, interpret=True))
    np.testing.assert_array_equal(got, _jax_keep(nms_jax, boxes, conf))
    np.testing.assert_array_equal(got, _host_keep(j_host_nms, boxes, conf))
    np.testing.assert_array_equal(got, _host_keep(t_host_nms, boxes, conf))
    if case == "clustered":
        assert 0 < got.sum() < (conf > 0).sum(), "nothing suppressed: vacuous case"


def test_reference_k845_matches_lax_and_host():
    """The whole 13x13x5 grid as one buffer (top_k >= all candidates)."""
    boxes, conf = _rows(np.random.default_rng(10), 2, 845, n_valid=[845, 600])
    got = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    np.testing.assert_array_equal(got, _jax_keep(nms_jax, boxes, conf))
    np.testing.assert_array_equal(got, _host_keep(t_host_nms, boxes, conf))
    assert 0 < got.sum() < 845


def test_reference_tied_scores_and_duplicates():
    """Equal confidences and exact duplicate boxes: the earlier slot wins,
    as in the host NMS's stable order."""
    rng = np.random.default_rng(11)
    boxes, conf = _rows(rng, 3, 24)
    conf[:] = np.float32(0.5)
    boxes[:, 1::2] = boxes[:, 0::2]  # every odd slot duplicates its left neighbour
    got = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    assert not got[:, 1::2].any()
    np.testing.assert_array_equal(got, _jax_keep(nms_pallas, boxes, conf, interpret=True))
    np.testing.assert_array_equal(got, _host_keep(t_host_nms, boxes, conf))


def test_reference_iou_on_the_threshold():
    """Pairs built so that the IoU sits within a few ulp of the threshold:
    the float32 value decides, identically everywhere."""
    k = 64
    boxes = np.zeros((1, k, 4), np.float32)
    boxes[0, :, :2] = 0.5
    boxes[0, :, 2] = 0.4
    # same centre and width, heights h0 and h: iou = min/max of the heights
    boxes[0, 0, 3] = 0.4
    hs = np.float32(0.4) * np.float32(THRESH) * (1 + np.arange(-31, 32) * np.float32(2.0 ** -22))
    boxes[0, 1:, 3] = hs.astype(np.float32)
    conf = np.linspace(0.9, 0.1, k).astype(np.float32)[None]
    ious = iou_xywh_t(t(boxes[0, :1]), t(boxes[0, 1:])).numpy()
    assert (ious > np.float32(THRESH)).any() and (ious <= np.float32(THRESH)).any()
    np.testing.assert_array_equal(
        ious, np.asarray(iou_xywh_jnp(jnp.asarray(boxes[0, :1]), jnp.asarray(boxes[0, 1:]))))
    got = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    np.testing.assert_array_equal(got, _jax_keep(nms_pallas, boxes, conf, interpret=True))
    np.testing.assert_array_equal(got, _host_keep(t_host_nms, boxes, conf))


def test_iou_xywh_t_bit_equal_to_jnp_and_numpy():
    rng = np.random.default_rng(12)
    a, b = _rows(rng, 1, 200)[0][0], _rows(rng, 1, 200)[0][0]
    got = iou_xywh_t(t(a)[:, None], t(b)[None]).numpy()
    np.testing.assert_array_equal(got, np.asarray(iou_xywh_jnp(jnp.asarray(a)[:, None], jnp.asarray(b)[None])))
    np.testing.assert_array_equal(got, iou_xywh(a[:, None], b[None]))
    zero = torch.zeros(1, 4)
    assert iou_xywh_t(zero, zero).item() == 0.0


def test_nms_rows_on_cpu_is_the_reference_and_counts_no_launch():
    boxes, conf = _rows(np.random.default_rng(13), 3, 20)
    before = nms_rows.launches
    got = nms_rows(t(boxes), t(conf), THRESH)
    assert nms_rows.launches == before
    assert torch.equal(got, nms_rows_reference(t(boxes), t(conf), THRESH))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "rank"])
def test_nms_rows_rejects_what_the_kernel_does_not_take(bad):
    boxes, conf = (t(a) for a in _rows(np.random.default_rng(14), 2, 8))
    if bad == "dtype":
        args, exc = (boxes.double(), conf), TypeError
    elif bad == "shape":
        args, exc = (boxes, conf[:, :7]), ValueError
    elif bad == "contiguous":
        args, exc = (boxes.transpose(0, 1).contiguous().transpose(0, 1), conf), ValueError
    else:
        args, exc = (boxes[0], conf[0]), ValueError
    with pytest.raises(exc):
        nms_rows(*args, THRESH)


@pytest.mark.parametrize("k", [1, 845, MAX_K, MAX_K + 1, 12800])
def test_nms_rows_picks_the_workspace_path_by_k(k, monkeypatch):
    """Rows longer than MAX_K go to the kernel with a workspace, shorter
    ones to shared memory: K alone decides (tensors on the meta device
    reach the launch, which is stood in for here)."""
    seen = []
    monkeypatch.setattr(nms_device, "_launch", lambda b, d, thresh, long: seen.append(long))
    nms_rows(torch.empty((2, k, 4), device="meta"), torch.empty((2, k), device="meta"), THRESH)
    assert seen == [k > MAX_K]


def test_reference_above_max_k_matches_host():
    """A row longer than the shared-memory limit (a portrait WIDER image's
    grid), spread boxes so that much is suppressed, a masked tail: the plain
    version against both packages' host NMS."""
    k = MAX_K + 64
    boxes, conf = _rows(np.random.default_rng(15), 1, k, n_valid=[k - 40], cluster=False)
    got = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    np.testing.assert_array_equal(got, _host_keep(t_host_nms, boxes, conf))
    np.testing.assert_array_equal(got, _host_keep(j_host_nms, boxes, conf))
    assert 0 < got.sum() < k - 40
