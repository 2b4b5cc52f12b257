"""The logic of the port's CUDA NMS kernel (`csrc/nms.cu`), modelled in Python.

The kernel cannot run without a card. What can be held on the CPU is its
algorithm: candidates settled in groups of 32 (each group's triangle of
overlaps as 32-bit words, the group's members settled among themselves in
rounds of ballots, later candidates compared with the kept members only, the
members split among the threads that share a candidate by bit position).
`grouped_nms_model` below mirrors the kernel step by step on numpy values and
is held against `nms_rows_reference`, which the kernel
itself is held against on the card (`chip_smoke.py`). Decisions must be
exactly equal: both sides decide `iou > thresh` on the same float32 values.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fewshot_detection_tpu_torch.ops.boxes import iou_xywh_t
from fewshot_detection_tpu_torch.ops.nms_device import MAX_K, nms_rows_reference

from torch_port_util import t

THRESH = 0.45
def stripe_of(ls):
    """csrc/nms.cu:stripe_of: every (1 << ls)-th member bit."""
    return sum(1 << i for i in range(0, 32, 1 << ls))


def stripes(ls):
    """The member bits each of the 1 << ls threads of a candidate takes. The
    kernel is built for ls = 0 and 1; the split holds for any ls up to 5."""
    return [(stripe_of(ls) << sub) & 0xFFFFFFFF for sub in range(1 << ls)]


def overlap_word(over, g0, j, mask):
    """Bits i of mask with over[g0 + i, j]: the kernel's `overlap_word`."""
    word = 0
    for i in range(32):
        if (mask >> i) & 1 and over[g0 + i, j]:
            word |= 1 << i
    return word


def settle(words, gmask):
    """Step (b): lanes = members, rounds of two ballots. Returns (kept bits,
    rounds taken)."""
    und = [(gmask >> lane) & 1 == 1 for lane in range(32)]
    word = [words[lane] & gmask if und[lane] else 0 for lane in range(32)]
    kept = [False] * 32
    rounds = 0
    while True:
        u = sum(1 << lane for lane in range(32) if und[lane])
        if u == 0:
            break
        rounds += 1
        km = sum(1 << lane for lane in range(32) if kept[lane])
        for lane in range(32):
            if und[lane]:
                if word[lane] & km:
                    und[lane] = False
                elif not word[lane] & u:
                    und[lane] = False
                    kept[lane] = True
    return sum(1 << lane for lane in range(32) if kept[lane]), rounds


def grouped_nms_model(over, conf, ls):
    """One row through the kernel's steps. over (K, K) bool, over[i, j] =
    iou(box i, box j) > thresh; conf (K,) float32; 1 << ls threads share a
    candidate. Returns (keep (K,) bool, most rounds any group took)."""
    k = len(conf)
    live = np.flatnonzero(conf > 0)
    n = int(live[-1]) + 1 if len(live) else 0
    alive = conf > 0
    # (t) every group's triangle, the members split by stripe and OR-ed
    words = [0] * k
    for j in range(n):
        if alive[j]:
            rel = j & 31
            for stripe in stripes(ls):
                words[j] |= overlap_word(over, j - rel, j, ((1 << rel) - 1) & stripe)
    worst = 0
    for g0 in range(0, n, 32):
        gmask = sum(1 << lane for lane in range(32) if g0 + lane < n and alive[g0 + lane])
        if gmask == 0:
            continue
        km, rounds = settle([words[g0 + lane] if g0 + lane < n else 0 for lane in range(32)], gmask)
        worst = max(worst, rounds)
        for lane in range(32):  # dropped members
            if (gmask >> lane) & 1 and not (km >> lane) & 1:
                alive[g0 + lane] = False
        # (c) live candidates behind the group against the kept members
        for j in range(g0 + 32, n):
            for stripe in stripes(ls):
                if alive[j] and overlap_word(over, g0, j, km & stripe):
                    alive[j] = False
    return alive, worst


def model_rows(boxes, conf, thresh, ls):
    over = (iou_xywh_t(t(boxes)[:, :, None, :], t(boxes)[:, None, :, :])
            > torch.tensor(thresh, dtype=torch.float32)).numpy()
    keep = np.zeros(conf.shape, bool)
    worst = 0
    for r in range(conf.shape[0]):
        keep[r], rounds = grouped_nms_model(over[r], conf[r].copy(), ls)
        worst = max(worst, rounds)
    return keep, worst


def make_rows(rng, r, k, n_valid):
    centres = rng.uniform(0.2, 0.8, (r, 5, 2))
    which = rng.integers(0, 5, (r, k))
    boxes = np.empty((r, k, 4), np.float32)
    boxes[..., :2] = np.take_along_axis(centres, which[..., None].repeat(2, -1), 1) \
        + rng.normal(0, 0.03, (r, k, 2))
    boxes[..., 2:] = rng.uniform(0.1, 0.4, (r, k, 2))
    conf = -np.sort(-rng.uniform(0.01, 1.0, (r, k)).astype(np.float32), axis=1)
    for i, n in enumerate(n_valid):
        conf[i, n:] = 0.0
    return boxes, conf


CASES = {
    # K, live candidates per row
    "one_group": (32, [32, 31, 1, 0]),
    "ends_inside_a_group": (96, [33, 45, 64, 65, 95]),
    "k_not_a_multiple_of_32": (77, [77, 50, 0, 76]),
    "several_groups": (160, [160, 129, 128]),
    "k_845": (845, [845, 300]),
}


# the long rows at the kernel's own thread counts only (one or two a candidate)
CASES_LS = [(case, ls) for case in sorted(CASES) for ls in (0, 1, 2, 5)
            if case != "k_845" or ls in (0, 1)]


@pytest.mark.parametrize("case,ls", CASES_LS, ids=[f"{c}-ls{ls}" for c, ls in CASES_LS])
def test_grouped_model_matches_reference(case, ls):
    k, n_valid = CASES[case]
    boxes, conf = make_rows(np.random.default_rng(sorted(CASES).index(case)), len(n_valid), k, n_valid)
    want = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    got, rounds = model_rows(boxes, conf, THRESH, ls)
    np.testing.assert_array_equal(got, want)
    assert rounds <= 32
    if case != "one_group":
        assert 0 < want.sum() < (conf > 0).sum(), "nothing suppressed: vacuous case"


def test_grouped_model_identical_boxes_and_ties():
    """All boxes equal: only the first survives, in one round per group. Tied
    scores: the earlier slot wins."""
    rng = np.random.default_rng(20)
    boxes, conf = make_rows(rng, 3, 70, [70, 70, 40])
    boxes[0] = boxes[0, :1]
    boxes[2] = boxes[2, :1]
    conf[1] = np.float32(0.5)
    want = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    got, _ = model_rows(boxes, conf, THRESH, 1)
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [True] + [False] * 69
    assert got[2].sum() == 1


def test_grouped_model_chain_inside_a_group_takes_many_rounds():
    """Boxes in a row, each overlapping only its neighbours: member i is kept
    iff member i-1 is dropped, so a group settles one member per round or
    two, and the model still agrees."""
    k = 40
    boxes = np.zeros((1, k, 4), np.float32)
    boxes[0, :, 0] = 0.1 + 0.01 * np.arange(k)  # 60% overlap with the neighbour
    boxes[0, :, 1] = 0.5
    boxes[0, :, 2] = 0.04
    boxes[0, :, 3] = 0.2
    conf = np.linspace(0.9, 0.1, k).astype(np.float32)[None]
    want = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    got, rounds = model_rows(boxes, conf, THRESH, 1)
    np.testing.assert_array_equal(got, want)
    assert rounds >= 8, "the chain did not show"


def test_live_candidate_after_a_masked_slot():
    """A slot with confidence 0 in the middle of a row neither suppresses nor
    is kept, and the row's end is the last live slot."""
    boxes, conf = make_rows(np.random.default_rng(21), 2, 70, [70, 70])
    conf[0, 10] = 0.0
    conf[0, 33:66] = 0.0
    conf[1, :32] = 0.0  # a whole group without a live member
    want = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    got, _ = model_rows(boxes, conf, THRESH, 1)
    np.testing.assert_array_equal(got, want)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), k=st.integers(1, 100), ls=st.sampled_from([0, 1, 3]),
       spread=st.sampled_from([0.0, 0.01, 0.05, 0.3]), tie=st.booleans())
def test_grouped_model_matches_reference_hypothesis(seed, k, ls, spread, tie):
    rng = np.random.default_rng(seed)
    r = 3
    boxes = np.empty((r, k, 4), np.float32)
    boxes[..., :2] = 0.5 + rng.normal(0, spread, (r, k, 2))
    boxes[..., 2:] = rng.uniform(0.1, 0.4, (r, 1, 2)) * (1 + rng.normal(0, spread, (r, k, 2)))
    conf = -np.sort(-rng.uniform(0.01, 1.0, (r, k)).astype(np.float32), axis=1)
    if tie:
        conf[:] = np.float32(0.5)
    for i in range(r):
        conf[i, int(rng.integers(0, k + 1)):] = 0.0
    want = nms_rows_reference(t(boxes), t(conf), THRESH).numpy()
    got, _ = model_rows(boxes, conf, THRESH, ls)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ls", range(6))
def test_stripes_split_the_members_once(ls):
    """Every member bit belongs to exactly one of the threads that share a
    candidate."""
    parts = stripes(ls)
    assert len(parts) == 1 << ls
    total = 0
    for p in parts:
        assert total & p == 0
        total |= p
    assert total == 0xFFFFFFFF


def test_kernel_source_has_no_tuning_argument():
    """Threads a candidate and block size follow from K inside `fsd_nms_rows`;
    the library exports that one function."""
    import re

    from fewshot_detection_tpu_torch.ops import _build

    with open(_build.source_path("nms")) as f:
        src = f.read()
    assert re.findall(r'extern "C" int (\w+)', src) == ["fsd_nms_rows"]
    assert "constexpr int PAIRED_THREADS = 512;" in src
    assert stripe_of(0) == 0xFFFFFFFF and stripe_of(1) == 0x55555555


def test_max_k_fits_shared_memory_and_a_whole_grid():
    """K * (32 + 4 + 4) bytes a row (csrc/nms.cu:row_smem) within one block's
    227 KB, and every anchor of a 13x13 grid as one row."""
    assert MAX_K * 40 <= 232448
    assert MAX_K >= 845
