"""The frozen arithmetic: FLOPs from the cfg against the program's own
count, and the device-interval union behind the idle share."""

import os
import sys

import pytest

from benchmark.common.cfgparse import parse, walk
from benchmark.common.flops import bn_layers, bn_sums_bytes, meta_step_flops, net_flops
from benchmark.common.trace import Trace, WINDOW, gaps_us, union_us
from conftest import REPO

CFG = os.path.join(REPO, "benchmark", "configs", "cfg")


def nets():
    return (walk(parse(os.path.join(CFG, "darknet_dynamic.cfg"))),
            walk(parse(os.path.join(CFG, "reweighting_net.cfg"))),
            walk(parse(os.path.join(CFG, "yolo-voc.cfg"))))


def test_meta_step_flops_equal_the_programs_spec_count_at_batch_384():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import roofline_b384_torch as roof
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models.meta import MetaSpec
    from fewshot_detection_tpu_torch.models.spec import build_spec

    dark, learn, _ = nets()
    spec = MetaSpec(build_spec(parse_cfg(os.path.join(CFG, "darknet_dynamic.cfg"))),
                    build_spec(parse_cfg(os.path.join(CFG, "reweighting_net.cfg"))))
    ours = meta_step_flops(dark, learn, 384, 15)
    assert ours == roof.spec_flops(spec, 384, 15, 416)
    assert round(ours / 384 / 1e9, 1) == 89.2
    assert meta_step_flops(dark, learn, 64, 15) == roof.spec_flops(spec, 64, 15, 416)


def test_plain_step_flops_equal_the_programs_spec_count():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import roofline_b384_torch as roof
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models.spec import build_spec

    *_, plain = nets()
    spec = build_spec(parse_cfg(os.path.join(CFG, "yolo-voc.cfg")))
    assert net_flops(plain, 64) == roof._net_flops(spec, 64, 416, 20)


def test_forward_flops_are_a_third_of_a_step_but_the_first_conv():
    dark, _, plain = nets()
    fwd = net_flops(plain, 1, train=False)
    first = 2 * 416 * 416 * 3 * 32 * 9
    assert net_flops(plain, 1) == 3 * fwd - first
    # the 20-way fused head: (H*W, 1024) x (1024, 20 * 30)
    assert net_flops(dark, 1, 20, train=False) - net_flops(dark, 1, 1, train=False) == \
        2 * 13 * 13 * 1024 * 19 * 30


def test_bn_shapes_and_bytes():
    dark, learn, plain = nets()
    assert len(bn_layers(dark, 64)) + len(bn_layers(learn, 15)) == 29
    assert len(bn_layers(plain, 64)) == 22
    assert bn_layers(dark, 64)[0] == (64 * 416 * 416, 32)
    (m, c), = bn_layers(dark, 64)[:1]
    assert bn_sums_bytes([(m, c)], 2) == 3 * m * c * 2 + 4 * c * 4


def test_union_counts_overlap_once_and_clips_to_the_window():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 60)]
    assert union_us(iv, 0, 50) == 15 + 10 + 10
    assert gaps_us(iv, 0, 50) == [(15, 20), (30, 40)]
    assert union_us([], 0, 10) == 0


def test_idle_share_and_breakdown_of_a_synthetic_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void bn_sums_vec_kernel<8>(float*)", "ts": 100, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm", "ts": 110, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 150, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 300, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 139, "dur": 11},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 100, "dur": 100},
    ]
    t = Trace(ev, steps=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(50e-6)  # [100, 140) and [150, 160)
    assert t.idle_pct() == pytest.approx(50.0)
    assert t.kernel_s("bn_sums") == pytest.approx(20e-6)
    assert t.kernel_s("convolution") == pytest.approx(30e-6)
    assert t.memcpy_s("HtoD") == pytest.approx(10e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["sm90_xmma_fprop_implicit_gemm", pytest.approx(30e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(10e-6)  # [140, 150)
    assert gaps["outer"] == pytest.approx(40e-6)  # [160, 200)


def test_device_only_trace_spans_from_the_warm_up_to_the_last_device_event():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel(long)", "ts": 0, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel(long)", "ts": 5, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm", "ts": 30, "dur": 40},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 80, "dur": 30},
    ]
    t = Trace(ev, steps=1)
    assert (t.lo, t.hi) == (10.0, 110.0)
    assert t.idle_pct() == pytest.approx(30.0)  # [10, 30) and [70, 80) of [10, 110)
    named = Trace(ev + [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 20,
                         "dur": 100},
                        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 20, "dur": 10}],
                  steps=1)
    t.named = named
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == {"aten::mul": pytest.approx(10e-6), "(no operator)": pytest.approx(20e-6)}
