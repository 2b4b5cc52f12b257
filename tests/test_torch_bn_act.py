"""`bn_act`, training BatchNorm's normalise + activation epilogue.

On the CPU: the function's plain route against autograd of the composition
it replaced (`layers.bn_normalize` then `layers._activate`), bit for bit,
forward and the three gradients; `bn_train_activate` against the layer it
replaced, bit for bit; the kernels' names classed as elementwise by the
benchmark's frozen `kinds`. On the card (marker `card`; this file imports no
JAX: `python -m pytest tests/test_torch_bn_act.py -m card --noconftest`):
the kernels against the plain versions at every (M, C) of the benchmark's
three cells and on the scalar path, repeat launches and a second stream, one
launch each way under the profiler.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.common.cfgparse import parse, walk  # noqa: E402
from benchmark.common.flops import bn_layers  # noqa: E402
from benchmark.common.kinds import kernel_base_name, kind_of  # noqa: E402
from fewshot_detection_tpu_torch.ops import bn_act as ba  # noqa: E402
from fewshot_detection_tpu_torch.ops import layers  # noqa: E402
from fewshot_detection_tpu_torch.ops.bn_act import (  # noqa: E402
    bn_act,
    bn_act_backward_reference,
    bn_act_reference,
)

ACTIVATIONS = ("leaky", "relu", "linear")
DTYPES = (torch.float32, torch.bfloat16)
# (..., C): a 4-D NHWC conv output, the s2d stem's 5-D (B, H/2, W/2, 4, K),
# a C that is no multiple of 8, and a 2-D (M, C)
SHAPES = ((2, 5, 6, 16), (2, 3, 4, 4, 8), (3, 5, 7, 12), (40, 24))


def _inputs(shape, dtype, seed, device="cpu"):
    """A conv-output-like y, the float32 pair (leaves), and an upstream
    gradient; one channel has y = 0 and bias = 0 on some rows, so z hits 0."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    y = rng.normal(size=shape) * np.linspace(0.5, 2.0, c) + np.linspace(-1.0, 1.0, c)
    y.reshape(-1, c)[::3, 0] = 0.0
    inv = rng.uniform(0.5, 1.5, c)
    bias = rng.normal(size=c)
    bias[0] = 0.0
    dout = rng.normal(size=shape)
    y, dout = (torch.tensor(a, dtype=torch.float32, device=device).to(dtype) for a in (y, dout))
    inv, bias = (torch.tensor(a, dtype=torch.float32, device=device) for a in (inv, bias))
    return y, inv, bias, dout


def _grads(fn, y, inv, bias, dout):
    y, inv, bias = (t.detach().clone().requires_grad_(True) for t in (y, inv, bias))
    out = fn(y, inv, bias)
    return (out.detach(), *torch.autograd.grad(out, (y, inv, bias), dout))


def _old_composition(activation):
    return lambda y, inv, bias: layers._activate(layers.bn_normalize(y, inv, bias), activation)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_cpu_route_is_autograd_of_the_old_composition_bit_for_bit(activation, dtype, shape):
    y, inv, bias, dout = _inputs(shape, dtype, seed=len(shape) * 7 + shape[-1])
    want = _grads(_old_composition(activation), y, inv, bias, dout)
    got = _grads(lambda a, b, c: bn_act(a, b, c, activation), y, inv, bias, dout)
    for name, g, w in zip(("out", "dy", "dinv", "dbias"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    # the written-out backward is what the function's backward runs on the CPU
    plain = bn_act_backward_reference(dout, y, inv, bias, activation)
    for name, g, w in zip(("dy", "dinv", "dbias"), plain, want[1:]):
        assert torch.equal(g, w), name


def _old_bn_train_activate(y, bn, activation):
    """The layer before `bn_act`: the pair from `bn_train_affine`, then the
    composition, differentiated by autograd."""
    inv, bias, new_stats = layers.bn_train_affine(y, bn)
    return _old_composition(activation)(y, inv, bias), new_stats


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_bn_train_activate_is_the_old_layer_bit_for_bit(dtype):
    """Out, the new running statistics and the gradients at y, gamma and
    beta (through `bn_sums` and `bn_act` both) are the old layer's bits."""
    rng = np.random.default_rng(3)
    y0 = torch.tensor(rng.normal(size=(2, 6, 6, 16)), dtype=torch.float32).to(dtype)
    dout = torch.tensor(rng.normal(size=(2, 6, 6, 16)), dtype=torch.float32).to(dtype)
    gamma = torch.tensor(rng.uniform(0.5, 1.5, 16), dtype=torch.float32)
    beta = torch.tensor(rng.normal(size=16), dtype=torch.float32)
    runs = []
    for fn in (layers.bn_train_activate, _old_bn_train_activate):
        y = y0.clone().requires_grad_(True)
        bn = {"gamma": gamma.clone().requires_grad_(True), "beta": beta.clone().requires_grad_(True),
              "mean": torch.zeros(16), "var": torch.ones(16)}
        out, stats = fn(y, bn, "leaky")
        grads = torch.autograd.grad(out, (y, bn["gamma"], bn["beta"]), dout)
        runs.append((out.detach(), *grads, stats["mean"], stats["var"]))
    for name, a, b in zip(("out", "dy", "dgamma", "dbeta", "mean", "var"), *runs):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_a_layout_copy_is_counted_and_changes_no_value():
    y, inv, bias, _ = _inputs((4, 6, 10), torch.float32, seed=1)
    view = y.transpose(0, 1)
    before = bn_act.layout_copies
    out = bn_act(view, inv, bias, "leaky")
    assert bn_act.layout_copies == before + 1
    assert torch.equal(out, bn_act_reference(view.contiguous(), inv, bias, "leaky"))
    assert bn_act.launches == 0 and bn_act.backward_launches == 0  # no kernel on the CPU


def test_the_function_refuses_what_the_kernels_do_not_take():
    y, inv, bias, _ = _inputs((4, 8), torch.float32, seed=2)
    with pytest.raises(TypeError):
        bn_act(y.half(), inv, bias, "leaky")
    with pytest.raises(ValueError):
        bn_act(y[:, :0], inv[:0], bias[:0], "leaky")
    with pytest.raises(ValueError):
        ba._pair(y, inv[:4], bias)
    with pytest.raises(ValueError):
        ba._pair(y, inv.double(), bias)
    with pytest.raises(ValueError):
        ba._pair(y.t(), inv, bias)


@pytest.mark.parametrize("m,c,itemsize", [(66_453_504, 32, 2), (11_075_584, 32, 2),
                                          (10_816, 1024, 2), (540, 1024, 2), (1_000_003, 30, 4),
                                          (173_056, 256, 4)])
def test_row_blocks_fill_the_card_and_keep_the_chains_short(m, c, itemsize):
    """Every path's grid: no block without rows, at least a wave of the card
    where there are rows for it, and on the backward no float32 chain over
    `_MAX_CHAIN` values (two a pass a vector chain, one in four rows a scalar
    one), in whole waves when the chains ask for more blocks."""
    for vec in {ba.vector_width(c, itemsize), 1}:
        cw = min(c // vec, 32 if vec == 1 else 8)
        tiles = -(-(c // vec) // cw)
        rows = 8 * (32 // cw) * (1 if vec == 1 else 4)
        for backward in (False, True):
            g = ba.row_blocks(m, c, vec, backward)
            assert 1 <= g <= min(65535, -(-m // rows))
            per_sm = 8 if vec == 1 else (2 if backward else 4)
            wave = max(1, 132 * per_sm // tiles)
            assert g >= min(wave, -(-m // rows))
            if backward:
                passes = -(-m // (rows * g))
                values = 2 * passes if vec > 1 else -(-passes // 4)
                assert values <= ba._MAX_CHAIN
                if g > wave:
                    assert g % wave == 0 or g == -(-m // rows)


def _kernel_names() -> list[str]:
    with open(os.path.join(REPO, "fewshot_detection_tpu_torch", "csrc", "bn_act.cu")) as f:
        src = f.read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", src)


KERNELS = ("bn_act_elementwise_fwd_kernel", "bn_act_elementwise_fwd_scalar_kernel",
           "bn_act_elementwise_bwd_kernel", "bn_act_elementwise_bwd_scalar_kernel")


def test_the_source_holds_these_kernels_and_no_other():
    assert sorted(_kernel_names()) == sorted(KERNELS)


@pytest.mark.parametrize("name", KERNELS)
def test_a_kernel_name_is_classed_elementwise(name):
    """As a device trace names it (demangled, its template arguments and
    parameters included) and as the breakdown shortens it."""
    for t, vec in (("__nv_bfloat16", "uint4"), ("float", "uint4"), ("float", "float")):
        for act in range(3):
            full = (f"void (anonymous namespace)::{name}<{t}, {act}>({vec} const*, float const*, "
                    f"float const*, {vec}*, float*, int*, float*, long long, int)")
            assert kind_of(full) == "elementwise", full
            assert kind_of(kernel_base_name(full)) == "elementwise", full


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# |sum - plain sum| may exceed one unit of y's type where the per-channel sum
# cancels: the two float32 orders then differ by up to this share of the sum
# of the terms' magnitudes (the bound the bn_sums kernels are held to)
SUM_TOL = 2e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def cell_shapes() -> list[tuple[int, int]]:
    """Distinct (M, C) of the training BN layers in the benchmark's three
    cells: yolov2 at batch 64; the meta backbone at 64 and 384 and its
    learnet on 15 supports."""
    cfg = os.path.join(REPO, "benchmark", "configs", "cfg")
    yolo = walk(parse(os.path.join(cfg, "yolo-voc.cfg")))
    dark = walk(parse(os.path.join(cfg, "darknet_dynamic.cfg")))
    learn = walk(parse(os.path.join(cfg, "reweighting_net.cfg")))
    shapes = bn_layers(yolo, 64) + bn_layers(dark, 64) + bn_layers(dark, 384) + bn_layers(learn, 15)
    return sorted(set(shapes))


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    e = torch.floor(torch.log2(x.abs().clamp(min=torch.finfo(dtype).tiny)))
    return torch.finfo(dtype).eps * torch.exp2(e)


def _check_kernels(y, inv, bias, dout, activation):
    """Kernel against plain version on the card: out and dy bit for bit, the
    pair's gradients within one unit of y's type (or SUM_TOL of the sum of
    the terms' magnitudes where the sum cancels). Returns the paths taken."""
    code = ba.activation_code(activation)
    out = ba._launch_forward(y, inv, bias, code)
    fwd_path = bn_act.last_path
    assert torch.equal(out, bn_act_reference(y, inv, bias, activation))
    del out
    dy, dinv, dbias = ba._launch_backward(dout, y, inv, bias, code)
    bwd_path = bn_act.last_backward_path
    want = bn_act_backward_reference(dout, y, inv, bias, activation)
    assert torch.equal(dy, want[0])
    del dy
    # the terms of the two sums, as the kernel adds them
    c = y.shape[-1]
    g = ba.grad_at_z(dout, y, inv, bias, activation)
    mags = ((g * y).float().abs().reshape(-1, c).sum(0), g.float().abs().reshape(-1, c).sum(0))
    del g
    for name, k, p, mag in (("dinv", dinv, want[1], mags[0]), ("dbias", dbias, want[2], mags[1])):
        room = torch.maximum(torch.maximum(_ulp(k, y.dtype), _ulp(p, y.dtype)), SUM_TOL * mag)
        assert bool(((k - p).abs() <= room).all()), (name, tuple(y.shape), float((k - p).abs().max()))
    return fwd_path, bwd_path


def _card_inputs(m, c, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn((m, c), generator=g, device="cuda")
    y = (y * torch.linspace(0.5, 2.0, c, device="cuda") + torch.linspace(-1, 1, c, device="cuda"))
    dout = torch.randn((m, c), generator=g, device="cuda")
    inv = torch.rand(c, generator=g, device="cuda") + 0.5
    bias = torch.randn(c, generator=g, device="cuda")
    return y.to(dtype), inv, bias, dout.to(dtype)


@pytest.mark.card
def test_kernels_hold_at_every_shape_of_the_cells(card):
    for i, (m, c) in enumerate(cell_shapes()):
        y, inv, bias, dout = _card_inputs(m, c, torch.bfloat16, 100 + i)
        assert _check_kernels(y, inv, bias, dout, "leaky") == ("vector", "vector")
        del y, dout
        torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_kernels_hold_on_both_paths_in_both_types(card, activation):
    for dtype in DTYPES:
        for m, c in ((50_000, 48), (777, 24), (10_816, 1024), (1_000_003, 30), (4099, 3), (7, 1280)):
            y, inv, bias, dout = _card_inputs(m, c, dtype, m + c)
            paths = _check_kernels(y, inv, bias, dout, activation)
            assert paths == (("vector",) * 2 if c % (16 // y.element_size()) == 0 else ("scalar",) * 2)
        # C a multiple of 16 / itemsize, the base one element past 16 bytes
        y, inv, bias, dout = _card_inputs(20_000 * 64 + 1, 1, dtype, 7)
        y, dout = y.reshape(-1)[1:].view(20_000, 64), dout.reshape(-1)[1:].view(20_000, 64)
        assert _check_kernels(y, inv[:1].expand(64).contiguous(), bias[:1].expand(64).contiguous(),
                              dout, activation) == ("scalar", "scalar")


@pytest.mark.card
def test_repeat_launches_and_a_second_stream_give_the_same_bits(card):
    side = torch.cuda.Stream()
    for m, c, dtype in ((2_000_000, 32, torch.bfloat16), (10_816, 1024, torch.bfloat16),
                        (100_003, 30, torch.float32)):
        y, inv, bias, dout = _card_inputs(m, c, dtype, 11)
        first = ba._launch_forward(y, inv, bias, 0), ba._launch_backward(dout, y, inv, bias, 0)
        runs = [(ba._launch_forward(y, inv, bias, 0), ba._launch_backward(dout, y, inv, bias, 0))
                for _ in range(8)]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            runs += [(ba._launch_forward(y, inv, bias, 0), ba._launch_backward(dout, y, inv, bias, 0))
                     for _ in range(8)]
        runs += [(ba._launch_forward(y, inv, bias, 0), ba._launch_backward(dout, y, inv, bias, 0))
                 for _ in range(8)]
        torch.cuda.synchronize()
        for out, (dy, dinv, dbias) in runs:
            assert torch.equal(out, first[0]) and torch.equal(dy, first[1][0])
            assert torch.equal(dinv, first[1][1]) and torch.equal(dbias, first[1][2])


@pytest.mark.card
def test_the_workspace_shared_with_bn_sums_keeps_both_kernels_bits(card):
    """The backward's table and tickets are `bn_sums`' workspace of the
    stream: the two libraries' launches interleaved, the table grown between
    them, give the bits each gives alone."""
    from fewshot_detection_tpu_torch.ops import bn_sums as bs

    assert ba._workspace is bs._workspace
    y, inv, bias, dout = _card_inputs(2_000_000, 32, torch.bfloat16, 13)
    x = _card_inputs(100_003, 1024, torch.float32, 14)[0]
    alone = ba._launch_backward(dout, y, inv, bias, 0)
    sums = bs._launch_forward(x)
    for _ in range(4):
        got = ba._launch_backward(dout, y, inv, bias, 0), bs._launch_forward(x)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got[0], alone))
        assert all(torch.equal(a, b) for a, b in zip(got[1], sums))


@pytest.mark.card
def test_one_launch_each_way_under_the_profiler(card):
    from torch.profiler import ProfilerActivity, profile

    from fewshot_detection_tpu_torch.utils.profiling import WARMUP_KERNEL, warm_up_cuda_trace

    y, inv, bias, dout = _card_inputs(64 * 13 * 13, 1024, torch.bfloat16, 5)
    y.requires_grad_(True)
    inv.requires_grad_(True)
    bias.requires_grad_(True)
    for way in ("forward", "backward"):
        for _ in range(3):  # a trace can come back without device events: take it again
            out = bn_act(y, inv, bias, "leaky") if way == "backward" else None
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                warm_up_cuda_trace()
                if way == "forward":
                    bn_act(y, inv, bias, "leaky")
                else:
                    torch.autograd.grad(out, (y, inv, bias), dout)
                torch.cuda.synchronize()
            names = [e.key for e in p.key_averages() if e.device_type.name == "CUDA"
                     and WARMUP_KERNEL not in e.key for _ in range(e.count)]
            if names:
                break
        mine = [n for n in names if "bn_act_elementwise" in n]
        assert len(mine) == 1 and ("_fwd" if way == "forward" else "_bwd") in mine[0], names
        assert all(kind_of(n) == "elementwise" for n in mine)
        if way == "forward":
            assert names == mine, names  # nothing else: no mask, where, mul or add


@pytest.mark.card
def test_a_bn_layer_runs_the_pair_and_no_pass_of_the_old_composition(card, tmp_path):
    """One training BN layer forward and backward at (64*104*104, 128)
    bfloat16, traced: the only kernels as long as a pass over the
    activation (a pass takes 53 us at the card's 3.35 TB/s; a per-channel
    kernel a few us) are the bn_sums and bn_act pairs and autograd's sum of
    y's two gradients. No mask, `where`, broadcast multiply or add."""
    import json
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from fewshot_detection_tpu_torch.utils.profiling import WARMUP_KERNEL, warm_up_cuda_trace

    c = 128
    y, _, _, dout = _card_inputs(64 * 104 * 104, c, torch.bfloat16, 3)
    y = y.view(64, 104, 104, c).requires_grad_(True)
    bn = {"gamma": torch.ones(c, device="cuda", requires_grad=True),
          "beta": torch.zeros(c, device="cuda", requires_grad=True),
          "mean": torch.zeros(c, device="cuda"), "var": torch.ones(c, device="cuda")}

    def step():
        out, _ = layers.bn_train_activate(y, bn, "leaky")
        torch.autograd.grad(out, (y, bn["gamma"], bn["beta"]), dout.view_as(out))

    step()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace can come back without device events: take it again
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            warm_up_cuda_trace()
            step()
            torch.cuda.synchronize()
        path = str(tmp_path / "t.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [(e["name"], float(e["dur"])) for e in events
                   if e.get("cat") == "kernel" and WARMUP_KERNEL not in e["name"]]
        if kernels:
            break
    long = Counter(kernel_base_name(n) for n, d in kernels if d > 20)
    print({kernel_base_name(n): d for n, d in kernels})
    pair = {"bn_sums_vec_kernel", "bn_sums_bwd_kernel", "bn_act_elementwise_fwd_kernel",
            "bn_act_elementwise_bwd_kernel"}
    assert all(long[k] == 1 for k in pair), long
    rest = [k for k in long.elements() if k not in pair]
    assert len(rest) == 1 and kind_of(rest[0]) == "elementwise", long
