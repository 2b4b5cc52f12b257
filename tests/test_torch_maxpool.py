"""`maxpool2x2`, the 2x2 stride-2 max pool of NHWC tensors.

On the CPU: the plain version (what CPU tensors take) against `F.max_pool2d`
of the channels-last view, bit for bit, forward and gradient, in float32,
bfloat16 and float16, on random, tied, signed-zero and NaN windows, even and
odd sides; the window codes of hand-built windows; what the function saves;
the layer walk's routing of stride-2 and stride-1 pools; the kernels' names
classed as pooling by the benchmark's frozen `kinds`. On the card (marker
`card`; this file imports no JAX: `python -m pytest tests/test_torch_maxpool.py
-m card --noconftest`): the kernels against `F.max_pool2d` and the plain
version at every pool shape of the benchmark's cells and on both paths in
every type, an all -inf window (where PyTorch's CPU and CUDA kernels part),
no code without a gradient, one launch each way.
"""

import os
import re
import sys

import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.common.cfgparse import parse, walk  # noqa: E402
from benchmark.common.kinds import kernel_base_name, kind_of  # noqa: E402
from fewshot_detection_tpu_torch.ops import layers  # noqa: E402
from fewshot_detection_tpu_torch.ops import pool2x2 as mp  # noqa: E402
from fewshot_detection_tpu_torch.ops.pool2x2 import (  # noqa: E402
    maxpool2x2,
    maxpool2x2_backward_reference,
    maxpool2x2_reference,
)

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# (B, H, W, C): even sides, odd sides (the learnet's 13 -> 6 among them), C =
# 12 (no multiple of 8) and C = 32
SHAPES = ((2, 8, 12, 32), (2, 13, 13, 12), (1, 7, 10, 32), (3, 6, 9, 12))
KINDS = ("random", "ties", "zeros", "nan")
_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _dt(d):
    return str(d).split(".")[-1]


def library_pool(x: torch.Tensor) -> torch.Tensor:
    """`F.max_pool2d` of the channels-last view, as the port pooled before."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN where the other is NaN, the same bits everywhere else (so +0 and
    -0 differ, which `torch.equal` does not tell apart)."""
    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(a)
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(nan, torch.isnan(b)):
        return False
    a, b = a.view(_INT[a.dtype]), b.view(_INT[b.dtype])
    if nan.any():
        a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
    return torch.equal(a, b)


def make_input(shape, dtype, kind, seed, device="cpu"):
    """x (B, H, W, C) of one kind of window: normal values, values from a
    set of three (so most windows hold ties, whole windows constant), values
    from {+0, -0, 1} and normal values with NaNs (some windows two or more,
    some all NaN)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    if kind == "ties":
        x = torch.randint(0, 3, shape, generator=g).float()
        x[:, :2, :2] = 1.0
    elif kind == "zeros":
        x = torch.tensor([0.0, -0.0, 1.0])[torch.randint(0, 3, shape, generator=g)]
        x[:, :2, :2] = -0.0
        x[:, :2, 2:4] = 0.0
    elif kind == "nan":
        x[torch.rand(shape, generator=g) < 0.3] = float("nan")
        x[:, :2, :2] = float("nan")
    return x.to(dtype).to(device)


def upstream(shape, dtype, seed, device="cpu"):
    """A gradient for the pool's output, with some -0."""
    g = torch.Generator().manual_seed(seed)
    b, h, w, c = shape
    dy = torch.randn((b, h // 2, w // 2, c), generator=g)
    dy[torch.rand(dy.shape, generator=g) < 0.1] = -0.0
    return dy.to(dtype).to(device)


def pool_and_grad(fn, x, dy):
    x = x.detach().requires_grad_(True)  # the same memory: a misaligned view stays so
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, dy)
    return y, dx


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
def test_the_plain_version_is_max_pool2d_bit_for_bit(dtype, shape, kind):
    x = make_input(shape, dtype, kind, seed=sum(shape))
    dy = upstream(shape, dtype, seed=7)
    y, dx = pool_and_grad(maxpool2x2, x, dy)
    want_y, want_dx = pool_and_grad(library_pool, x, dy)
    assert y.is_contiguous() and dx.is_contiguous()
    assert same_bits(y, want_y)
    assert same_bits(dx, want_dx)
    assert not torch.signbit(dx[dx == 0]).any()  # dy's -0 comes out +0, as the CPU's
    # the walk's entry point takes the same route
    assert same_bits(layers.maxpool(x, 2, 2), want_y)


# (the window in scan order, the code, the value)
NAN, INF = float("nan"), float("inf")
WINDOWS = [
    ((1.0, 2.0, 3.0, 4.0), 3, 4.0),
    ((4.0, 3.0, 2.0, 1.0), 0, 4.0),
    ((1.0, 5.0, 5.0, 2.0), 1, 5.0),  # a tie goes to the first
    ((2.0, 2.0, 2.0, 2.0), 0, 2.0),
    ((0.0, -0.0, 0.0, -0.0), 0, 0.0),  # +0 is not greater than -0
    ((-0.0, 0.0, 0.0, 0.0), 0, -0.0),
    ((NAN, 1.0, NAN, 2.0), 2, NAN),  # the last NaN
    ((1.0, NAN, 2.0, 3.0), 1, NAN),
    ((-INF, -INF, -5.0, -INF), 2, -5.0),
    ((-INF, -INF, -INF, -INF), 0, -INF),  # the window's first (on the card: NONE)
    ((INF, INF, 3.0, NAN), 3, NAN),
]


@pytest.mark.parametrize("window,code,value", WINDOWS, ids=[str(w[0]) for w in WINDOWS])
def test_the_code_names_the_winning_position_of_a_hand_built_window(window, code, value):
    # one 2x2 window, row-major: (0, 0), (0, 1), (1, 0), (1, 1)
    x = torch.tensor(window).reshape(1, 2, 2, 1)
    y, got = maxpool2x2_reference(x)
    assert got.dtype == torch.uint8 and got.shape == (1, 1, 1, 1) and int(got) == code
    assert same_bits(y.reshape(1), torch.tensor([value]))
    dx = maxpool2x2_backward_reference(torch.full((1, 1, 1, 1), 3.0), got, 2, 2)
    assert dx.reshape(4).tolist() == [3.0 if k == code else 0.0 for k in range(4)]


@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
def test_odd_sides_drop_the_last_row_and_column_with_zero_gradient(dtype):
    x = make_input((2, 13, 13, 12), dtype, "random", seed=3)
    dy = torch.ones((2, 6, 6, 12), dtype=dtype)
    y, dx = pool_and_grad(maxpool2x2, x, dy)
    assert y.shape == (2, 6, 6, 12) and dx.shape == x.shape
    assert not dx[:, 12].any() and not dx[:, :, 12].any()
    # every window routes its one gradient, the dropped border nothing
    assert int(dx.float().sum()) == y.numel()
    assert same_bits(dx, pool_and_grad(library_pool, x, dy)[1])


def test_the_function_saves_the_code_alone_and_nothing_without_a_gradient():
    x = make_input((2, 8, 6, 32), torch.bfloat16, "random", seed=4).requires_grad_(True)
    y = maxpool2x2(x)
    saved = y.grad_fn.saved_tensors
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [(torch.uint8, (2, 4, 3, 32))]
    with torch.no_grad():
        assert maxpool2x2(x).grad_fn is None
    assert maxpool2x2(x.detach()).grad_fn is None
    assert maxpool2x2_reference(x.detach(), with_code=False)[1] is None


def test_a_view_that_is_not_row_major_is_copied_and_counted():
    x = make_input((2, 8, 8, 64), torch.float32, "random", seed=5)
    view = x[..., 16:48]
    copies = maxpool2x2.layout_copies
    assert same_bits(maxpool2x2(view), library_pool(view))
    assert maxpool2x2.layout_copies == copies + 1
    assert maxpool2x2.launches == 0  # the CPU takes the plain version


@pytest.mark.parametrize("size,stride", [(3, 2), (2, 1), (4, 4)])
def test_other_sizes_and_strides_keep_max_pool2d(size, stride):
    x = make_input((2, 9, 9, 12), torch.float32, "random", seed=6)
    want = F.max_pool2d(x.permute(0, 3, 1, 2), size, stride).permute(0, 2, 3, 1)
    assert same_bits(layers.maxpool(x, size, stride), want)


WALK_CFG = """[net]
batch=1
width=16
height=16
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[maxpool]
size=2
stride=1

[convolutional]
filters=12
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2
"""


def test_the_walk_sends_stride2_pools_to_maxpool2x2_and_stride1_to_maxpool_stride1(
        monkeypatch, tmp_path):
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models import darknet
    from fewshot_detection_tpu_torch.models.convert import from_jax_params, require_grads
    from fewshot_detection_tpu_torch.models.spec import build_spec

    path = tmp_path / "pools.cfg"
    path.write_text(WALK_CFG)
    spec = build_spec(parse_cfg(str(path)))
    calls = []

    def counted(name, fn):
        def run(x, *args):
            calls.append((name, tuple(x.shape)))
            return fn(x, *args)
        return run

    monkeypatch.setattr(layers, "maxpool2x2", counted("maxpool2x2", layers.maxpool2x2))
    monkeypatch.setattr(darknet, "maxpool_stride1",
                        counted("maxpool_stride1", darknet.maxpool_stride1))
    params = require_grads(from_jax_params(spec, darknet.init_params(spec, 0), "cpu"))
    x = torch.rand(2, 16, 16, 3)
    out, _ = darknet.apply_network(spec, params, x, train=True)
    assert calls == [("maxpool2x2", (2, 16, 16, 8)), ("maxpool_stride1", (2, 8, 8, 8)),
                     ("maxpool2x2", (2, 8, 8, 12))]
    assert out.shape == (2, 4, 4, 12)
    out.float().square().sum().backward()  # gradients reach the first conv through both pools
    assert params[0]["w"].grad is not None and params[0]["w"].grad.abs().sum() > 0


def _kernel_names() -> list[str]:
    with open(os.path.join(REPO, "fewshot_detection_tpu_torch", "csrc", "maxpool.cu")) as f:
        src = f.read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", src)


KERNELS = ("maxpool2x2_fwd_kernel", "maxpool2x2_fwd_scalar_kernel", "maxpool2x2_bwd_kernel",
           "maxpool2x2_bwd_scalar_kernel")


def test_the_source_holds_these_kernels_and_no_other():
    assert sorted(_kernel_names()) == sorted(KERNELS)


@pytest.mark.parametrize("name", KERNELS)
def test_a_kernel_name_is_classed_pooling(name):
    """As a device trace names it (demangled, its template argument and
    parameters included) and as the breakdown shortens it: pooling, which
    `epilogue_ms.train` counts, and not a kind checked before it."""
    for t in ("__nv_bfloat16", "__half", "float"):
        fwd = "unsigned char*" if "fwd" in name else "unsigned char const*"
        full = (f"void (anonymous namespace)::{name}<{t}>({t} const*, {fwd}, {t}*, "
                f"unsigned int, int, int, int, int, int)")
        assert kind_of(full) == "pooling", full
        assert kind_of(kernel_base_name(full)) == "pooling", full


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def cell_pool_shapes() -> list[tuple[int, int, int, int]]:
    """Distinct (B, H, W, C) of the 2x2 stride-2 pools in the benchmark's
    cells: the meta backbone at batch 64 and 384 (yolov2's at 64 is the
    same), its learnet on 15 supports; YOLOv3 has none."""
    cfg = os.path.join(REPO, "benchmark", "configs", "cfg")
    shapes = set()
    for name, batches in (("darknet_dynamic.cfg", (64, 384)), ("yolo-voc.cfg", (64,)),
                          ("reweighting_net.cfg", (15,)), ("yolov3.cfg", (64,))):
        blocks = parse(os.path.join(cfg, name))
        if not any(b["type"] == "maxpool" for b in blocks):
            continue
        for layer in walk(blocks):
            if layer.kind == "maxpool" and (layer.size, layer.stride) == (2, 2):
                shapes.update((b, layer.side_in, layer.side_in, layer.c_in) for b in batches)
    return sorted(shapes)


def check_on_card(x: torch.Tensor, dy: torch.Tensor) -> tuple[str, str]:
    """The kernels against `F.max_pool2d` and the plain version on the card:
    values and gradient bit for bit. Returns the paths taken."""
    y, dx = pool_and_grad(maxpool2x2, x, dy)
    paths = maxpool2x2.last_path, maxpool2x2.last_backward_path
    want_y, want_dx = pool_and_grad(library_pool, x, dy)
    assert same_bits(y, want_y), tuple(x.shape)
    assert same_bits(dx, want_dx), tuple(x.shape)
    del want_y, want_dx
    ref_y, code = maxpool2x2_reference(x)
    assert same_bits(y, ref_y)
    assert same_bits(dx, maxpool2x2_backward_reference(dy, code, x.shape[1], x.shape[2]))
    return paths


@pytest.mark.card
def test_kernels_equal_max_pool2d_at_every_pool_shape_of_the_cells(card):
    shapes = cell_pool_shapes()
    assert (384, 416, 416, 32) in shapes and (15, 13, 13, 1024) in shapes
    for i, shape in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(i)
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        b, h, w, c = shape
        dy = torch.randn((b, h // 2, w // 2, c), generator=g, device="cuda").to(torch.bfloat16)
        launches = maxpool2x2.launches, maxpool2x2.backward_launches
        assert check_on_card(x, dy) == ("vector", "vector")
        assert (maxpool2x2.launches, maxpool2x2.backward_launches) == (launches[0] + 1,
                                                                       launches[1] + 1)
        del x, dy
        torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
def test_kernels_hold_on_both_paths_in_every_type(card, dtype, kind):
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    for shape in SHAPES + ((4, 64, 64, 3), (2, 27, 31, 64), (1, 2, 2, 1)):
        x = make_input(shape, dtype, kind, seed=sum(shape), device="cuda")
        dy = upstream(shape, dtype, seed=9, device="cuda")
        want = ("vector",) * 2 if shape[-1] % vec == 0 else ("scalar",) * 2
        assert check_on_card(x, dy) == want, shape
    # C a multiple of the vector's lanes, the base one element past 16 bytes
    flat = make_input((1, 1, 1, 2 * 9 * 11 * 32 + 1), dtype, kind, seed=1, device="cuda")
    x = flat.reshape(-1)[1:].view(2, 9, 11, 32)
    assert check_on_card(x, upstream(x.shape, dtype, seed=2, device="cuda")) == ("scalar", "vector")


@pytest.mark.card
def test_an_all_minus_inf_window_routes_no_gradient_as_max_pool2d_on_the_card(card):
    """F.max_pool2d's NHWC kernel on the card keeps an index that lies in no
    window for a window whose values are all -inf, and its backward routes
    that window's gradient nowhere; the kernels do the same (code NONE).
    PyTorch's CPU kernel routes it to the window's first position."""
    x = torch.randn(1, 4, 4, 8, device="cuda")
    x[0, 2:4, 2:4, 3] = -float("inf")
    dy = torch.ones(1, 2, 2, 8, device="cuda")
    y, dx = pool_and_grad(maxpool2x2, x, dy)
    want_y, want_dx = pool_and_grad(library_pool, x, dy)
    assert same_bits(y, want_y) and same_bits(dx, want_dx)
    assert y[0, 1, 1, 3] == -float("inf") and not dx[0, 2:4, 2:4, 3].any()
    assert int(dx.sum()) == 31  # every other window routes its gradient
    assert int(mp._launch_forward(x.contiguous(), True)[1][0, 1, 1, 3]) == mp.NONE
    assert int(maxpool2x2_reference(x)[1][0, 1, 1, 3]) == mp.NONE
    cpu = pool_and_grad(library_pool, x.cpu(), dy.cpu())[1]
    assert cpu[0, 2, 2, 3] == 1 and same_bits(pool_and_grad(maxpool2x2, x.cpu(), dy.cpu())[1], cpu)


@pytest.mark.card
def test_no_gradient_writes_no_code(card):
    x = torch.randn(8, 52, 52, 256, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = maxpool2x2(x)
    assert y.grad_fn is None
    # the output alone was allocated: no code
    assert torch.cuda.memory_allocated() - before == y.numel() * y.element_size()
    assert same_bits(y, library_pool(x))
    xg = x.clone().requires_grad_(True)
    yg = maxpool2x2(xg)
    assert [(t.dtype, tuple(t.shape)) for t in yg.grad_fn.saved_tensors] == [
        (torch.uint8, tuple(y.shape))]


@pytest.mark.card
def test_one_launch_each_way_under_the_profiler(card):
    from torch.profiler import ProfilerActivity, profile

    from fewshot_detection_tpu_torch.utils.profiling import WARMUP_KERNEL, warm_up_cuda_trace

    x = torch.randn(64, 104, 104, 128, device="cuda", dtype=torch.bfloat16).requires_grad_(True)
    dy = torch.randn(64, 52, 52, 128, device="cuda", dtype=torch.bfloat16)
    torch.autograd.grad(maxpool2x2(x), x, dy)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm_up_cuda_trace()
        y = maxpool2x2(x)
        torch.autograd.grad(y, x, dy)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages() if ev.device_type.name == "CUDA"
             and WARMUP_KERNEL not in ev.key for _ in range(ev.count)]
    print(names)
    pools = sorted(kernel_base_name(n) for n in names if "pool" in n.lower())
    assert pools == ["maxpool2x2_bwd_kernel", "maxpool2x2_fwd_kernel"], names
    assert all(kind_of(n) == "pooling" for n in names if "pool" in n.lower())
    assert not any("max_pool" in n for n in names)
