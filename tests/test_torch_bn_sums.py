"""`bn_sums` and `batchnorm_train` of the PyTorch port against the JAX package,
on the CPU.

On a CPU tensor the port's wrapper runs its plain version, which is what the
CUDA kernels are held against on the card (`chip_smoke.py`). Here the plain
version is held against the JAX package's `_sums_reference` AND against its
Pallas kernel in interpret mode, at that kernel's test shapes. Both sides
accumulate in float32 but add in another order: rtol 1e-5 / atol 1e-4 on
sums of a few thousand O(1) values, the JAX package's own tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.ops import layers as jl
from fewshot_detection_tpu.ops.bn_pallas import _bn_sums_impl, _sums_reference
from fewshot_detection_tpu.ops.bn_pallas import bn_sums as j_bn_sums
from fewshot_detection_tpu_torch.ops import layers as tl
from fewshot_detection_tpu_torch.ops import bn_sums as bn_mod
from fewshot_detection_tpu_torch.ops.bn_sums import (
    bn_sums,
    bn_sums_backward_reference,
    bn_sums_reference,
    row_blocks,
    vector_width,
)

from torch_port_util import t

SHAPES = [
    (2, 8, 8, 32),
    (2, 16, 16, 3),
    (4, 4, 4, 256),
    (2, 8, 8, 96),
    (3, 13, 13, 1024),
    (1, 8, 8, 4, 16),
    (7, 30),  # odd M, C = 30: no counterpart of the TPU kernel's fallback
]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_bn_sums_matches_jax_reference_and_pallas_interpret(shape):
    x = _x(shape, len(shape) + shape[-1])
    s, q = bn_sums(t(x))
    assert s.dtype == q.dtype == torch.float32 and tuple(s.shape) == (shape[-1],)
    sr, qr = _sums_reference(jnp.asarray(x).reshape(-1, shape[-1]))
    sp, qp = _bn_sums_impl(jnp.asarray(x), interpret=True)
    for got, want in ((s, sr), (q, qr), (s, sp), (q, qp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_bn_sums_bfloat16_accumulates_in_float32():
    """The case of the JAX package's own bf16 test: the input is rounded to
    bfloat16 once, then both sides sum those values in float32."""
    x32 = _x((4, 16, 16, 32), 2)
    xj = jnp.asarray(x32, jnp.bfloat16)
    xt = t(x32).to(torch.bfloat16)
    np.testing.assert_array_equal(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)))
    s, q = bn_sums(xt)
    assert s.dtype == q.dtype == torch.float32
    sr, qr = j_bn_sums(xj)
    sp, qp = _bn_sums_impl(xj, interpret=True)
    # rtol 1e-5: a bfloat16 accumulator would be off by about 1e-2
    for got, want in ((s, sr), (q, qr), (s, sp), (q, qp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_sums_gradient_matches_jax_grad(dtype):
    """d/dx of a scalar function of (sum, sumsq) against jax.grad through the
    JAX package's custom VJP. The backward is elementwise, dsum + 2*x*dsq
    rounded once to x's dtype: float32 agrees to 1e-5 (dsq carries the
    sums' own rounding), bfloat16 to one rounding step (2^-8 relative)."""
    x32 = _x((2, 4, 4, 8), 3)
    a = np.linspace(-1, 1, 8).astype(np.float32)
    b = np.linspace(0.5, 2, 8).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    def loss(x):
        s, q = j_bn_sums(x)
        return jnp.sum(s * a + 1e-2 * jnp.square(q) * b)

    want = jax.grad(loss)(jnp.asarray(x32, jdt))
    xt = t(x32).to(tdt).requires_grad_(True)
    s, q = bn_sums(xt)
    (got,) = torch.autograd.grad(torch.sum(s * t(a) + 1e-2 * torch.square(q) * t(b)), xt)
    assert got.dtype == tdt and got.shape == xt.shape
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_bn_sums_none_gradients_count_as_zeros():
    x = t(_x((3, 5, 8), 4)).requires_grad_(True)
    s, q = bn_sums(x)
    (g_s,) = torch.autograd.grad(s.sum(), x, retain_graph=True)  # sumsq unused
    np.testing.assert_array_equal(g_s.numpy(), np.ones((3, 5, 8), np.float32))
    (g_q,) = torch.autograd.grad(q.sum(), x)  # sum unused
    np.testing.assert_allclose(g_q.numpy(), 2 * x.detach().numpy(), rtol=1e-6)
    xd = x.detach()
    np.testing.assert_array_equal(
        bn_sums_backward_reference(xd, None, None).numpy(), np.zeros((3, 5, 8), np.float32))


def test_bn_sums_counts_layout_copies_and_launches_nothing_on_cpu():
    x = t(_x((6, 16), 5))
    before = (bn_sums.launches, bn_sums.backward_launches, bn_sums.layout_copies)
    bn_sums(x)
    assert (bn_sums.launches, bn_sums.backward_launches, bn_sums.layout_copies) == before
    view = x[:, ::2]
    assert not view.is_contiguous()
    s, q = bn_sums(view)
    assert bn_sums.layout_copies == before[2] + 1
    assert bn_sums.launches == before[0]  # a CPU tensor never launches
    sr, qr = bn_sums_reference(view.contiguous())
    np.testing.assert_array_equal(s.numpy(), sr.numpy())
    np.testing.assert_array_equal(q.numpy(), qr.numpy())
    with pytest.raises(TypeError):
        bn_sums(x.double())


@pytest.mark.parametrize("m,c,want", [
    (64 * 416 * 416, 32, 1056),  # tall and narrow: as many blocks as the card holds
    (64 * 13 * 13, 1024, 33),    # 32 channel tiles x 33 row blocks
    (1, 1, 1),
    (7, 1280, 1),
    (100, 3, 2),                 # C=3: a warp takes 10 rows, a block 80
])
def test_row_blocks_fill_the_card_once(m, c, want):
    assert row_blocks(m, c) == want


@pytest.mark.parametrize("m,c,vec,want", [
    # the vector forward: a warp is 8 lanes x 4 rows (or more rows when a row
    # has fewer than 8 vectors), a pass of a block 4 loads a thread, and
    # 132 x 4 blocks fill the card
    (64 * 416 * 416, 32, 4, 528),  # float32: 8 vectors a row, one channel tile
    (64 * 416 * 416, 32, 8, 528),  # bfloat16: 4 vectors a row, 8 rows a warp
    (64 * 13 * 13, 1024, 4, 17),   # 32 channel tiles x 17 row blocks
    (64 * 13 * 13, 1024, 8, 33),   # 16 channel tiles x 33 row blocks
    (15 * 6 * 6, 1024, 8, 5),      # 540 rows, 128 a pass
    (64 * 52 * 52, 256, 8, 132),   # 4 channel tiles
    (7, 1280, 4, 1),
    (1, 8, 8, 1),
    (50000, 48, 4, 264),           # 12 vectors a row: 2 tiles, the second half full
    (777, 24, 8, 3),               # 3 vectors a row: 10 rows a warp, 2 lanes idle
])
def test_row_blocks_of_the_vector_forward(m, c, vec, want):
    assert row_blocks(m, c, vec) == want


@pytest.mark.parametrize("m,c,vec,want", [
    (64 * 416 * 416, 32, 8, 528),    # the batch-64 step's top: one wave, 82 passes
    (64 * 416 * 416, 32, 4, 528),    # float32: 164 passes, still one wave
    (13_844_480, 32, 4, 528),        # COCO's top: 205 passes
    (384 * 416 * 416, 32, 8, 1014),  # the bench step's top: 256 passes, not 492
    (384 * 416 * 416, 32, 4, 2028),
    (384 * 416 * 416, 32, 1, 4056),  # the scalar forward: 2048 passes, 4 accumulators
    (100, 3, 1, 2),
])
def test_forward_row_blocks_keep_every_float32_chain_short(m, c, vec, want):
    """The forward's grid: the card filled once, and more blocks where a
    wave would give one float32 accumulator more than _MAX_CHAIN values."""
    g = row_blocks(m, c, vec, forward=True)
    assert g == want and g >= row_blocks(m, c, vec)
    cw = min(c // vec, 32 if vec == 1 else bn_mod._VEC_LANES)
    rows = 8 * (32 // cw) * (1 if vec == 1 else 4)
    passes = -(-(-(-m // rows)) // g)  # a block's passes
    chain = -(-passes // 4) if vec == 1 else 2 * passes
    assert chain <= bn_mod._MAX_CHAIN
    if g > row_blocks(m, c, vec):  # no more blocks than the bound needs
        assert 2 * -(-(-(-m // rows)) // (g - 1)) > bn_mod._MAX_CHAIN or vec == 1
    n_floats = 2 * g * c
    assert n_floats <= bn_mod._WORKSPACE_FLOATS or vec == 1


@pytest.mark.parametrize("c,itemsize,address,want", [
    (32, 4, 0, 4), (32, 2, 0, 8), (1024, 2, 512, 8),
    (30, 4, 0, 1), (36, 2, 0, 1), (36, 4, 0, 4), (3, 4, 0, 1),
    (64, 4, 4, 1), (64, 2, 2, 1), (64, 2, 16, 8),  # the base's alignment decides too
])
def test_vector_width_follows_shape_and_alignment(c, itemsize, address, want):
    assert vector_width(c, itemsize, address) == want


def _vector_reads(m, c, vec, g, lanes):
    """Mirror of csrc/bn_sums.cu:bn_sums_vec_kernel's lane geometry: how
    often every (row, 16-byte vector) of an (m, c) activation is read by a
    grid of (channel tiles, g) blocks of 256 threads. Returns an (m, c // vec)
    array of counts."""
    cv = c // vec
    cw = min(cv, lanes)
    fold = 32 // cw
    tiles = -(-cv // cw)
    tid = np.arange(256)
    lane, warp = tid & 31, tid >> 5
    sub = lane // cw
    rows_u = 8 * fold
    rows_pass = 4 * rows_u
    r_in = warp * fold + sub
    reads = []
    for bx in range(tiles):
        v = bx * cw + (lane - sub * cw)
        active = (sub < fold) & (v < cv)
        # first rows of every pass of every block along the rows, at once
        r0 = np.arange(0, m, rows_pass)  # pass p belongs to block p % g
        assert len({int(p) % g for p in range(len(r0))}) == min(g, len(r0))
        rows = r0[:, None, None] + r_in[None, :, None] + (np.arange(4) * rows_u)[None, None, :]
        ok = active[None, :, None] & (rows < m)
        flat = rows * cv + v[None, :, None]
        reads.append(flat[ok])
    return np.bincount(np.concatenate(reads), minlength=m * cv).reshape(m, cv)


@pytest.mark.parametrize("m,c,itemsize", [
    (4 * 416 * 416, 32, 4),   # the top shape cut to 4 images: the same 528 row
    (4 * 416 * 416, 32, 2),   # blocks and tile, a sixteenth of the passes
    (64 * 13 * 13, 1024, 4), (64 * 13 * 13, 1024, 2),
    (15 * 6 * 6, 1024, 4), (15 * 6 * 6, 1024, 2),
    (64 * 52 * 52, 256, 2),
    (7, 1280, 4), (50000, 48, 4), (50000, 48, 2), (777, 24, 4), (777, 24, 2), (3, 36, 4),
    (1, 8, 2), (129, 64, 2), (128, 64, 2), (127, 64, 2),  # around one pass of a block
])
def test_vector_geometry_reads_every_value_once(m, c, itemsize):
    vec = vector_width(c, itemsize)
    assert vec == 16 // itemsize
    g = row_blocks(m, c, vec)
    counts = _vector_reads(m, c, vec, g, bn_mod._VEC_LANES)
    assert counts.shape == (m, c // vec)
    assert counts.min() == 1 and counts.max() == 1
    # the grid: no more row blocks than passes to hand out, tickets for every tile
    assert 1 <= g <= -(-m // (4 * 8 * (32 // min(c // vec, bn_mod._VEC_LANES))))
    assert bn_mod._TICKET_SLOTS >= -(-c // 32) or c > 2048


def test_wrapper_and_source_agree_on_the_geometry():
    """The tile width, the block and the loads a pass are constants of
    csrc/bn_sums.cu; `row_blocks` mirrors them. The forward's interface takes
    no geometry but the row blocks."""
    import re

    from fewshot_detection_tpu_torch.ops import _build

    with open(_build.source_path("bn_sums")) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["TX"], consts["TY"], consts["LANES"]) == (bn_mod._TX, bn_mod._TY, bn_mod._VEC_LANES)
    assert "__launch_bounds__(THREADS, 4)" in src and bn_mod._VECTOR_RESIDENT == 132 * 4
    (args,) = re.findall(r'extern "C" int fsd_bn_sums_fwd\(([^)]*)\)', src)
    names = [a.split()[-1].lstrip("*") for a in args.split(",")]
    assert names == ["x", "workspace", "ticket_slots", "out", "M", "C", "G", "is_bf16", "stream", "path"]


@pytest.mark.parametrize("c,itemsize", [(32, 4), (32, 2), (1024, 4), (1024, 2), (2048, 4), (48, 4),
                                        (24, 2), (30, 4), (3, 4), (1280, 2)])
def test_ticket_slots_cover_every_channel_tile(c, itemsize):
    """The library refuses a workspace with fewer tickets than channel tiles;
    the wrapper's count (a multiple of 4, at least ceil(C / 32)) covers both
    paths' tiles."""
    _, slots = bn_mod._workspace(torch.device("cpu"), -1, c, 16)
    bn_mod._workspaces.pop((None, -1))
    vec = vector_width(c, itemsize)
    cv = c // vec
    tiles = -(-cv // min(cv, bn_mod._VEC_LANES)) if vec > 1 else -(-c // bn_mod._TX)
    assert slots % 4 == 0 and slots >= tiles


def test_workspace_is_reused_per_stream_and_grows_on_demand():
    """The table of partials and the tickets: one zeroed buffer a (device,
    stream), handed out again while it is large enough, replaced by a larger
    zeroed one when a call needs more, and never shared between streams."""
    dev = torch.device("cpu")
    saved = dict(bn_mod._workspaces)
    bn_mod._workspaces.clear()
    try:
        ws, slots = bn_mod._workspace(dev, 7, 1024, 2 * 33 * 1024)
        assert ws.dtype == torch.int32 and not ws.any()
        assert slots % 4 == 0 and slots >= 1024 // 32
        assert ws.numel() >= slots + 2 * 33 * 1024
        again, _ = bn_mod._workspace(dev, 7, 32, 2 * 528 * 32)
        assert again is ws  # the main shapes all fit the first one
        other, _ = bn_mod._workspace(dev, 8, 32, 2 * 528 * 32)
        assert other is not ws  # a second stream has its own
        big, big_slots = bn_mod._workspace(dev, 7, 4096, 1 << 20)
        assert big is not ws and big_slots >= 128 and big.numel() >= big_slots + (1 << 20)
        assert not big.any()
        assert bn_mod._workspace(dev, 7, 32, 10)[0] is big
        # every main shape's table fits the default size, so training never regrows
        for m, c in [(64 * 416 * 416, 32), (64 * 208 * 208, 64), (64 * 52 * 52, 256),
                     (64 * 13 * 13, 1024), (15 * 6 * 6, 1024)]:
            for itemsize in (4, 2):
                g = row_blocks(m, c, vector_width(c, itemsize))
                assert 2 * g * c <= bn_mod._WORKSPACE_FLOATS
    finally:
        bn_mod._workspaces.clear()
        bn_mod._workspaces.update(saved)


def _bn(rng, c):
    return {
        "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "beta": rng.uniform(-0.3, 0.3, c).astype(np.float32),
        "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
    }


@pytest.mark.parametrize("darknet_mode", [False, True], ids=["torch_mode", "darknet_mode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(monkeypatch, darknet_mode, dtype):
    """y, the new running statistics and the gradients to x, gamma and beta,
    in both running-statistics modes. float32: 1e-5. bfloat16: x is rounded
    once on both sides, the statistics stay float32 (1e-5), y and dx are
    bfloat16 values (two rounding steps, 2^-7 relative; the sum over dy of
    one channel's dx terms cancels, so dx gets an absolute floor); the
    tolerance of dgamma and dbeta is stated where they are compared."""
    if darknet_mode:
        monkeypatch.setenv("FSD_BN_DARKNET", "1")
    else:
        monkeypatch.delenv("FSD_BN_DARKNET", raising=False)
    assert tl.bn_train_config() == jl.bn_train_config()
    rng = np.random.RandomState(6)
    c = 16
    x32 = (rng.randn(2, 5, 5, c) * 1.5 + 0.3).astype(np.float32)
    w = rng.randn(2, 5, 5, c).astype(np.float32)
    bn = _bn(rng, c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x, gamma, beta):
        y, stats = jl.batchnorm_train(x, {**{k: jnp.asarray(v) for k, v in bn.items()},
                                          "gamma": gamma, "beta": beta})
        return jnp.sum(y.astype(jnp.float32) * w), (y, stats)

    (_, (jy, jstats)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x32, jdt), jnp.asarray(bn["gamma"]), jnp.asarray(bn["beta"]))

    xt = t(x32).to(tdt).requires_grad_(True)
    tbn = {k: t(v) for k, v in bn.items()}
    tbn["gamma"].requires_grad_(True)
    tbn["beta"].requires_grad_(True)
    y, stats = tl.batchnorm_train(xt, tbn)
    assert y.dtype == tdt and not stats["mean"].requires_grad
    grads = torch.autograd.grad(torch.sum(y.float() * t(w)), (xt, tbn["gamma"], tbn["beta"]))

    f32 = dict(rtol=1e-5, atol=1e-5)
    low = f32 if dtype == "float32" else dict(rtol=2.0 ** -7, atol=2.0 ** -7)
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)), **low)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), **f32)
    np.testing.assert_allclose(
        grads[0].float().numpy(), np.asarray(jgrads[0].astype(jnp.float32)),
        **(f32 if dtype == "float32" else dict(rtol=2.0 ** -6, atol=2.0 ** -5)))
    for got, want in zip(grads[1:], jgrads[1:]):
        assert got.dtype == torch.float32
        want = np.asarray(want)
        # bfloat16: the gradient reaches gamma and beta through the cast of
        # inv/bias, as a bfloat16 sum over the batch whose terms cancel; the
        # frameworks round it at the magnitude of its largest channel
        tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
               else dict(rtol=2.0 ** -6, atol=2.0 ** -6 * np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, **tol)
