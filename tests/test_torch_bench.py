"""`bench_torch.py` and `scripts/roofline_b384_torch.py` against the JAX
package's `bench.py` and `scripts/roofline_b384.py`, on the CPU.

- The bench's batch is BIT-EQUAL to bench.py's: the JAX bench runs with a
  stand-in `MetaTrainer` whose `step` records what it is given, so JAX
  compiles nothing; the same trainer options are asked for.
- The last line has bench.py's keys, metric and `unit` format; the fallback
  chain is bench.py's (384, 128, 64, 16); an OOM at 384 runs 128, any other
  error propagates.
- A real step: `_run` at 64 px, batch 2, 2-way support, 1 + 1 steps.
- The roofline's FLOP count (FlopCounterMode over one whole step) equals the
  count from the spec EXACTLY at 64 and 96 px, and the spec's count at
  416 px gives the per-image and per-step FLOPs of an independent count
  (88,119,422,976 and 401,387,028,480). XLA's `cost_analysis()["flops"]`
  of the JAX step at 64 px, a count of another kind (it also counts
  elementwise work and lowers the convolutions' gradients its own way), is
  recorded beside it as a ratio.
- The roofline's line has the JAX script's keys (read from its source),
  with `mfu_pct` in place of `mxu_util_pct`; the byte count's rules; a card
  without a published peak is refused.

Each script is loaded with importlib and its module constants patched."""

import ast
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from torch_port_util import REPO


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def port_bench():
    return _load("bench_torch.py", "port_bench")


@pytest.fixture
def jax_bench():
    return _load("bench.py", "jax_bench")


@pytest.fixture
def roofline():
    return _load("scripts/roofline_b384_torch.py", "port_roofline")


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def test_bench_batch_is_bit_equal_to_bench_py(port_bench, jax_bench, monkeypatch):
    import fewshot_detection_tpu.train as jtrain

    calls = []

    class Recorder:
        def __init__(self, spec, **kw):
            calls.append(("init", kw))

        def step(self, p, m, batch, seen=0, lr=0.0):
            calls.append(("step", batch))
            return p, m, {"loss": 0.0}

    monkeypatch.setattr(jtrain, "MetaTrainer", Recorder)
    monkeypatch.chdir(REPO)
    for mod in (port_bench, jax_bench):
        for k, v in (("SIZE", 32), ("N_CLS", 3), ("WARMUP", 1), ("ITERS", 1)):
            monkeypatch.setattr(mod, k, v)
    assert jax_bench._run(5) > 0
    (_, kw), (_, want) = calls[0], calls[1]
    assert kw == {"momentum": 0.9, "weight_decay": 0.0005, "donate": True, "remat": True}
    got = port_bench.make_batch(5, torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for k in ("x", "metax", "mask"):
        assert got[k].dtype == torch.bfloat16 and str(want[k].dtype) == "bfloat16"
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(_bf16_bits(got[k]), _bf16_bits(want[k]), err_msg=k)
    for k in ("target", "keep"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert float(got["mask"].float().mean()) not in (0.0, 1.0)


def test_bench_last_line_has_bench_py_keys_and_unit(port_bench, jax_bench, monkeypatch):
    monkeypatch.setattr(port_bench, "_run", lambda b, dev: 123.456)
    monkeypatch.setattr(jax_bench, "_run", lambda b: 123.456)
    got = json.loads(_printed(port_bench.main, ["--device", "cpu"]).splitlines()[-1])
    want = json.loads(_printed(jax_bench.main).splitlines()[-1])
    assert got == want
    assert got["metric"] == "meta_yolo_train_images_per_sec_per_chip"
    assert got["unit"].endswith("batch 384)") and got["vs_baseline"] == round(123.456 / 30.0, 2)


def test_bench_falls_back_only_on_out_of_memory(port_bench, monkeypatch):
    tried = []

    def run(b, dev):
        tried.append(b)
        if b == 384:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 GiB")
        return 77.0

    monkeypatch.setattr(port_bench, "_run", run)
    out = _printed(port_bench.main, ["--device", "cpu"])
    assert tried == [384, 128]
    assert "batch 384: out of memory" in out and "Tried to allocate" in out
    assert json.loads(out.splitlines()[-1])["unit"].endswith("batch 128)")

    def broken(b, dev):
        tried.append(b)
        raise RuntimeError("CUDNN_STATUS_EXECUTION_FAILED")

    tried.clear()
    monkeypatch.setattr(port_bench, "_run", broken)
    with pytest.raises(RuntimeError, match="EXECUTION_FAILED"):
        port_bench.main(["--device", "cpu"])
    assert tried == [384]


def test_bench_chain_is_bench_py_chain(port_bench, jax_bench, monkeypatch):
    tried = {"port": [], "jax": []}

    def oom_port(b, dev):
        tried["port"].append(b)
        raise torch.cuda.OutOfMemoryError("out of memory")

    def oom_jax(b):
        tried["jax"].append(b)
        raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory")

    monkeypatch.setattr(port_bench, "_run", oom_port)
    monkeypatch.setattr(jax_bench, "_run", oom_jax)
    with pytest.raises(AssertionError):
        _printed(port_bench.main, ["--device", "cpu"])
    with pytest.raises(AssertionError), contextlib.redirect_stderr(io.StringIO()):
        _printed(jax_bench.main)
    assert tried["port"] == tried["jax"] == [384, 128, 64, 16]


def test_bench_runs_a_real_step_on_the_cpu(port_bench, monkeypatch):
    for k, v in (("SIZE", 64), ("N_CLS", 2), ("WARMUP", 1), ("ITERS", 1)):
        monkeypatch.setattr(port_bench, k, v)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rate = port_bench._run(2, torch.device("cpu"))
    assert np.isfinite(rate) and rate > 0
    assert "bn_sums launches a step: 0 forward, 0 backward" in out.getvalue()  # plain on CPU


def test_bench_refuses_cuda_without_a_card(port_bench):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.main([])


# --------------------------------------------------------------- roofline


def _spec():
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models.meta import MetaSpec
    from fewshot_detection_tpu_torch.models.spec import build_spec

    return MetaSpec(build_spec(parse_cfg(os.path.join(REPO, "cfg", "darknet_dynamic.cfg"))),
                    build_spec(parse_cfg(os.path.join(REPO, "cfg", "reweighting_net.cfg"))))


@pytest.mark.parametrize("size", [64, 96])
def test_roofline_flop_count_equals_the_spec(roofline, monkeypatch, size):
    for k, v in (("SIZE", size), ("N_CLS", 2), ("BATCH", 2), ("WARMUP", 1), ("ITERS", 1)):
        monkeypatch.setattr(roofline, k, v)
    printed = _printed(roofline.main, ["--device", "cpu"])
    line = printed.splitlines()[-1]
    assert line.startswith("ROOFLINE ")
    out = json.loads(line[len("ROOFLINE "):])
    want = roofline.spec_flops(_spec(), 2, 2, size)
    assert out["cost_flops_per_step"] == out["spec_flops_per_step"] == want
    assert out["flops_counted"] == "conv+matmul, fwd+bwd"
    assert out["mfu_pct"] is None and out["hbm_util_pct"] is None  # no card, no peak
    assert out["cost_bytes_per_step"] > 0 and out["aten_ops_per_step"] > 0
    assert out["bn_sums_launches_per_step"] == 0  # the plain version on the CPU


def test_roofline_spec_count_at_416_matches_an_independent_count(roofline):
    """FlopCounterMode over models/meta.py:forward(train=True) + backward at
    416 px, 15-way, batch 1 and 2, counted apart from this script: 88.12
    GFLOP an image and 401.39 GFLOP a step whatever the batch."""
    spec = _spec()
    f1, f2 = (roofline.spec_flops(spec, b, 15, 416) for b in (1, 2))
    assert f2 - f1 == 88_119_422_976
    assert 2 * f1 - f2 == 401_387_028_480
    assert round(roofline.spec_flops(spec, 384, 15, 416) / 384 / 1e9, 1) == 89.2


# XLA's flops of the JAX step over FlopCounterMode's of the port's step at
# 64 px, batch 2, 2-way (measured on a CPU: 4,579,687,936 against
# 5,435,621,376). Counts of two kinds: recorded, not a bound on either.
XLA_OVER_PORT_FLOPS_64PX = 0.8425


def test_roofline_flops_beside_xla_cost_analysis(roofline):
    import jax.numpy as jnp

    from fewshot_detection_tpu.config import parse_cfg as jparse
    from fewshot_detection_tpu.models.meta import MetaSpec as JMetaSpec
    from fewshot_detection_tpu.models.meta import init_meta_params as jinit
    from fewshot_detection_tpu.models.spec import build_spec as jbuild
    from fewshot_detection_tpu.train import MetaTrainer as JTrainer
    from fewshot_detection_tpu.train import init_momentum as jmom

    size, b, n = 64, 2, 2
    jspec = JMetaSpec(jbuild(jparse(os.path.join(REPO, "cfg", "darknet_dynamic.cfg"))),
                      jbuild(jparse(os.path.join(REPO, "cfg", "reweighting_net.cfg"))))
    params = jinit(jspec, 0)
    trainer = JTrainer(jspec, momentum=0.9, weight_decay=0.0005, donate=False, remat=True)
    compiled = trainer._step.lower(
        params, jmom(params), jnp.zeros((1, b, size, size, 3), jnp.bfloat16),
        jnp.zeros((1, n, size, size, 3), jnp.bfloat16),
        jnp.zeros((1, n, size, size, 1), jnp.bfloat16),
        jnp.zeros((1, b, n, 50, 5), jnp.float32), jnp.ones((1, b * n), jnp.float32),
        jnp.asarray(20000, jnp.int32), jnp.asarray(1e-5, jnp.float32)).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    port = roofline.spec_flops(_spec(), b, n, size)
    assert port == 5_435_621_376
    assert abs(float(ca["flops"]) / port - XLA_OVER_PORT_FLOPS_64PX) < 5e-4


def test_roofline_line_has_the_jax_keys_with_mfu(roofline, monkeypatch):
    tree = ast.parse(open(os.path.join(REPO, "scripts", "roofline_b384.py")).read())
    jax_keys = next(
        [k.value for k in node.value.keys] for node in ast.walk(tree)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
        and any(getattr(t, "id", None) == "out" for t in node.targets))
    assert "mxu_util_pct" in jax_keys
    for k, v in (("SIZE", 64), ("N_CLS", 2), ("BATCH", 1), ("WARMUP", 1), ("ITERS", 1)):
        monkeypatch.setattr(roofline, k, v)
    out = json.loads(_printed(roofline.main, ["--device", "cpu"]).splitlines()[-1][9:])
    want = [k for k in jax_keys if k != "mxu_util_pct"] + ["mfu_pct"]
    assert set(want) <= set(out) and "mxu_util_pct" not in out
    assert list(out)[:len(jax_keys) - 2] == jax_keys[:-2]  # the JAX order up to the shares


def test_roofline_byte_count_rules(roofline, monkeypatch):
    from fewshot_detection_tpu_torch.ops import bn_sums as bn_mod

    x = torch.ones(4, 8)
    y = torch.ones(8)
    with roofline._byte_counter(torch.device("cpu")) as mode:
        z = x + y  # reads 128 + 32, writes 128
        x.view(8, 4)  # a view moves nothing
        torch.empty(1000)  # an allocation moves nothing
        x.add_(y.expand(4, 8))  # a broadcast input counts its memory
    assert mode.bytes == (128 + 32 + 128) + (128 + 32 + 128) and mode.ops == 2
    assert z.shape == (4, 8)

    calls = []
    monkeypatch.setattr(bn_mod, "_launch_forward", lambda t: calls.append("f"))
    monkeypatch.setattr(bn_mod, "_launch_backward", lambda t, a, b: calls.append("b"))
    a = torch.zeros(10, 6, dtype=torch.bfloat16)
    with roofline.bn_sums_bytes([]) as record:
        bn_mod._launch_forward(a)
        bn_mod._launch_backward(a, None, None)
    assert calls == ["f", "b"]
    assert record == [10 * 6 * 2 + 2 * 6 * 4, 2 * 10 * 6 * 2 + 2 * 6 * 4]

    from fewshot_detection_tpu_torch.ops import bn_act as act_mod

    calls.clear()
    monkeypatch.setattr(act_mod, "_launch_forward", lambda *t: calls.append("f"))
    monkeypatch.setattr(act_mod, "_launch_backward", lambda *t: calls.append("b"))
    with roofline.bn_act_bytes([]) as record:
        act_mod._launch_forward(a, None, None, 0)
        act_mod._launch_backward(a, a, None, None, 0)
    assert calls == ["f", "b"]
    assert record == [2 * 10 * 6 * 2 + 2 * 6 * 4, 3 * 10 * 6 * 2 + 4 * 6 * 4]

    from fewshot_detection_tpu_torch.ops import pool2x2 as pool_mod

    calls.clear()
    monkeypatch.setattr(pool_mod, "_launch_forward", lambda *t: calls.append("f"))
    monkeypatch.setattr(pool_mod, "_launch_backward", lambda *t: calls.append("b"))
    x = torch.zeros(2, 5, 6, 8, dtype=torch.bfloat16)  # pools to (2, 2, 3, 8): 96 values
    code = torch.zeros(2, 2, 3, 8, dtype=torch.uint8)
    with roofline.pool_bytes([]) as record:
        pool_mod._launch_forward(x, True)
        pool_mod._launch_forward(x, False)
        pool_mod._launch_backward(x[:, :2, :3], code, 5, 6)
    assert calls == ["f", "f", "b"]
    assert record == [(480 + 96) * 2 + 96, (480 + 96) * 2, 96 * 2 + 96 + 480 * 2]


def test_roofline_refuses_a_card_without_a_published_peak(roofline):
    assert roofline.peaks_of("NVIDIA H100 80GB HBM3") == {"bf16_tflops": 989.4,
                                                          "hbm_gbs": 3350.0}
    with pytest.raises(ValueError, match="no published peak"):
        roofline.peaks_of("NVIDIA A100-SXM4-80GB")
