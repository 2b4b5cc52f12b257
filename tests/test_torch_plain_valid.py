"""The plain and the per-batch-support sweeps of the PyTorch port
(`run_valid`, `run_valid_meta`) against the JAX package's, on the CPU, on
synthetic VOC-like data sets and one `.weights` file each.

Result files must hold the same lines (same image ids, same number of
boxes, same order); the printed floats (probabilities, pixel corners of
64x48 images) agree to 1e-4: both sides compute in float32, where
convolution sums and sigmoid/exp/softmax differ in the last bits. Within
the port, every regime of the candidate buffer (FSD_DEVICE_NMS_K 1: every
batch on the host path; 8: rows overflow; the default 256) writes identical
files."""

import os
import random

import numpy as np
import pytest

from fewshot_detection_tpu.cli.common import resolve_configs as j_resolve
from fewshot_detection_tpu.eval import valid as j_valid
from fewshot_detection_tpu_torch.cli.common import resolve_configs
from fewshot_detection_tpu_torch.data.datasets import DetectionDataset
from fewshot_detection_tpu_torch.eval.detector import PlainDetector
from fewshot_detection_tpu_torch.eval import valid as t_valid
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops.nms_device import nms_rows

from synth import make_voc_like
from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import REPO, assert_results_close, cfg, in_env, randomize_bn, read_results

TOL = 1e-4
REGIMES = pytest.mark.parametrize(
    "env", [{"FSD_DEVICE_NMS_K": "1"}, {"FSD_DEVICE_NMS_K": "8"}],
    ids=["host_path", "truncated_buffer"])


def _write_datacfg(path, d, root, metayolo):
    with open(path, "w") as f:
        f.write(
            (f"metayolo=1\nmetain_type=2\n" if metayolo else "metayolo=0\n") +
            "data=voc\nneg=1\nrand=0\n"
            f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
            f"meta={d['traindict']}\ntrain={d['train_list']}\n"
            f"valid={d['train_list']}\nbackup={root}/backup\ngpus=0\n")
    return path


@pytest.fixture(scope="module")
def plain_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("plain_valid")
    d = make_voc_like(str(root / "data"), n_images=22, seed=4)
    netcfg = str(root / "tiny_plain.cfg")
    with open(netcfg, "w") as f:
        f.write(TINY_PLAIN_CFG)
    datacfg = _write_datacfg(str(root / "plain.data"), d, root, metayolo=False)
    spec = build_spec(resolve_configs(datacfg, netcfg)[1])
    params = init_params(spec, 3)
    rng = np.random.default_rng(5)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.45  # keep activations O(1) through the stack
    randomize_bn(params, rng)
    os.makedirs(root / "backup")
    weights = str(root / "backup" / "000001.weights")
    weights_io.save_weights(weights, [spec], [params], seen=64)
    return dict(root=str(root), datacfg=datacfg, cfg=netcfg, weights=weights)


def _run_plain(ws, tag, env=None):
    data_options, _, _, settings = resolve_configs(ws["datacfg"], ws["cfg"])
    env = {"FSD_EVAL_BATCH": "4", "FSD_DEVICE_NMS_K": None, **(env or {})}
    prefix = in_env(ws["root"], env, lambda: os.path.abspath(t_valid.run_valid(
        data_options, ws["cfg"], ws["weights"], settings, outfile=tag, device="cpu")))
    return read_results(prefix, tag)


@pytest.fixture(scope="module")
def plain_files(plain_ws):
    before = nms_rows.launches
    files = _run_plain(plain_ws, "torch_det_")
    assert nms_rows.launches == before  # CPU tensors: the plain version, no launch
    return files


def test_run_valid_files_equal_the_jax_packages(plain_ws, plain_files):
    data_options, _, _, settings = j_resolve(plain_ws["datacfg"], plain_ws["cfg"])
    prefix = in_env(plain_ws["root"], {"FSD_EVAL_BATCH": "4"}, lambda: os.path.abspath(
        j_valid.run_valid(data_options, plain_ws["cfg"], plain_ws["weights"], settings,
                          outfile="jax_det_")))
    want = read_results(prefix, "jax_det_")
    assert len(want) == 20
    n_lines = assert_results_close(plain_files, want, TOL)
    assert n_lines > 200, "too few detections for the comparison to mean anything"
    assert sum(1 for v in plain_files.values() if v) > 10  # boxes reach many class files


@REGIMES
def test_run_valid_files_identical_in_every_regime(plain_ws, plain_files, env):
    tag = "alt" + "".join(env.values())
    assert _run_plain(plain_ws, f"{tag}_det_", env) == plain_files


def test_plain_sweep_takes_the_device_path_where_the_buffer_holds(plain_ws):
    """Through `_plain_sweep` with its stats: every batch on the device at
    the default buffer, none at a buffer of one slot, where every row
    overflows it."""
    data_options, _, _, settings = resolve_configs(plain_ws["datacfg"], plain_ws["cfg"])
    m = PlainDetector(plain_ws["cfg"], plain_ws["weights"], device="cpu")
    ds = DetectionDataset(data_options["valid"], settings, shape=(m.width, m.height),
                          shuffle=False, train=False, filter_valid=False)
    seen = {}
    for env in ({}, {"FSD_DEVICE_NMS_K": "1"}):
        stats = {}
        full = {"FSD_DEVICE_NMS_K": None, **env}
        in_env(plain_ws["root"], full, lambda: t_valid._plain_sweep(
            m, ds, os.path.join(plain_ws["root"], "stats"), "s_", settings.classes, 8,
            stats=stats))
        seen[tuple(env.values())] = stats
    assert seen[()]["batches"] == 3 and seen[()]["device_batches"] == 3
    assert 1 < seen[()]["max_candidates"] <= 45  # 3x3 cells, 5 anchors
    assert seen[("1",)]["batches"] == 3 and seen[("1",)]["device_batches"] == 0
    assert seen[("1",)]["max_candidates"] == seen[()]["max_candidates"]


@pytest.fixture(scope="module")
def meta_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("meta_valid")
    d = make_voc_like(str(root / "data"), n_images=22, classes_per_image=2, seed=3)
    datacfg = _write_datacfg(str(root / "meta.data"), d, root, metayolo=True)
    dk, ln = cfg("tiny_darknet_dynamic.cfg"), cfg("tiny_reweighting.cfg")
    cfgs = resolve_configs(datacfg, dk, ln)
    spec = MetaSpec(build_spec(cfgs[1]), build_spec(cfgs[2]))
    params = init_meta_params(spec, 5)
    rng = np.random.default_rng(6)
    for k in params:
        randomize_bn(params[k], rng)
    os.makedirs(root / "backup")
    weights = str(root / "backup" / "000001.weights")
    weights_io.save_weights(weights, [spec.darknet, spec.learnet],
                            [params["darknet"], params["learnet"]], seen=64)
    return dict(root=str(root), datacfg=datacfg, dk=dk, ln=ln, weights=weights)


def _run_meta(ws, tag, env=None):
    data_options, darknet, learnet, settings = resolve_configs(ws["datacfg"], ws["dk"], ws["ln"])
    env = {"FSD_DEVICE_NMS_K": None, **(env or {})}
    prefix = in_env(ws["root"], env, lambda: os.path.abspath(t_valid.run_valid_meta(
        data_options, darknet, learnet, ws["weights"], settings, outfile=tag,
        rng=random.Random(7), device="cpu")))
    return read_results(prefix, tag)


@pytest.fixture(scope="module")
def meta_files(meta_ws):
    return _run_meta(meta_ws, "torch_det_")


def test_run_valid_meta_files_equal_the_jax_packages(meta_ws, meta_files):
    """The support batch of every detection batch is drawn from one pinned
    `random.Random` on both sides, so both see the same codes."""
    data_options, darknet, learnet, settings = j_resolve(meta_ws["datacfg"], meta_ws["dk"],
                                                         meta_ws["ln"])
    prefix = in_env(meta_ws["root"], {}, lambda: os.path.abspath(
        j_valid.run_valid_meta(data_options, darknet, learnet, meta_ws["weights"], settings,
                               outfile="jax_det_", rng=random.Random(7))))
    want = read_results(prefix, "jax_det_")
    assert len(want) == 20
    assert assert_results_close(meta_files, want, TOL) > 100


@REGIMES
def test_run_valid_meta_files_identical_in_every_regime(meta_ws, meta_files, env):
    tag = "alt" + "".join(env.values())
    assert _run_meta(meta_ws, f"{tag}_det_", env) == meta_files


def test_run_valid_meta_draws_fresh_supports_every_batch(meta_ws, meta_files):
    """Another support draw gives other codes, so other files: the sweep
    really takes a new support batch for each detection batch."""
    data_options, darknet, learnet, settings = resolve_configs(meta_ws["datacfg"], meta_ws["dk"],
                                                               meta_ws["ln"])
    prefix = in_env(meta_ws["root"], {}, lambda: os.path.abspath(t_valid.run_valid_meta(
        data_options, darknet, learnet, meta_ws["weights"], settings, outfile="other_",
        rng=random.Random(8), device="cpu")))
    assert read_results(prefix, "other_") != meta_files


@pytest.mark.parametrize("sweep", ["run_valid", "run_valid_meta", "run_valid_ensemble"])
def test_eval_mesh_is_refused(plain_ws, meta_ws, sweep):
    """FSD_EVAL_MESH=2 needs a world of 2 ranks (torchrun); a process started
    alone is a world of one, so every sweep refuses it before it reads a
    file. The sharded sweeps themselves: test_torch_parallel.py."""
    def call():
        if sweep == "run_valid":
            return t_valid.run_valid({}, plain_ws["cfg"], "none.weights", None, device="cpu")
        return getattr(t_valid, sweep)({}, meta_ws["dk"], meta_ws["ln"], "none.weights", None,
                                       device="cpu")

    with pytest.raises(ValueError, match="FSD_EVAL_MESH=2 needs a world of 2 ranks"):
        in_env(plain_ws["root"], {"FSD_EVAL_MESH": "2"}, call)
