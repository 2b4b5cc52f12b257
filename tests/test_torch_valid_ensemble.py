"""The serving slice as a whole: `run_valid_ensemble` of the PyTorch port
against the JAX package's, on the CPU, on one synthetic VOC-like data set
and one `.weights` file.

Result files must hold the same lines (same image ids, same number of
boxes, same order); the printed floats (probabilities, pixel corners of
64x48 images) agree to 1e-4: both sides compute in float32, where
convolution sums and sigmoid/exp/softmax differ in the last bits."""

import os

import numpy as np
import pytest

from fewshot_detection_tpu.cli.common import resolve_configs as j_resolve
from fewshot_detection_tpu.data.datasets import DetectionDataset as JDet
from fewshot_detection_tpu.data.datasets import MetaDataset as JMeta
from fewshot_detection_tpu.eval import valid as j_valid
from fewshot_detection_tpu_torch.cli.common import resolve_configs
from fewshot_detection_tpu_torch.data.datasets import DetectionDataset, MetaDataset
from fewshot_detection_tpu_torch.eval import valid as t_valid
from fewshot_detection_tpu_torch.eval.voc_eval import do_python_eval
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.meta import MetaSpec, init_meta_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.ops.nms_device import nms_rows

from synth import make_voc_like
from torch_port_util import REPO, cfg, randomize_bn

TOL = 1e-4


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("ens")
    d = make_voc_like(str(root / "data"), n_images=22, classes_per_image=2, seed=3)
    datacfg = str(root / "meta.data")
    with open(datacfg, "w") as f:
        f.write(
            "metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\n"
            f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
            f"meta={d['traindict']}\ntrain={d['train_list']}\n"
            f"valid={d['train_list']}\nbackup={root}/backup\ngpus=0\n"
        )
    dk, ln = cfg("tiny_darknet_dynamic.cfg"), cfg("tiny_reweighting.cfg")
    data_options, darknet, learnet, settings = resolve_configs(datacfg, dk, ln)
    spec = MetaSpec(build_spec(darknet), build_spec(learnet))
    params = init_meta_params(spec, 5)
    rng = np.random.default_rng(6)
    for k in params:
        randomize_bn(params[k], rng)
    os.makedirs(root / "backup")
    weights = str(root / "backup" / "000001.weights")
    weights_io.save_weights(weights, [spec.darknet, spec.learnet],
                            [params["darknet"], params["learnet"]], seen=64)
    return dict(root=str(root), datacfg=datacfg, dk=dk, ln=ln, weights=weights,
                data=d, cfgs=(data_options, darknet, learnet, settings))


def _in_env(ws, env, fn):
    cwd = os.getcwd()
    os.chdir(ws["root"])
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.chdir(cwd)


def _read(prefix, tag):
    files = sorted(fn for fn in os.listdir(prefix) if fn.startswith(tag))
    return {fn[len(tag):]: open(os.path.join(prefix, fn)).read().splitlines() for fn in files}


def _run_torch(ws, tag, env=None, **kw):
    data_options, darknet, learnet, settings = ws["cfgs"]
    env = {"FSD_EVAL_BATCH": "4", **(env or {})}
    prefix = _in_env(ws, env, lambda: os.path.abspath(t_valid.run_valid_ensemble(
        data_options, darknet, learnet, ws["weights"], settings,
        outfile=tag, device="cpu", **kw)))
    return prefix, _read(prefix, tag)


@pytest.fixture(scope="module")
def torch_files(ws):
    before = nms_rows.launches
    prefix, files = _run_torch(ws, "torch_det_")
    assert nms_rows.launches == before  # CPU tensors: the plain version, no launch
    return prefix, files


def test_result_files_equal_the_jax_packages(ws, torch_files):
    _, got = torch_files
    data_options, darknet, learnet, settings = j_resolve(ws["datacfg"], ws["dk"], ws["ln"])
    prefix = _in_env(ws, {"FSD_EVAL_BATCH": "4"}, lambda: os.path.abspath(
        j_valid.run_valid_ensemble(data_options, darknet, learnet, ws["weights"],
                                   settings, outfile="jax_det_")))
    want = _read(prefix, "jax_det_")
    assert sorted(got) == sorted(want) and len(got) == 20
    n_lines = 0
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            gp, wp = g.split(), w.split()
            assert gp[0] == wp[0] and len(gp) == len(wp) == 6
            np.testing.assert_allclose([float(v) for v in gp[1:]], [float(v) for v in wp[1:]],
                                       rtol=TOL, atol=TOL)
            n_lines += 1
    assert n_lines > 100, "too few detections for the comparison to mean anything"


@pytest.mark.parametrize("top_k", ["1", "8"], ids=["host_path", "truncated_buffer"])
def test_result_files_identical_in_every_regime(ws, torch_files, top_k):
    """A buffer of one slot, which hands every batch to the host path, or one
    so small that some rows overflow it, writes the same files as the device
    pipeline."""
    _, want = torch_files
    _, got = _run_torch(ws, f"alt{top_k}_det_", {"FSD_DEVICE_NMS_K": top_k})
    assert got == want


def test_saved_codes_spliced_back_give_the_same_files(ws, torch_files):
    """FSD_SAVE_RW writes the ensemble codes; use_baserw splices the base
    classes' codes back from that pickle."""
    _, want = torch_files
    pkl = os.path.join(ws["root"], "data", "rws", "voc_novel0_.pkl")
    _run_torch(ws, "save_det_", {"FSD_SAVE_RW": pkl})
    assert os.path.exists(pkl)
    prefix, got = _run_torch(ws, "rw_det_", use_baserw=True)
    assert os.path.basename(prefix).startswith("ene_")
    assert got == want


def test_result_files_score_with_the_ports_voc_eval(ws, torch_files):
    prefix, _ = torch_files
    result = _in_env(ws, {}, lambda: do_python_eval(
        prefix + "/torch_det_", devkit_path=ws["data"]["devkit"], novel=True,
        novel_file=os.path.join(REPO, "data/voc_novels.txt"),
        output_dir=os.path.join(ws["root"], "output")))
    assert 0.0 <= result["mean"] <= 1.0
    assert "base_mean" in result and "novel_mean" in result


def test_eval_datasets_equal_the_jax_packages(ws):
    data_options, _, _, settings = ws["cfgs"]
    jdo, _, _, jsettings = j_resolve(ws["datacfg"], ws["dk"], ws["ln"])
    kw = dict(shape=(128, 128), shuffle=False, train=False, filter_valid=False)
    a = list(DetectionDataset(data_options["valid"], settings, **kw).batches(8, drop_last=False))
    b = list(JDet(jdo["valid"], jsettings, **kw).batches(8, drop_last=False))
    assert len(a) == len(b) == 3
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
    ds = DetectionDataset(data_options["valid"], settings, **kw)
    assert ds.image_size(0) == (64, 48)

    kw = dict(train=False, ensemble=True, with_ids=True)
    ma = list(MetaDataset(data_options["meta"], settings, **kw).batches(16))
    mb = list(JMeta(jdo["meta"], jsettings, **kw).batches(16))
    assert len(ma) == len(mb) > 1
    for x, y in zip(ma, mb):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_training_mode_datasets_are_refused(ws):
    data_options, _, _, settings = ws["cfgs"]
    with pytest.raises(NotImplementedError):
        DetectionDataset(data_options["valid"], settings, train=True)
    with pytest.raises(NotImplementedError):
        MetaDataset(data_options["meta"], settings, train=False, ensemble=False)


def test_sweep_states_both_float32_precision_flags(ws, torch_files):
    """PyTorch's defaults differ between convolution (TF32) and matmul
    (float32); the sweep's entry point sets both, to full float32."""
    import torch

    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    torch.backends.cudnn.allow_tf32 = True
    t_valid.set_float32_precision(tf32=True)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    t_valid.set_float32_precision()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
