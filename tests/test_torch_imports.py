"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
nor the tests' helpers nor PIL, and holds no quiet way around its kernel."""

import os
import re
import subprocess
import sys

import pytest

from torch_port_util import REPO

PKG = os.path.join(REPO, "fewshot_detection_tpu_torch")


ROOT_SCRIPTS = ("valid_ensemble_torch.py", "train_meta_torch.py", "valid_torch.py",
                "valid_meta_torch.py", "detect_torch.py", "eval_torch.py", "recall_torch.py",
                "train_torch.py", "partial_torch.py", "debug_torch.py", "demo_torch.py",
                "scripts/full_workflow_torch.py", "scripts/int8_map_torch.py",
                "scripts/full_workflow_coco_torch.py", "scripts/voc_label_torch.py",
                "scripts/voc_label_1c_torch.py", "scripts/gen_fewlist_torch.py",
                "scripts/convert_fewlist_torch.py", "scripts/gen_traindict_torch.py",
                "scripts/voc_eval_torch.py", "coco/process_data_torch.py",
                "scripts/cls_curve_torch.py", "scripts/tuning_delta_torch.py",
                "scripts/seed_stats_torch.py", "scripts/shot_sweep_torch.py",
                "scripts/learning_check_torch.py", "scripts/support_snr_torch.py",
                "scripts/eval_widerface_torch.py", "scripts/multiscale_epoch_torch.py",
                "bench_torch.py", "scripts/roofline_b384_torch.py",
                "scripts/bench_meta_pipeline_torch.py", "scripts/bench_int8_meta_torch.py",
                "scripts/bench_input_pipeline_torch.py")
TEST_HELPERS = ("synth", "torch_port_util", "torch_image_writers", "torch_ref",
                "torch_parallel_util", "tests")


def _port_sources():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", *ROOT_SCRIPTS)]
    for root, _, names in os.walk(PKG):
        if "_build" in root or "__pycache__" in root:
            continue
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cpp"))]
    return sorted(files)


def test_importing_every_submodule_loads_no_jax_no_pil_no_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import fewshot_detection_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert len(names) >= 35, names\n"
        "for n in ('ops.bn_sums', 'ops._build', 'ops.region_loss', 'train.optim', 'train.trainer',\n"
        "          'cli.train_meta_cli', 'data.augment', 'data.loader', 'utils.logging',\n"
        "          'eval.harness', 'cli.train_plain_cli', 'native', 'native.loader',\n"
        "          'data.mploader', 'data.prep', 'data.coco_prep', 'train.checkpoint',\n"
        "          'utils.profiling', 'utils.trace_summary', 'data.synth', 'cli.workflow',\n"
        "          'cli.partial', 'data.png', 'models.quant', 'ops.int8_mm', 'models.zoo',\n"
        "          'models.caffe_net', 'ops.focal_loss', 'parallel', 'parallel.mesh',\n"
        "          'cli.workflow_coco'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'PIL')\n"
        f"       or k.split('.')[0] in {TEST_HELPERS!r}\n"
        "       or k == 'fewshot_detection_tpu' or k.startswith('fewshot_detection_tpu.')]\n"
        "assert not bad, bad\n"
        "assert not sys.modules[p.__name__ + '.native.loader']._loaded  # built at first use only\n"
        "print('clean', len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_root_scripts_import_no_jax_no_pil_no_jax_package():
    """Every root script of the port, imported as a module (its work sits
    under the __main__ check), with PIL and cv2 blocked."""
    code = (
        "import sys, runpy\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['cv2'] = None\n"
        f"for n in {ROOT_SCRIPTS!r}:\n"
        "    runpy.run_path(n, run_name='not_main')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')\n"
        f"       or k.split('.')[0] in {TEST_HELPERS!r}\n"
        "       or k == 'fewshot_detection_tpu' or k.startswith('fewshot_detection_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_package_imports_with_pil_blocked():
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"  # any `import PIL` now raises ImportError
        "import pkgutil, importlib\n"
        "import fewshot_detection_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


FORBIDDEN = {
    "import of jax": re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M),
    "import of the JAX package": re.compile(
        r"^\s*(import|from)\s+fewshot_detection_tpu(\.|\s)", re.M),
    "top-level import of PIL": re.compile(r"^(import|from)\s+PIL\b", re.M),
    "import of the tests' helpers": re.compile(
        r"^\s*(import|from)\s+(" + "|".join(TEST_HELPERS) + r")\b", re.M),
    "fallback on is_available()": re.compile(r"is_available\(\)\s+else"),
    "bare except": re.compile(r"^\s*except\s*:", re.M),
    "torchvision": re.compile(r"^\s*(import|from)\s+torchvision\b", re.M),
    "torch.compile": re.compile(r"torch\.compile\("),
    "library batch norm": re.compile(r"F\.batch_norm\(|nn\.BatchNorm\dd\(|torch\.batch_norm\("),
    # DDP averages gradients and broadcasts rank 0's BN buffers; the
    # reference sums gradients and averages the running statistics
    "DDP or sync-BN": re.compile(r"DistributedDataParallel|SyncBatchNorm"),
}


@pytest.mark.parametrize("what", sorted(FORBIDDEN))
def test_port_sources_hold_no(what):
    files = _port_sources()
    assert len(files) > 35
    hits = [os.path.relpath(f, REPO) for f in files if FORBIDDEN[what].search(open(f).read())]
    assert not hits, f"{what} in {hits}"


@pytest.mark.parametrize("module,counts", [
    ("nms_device.py", ["nms_rows.launches += 1"]),
    ("bn_sums.py", ["bn_sums.launches += 1", "bn_sums.backward_launches += 1",
                    "bn_sums.layout_copies += 1"]),
    ("_build.py", []),
])
def test_kernel_wrapper_has_no_try_around_build_or_launch(module, counts):
    src = open(os.path.join(PKG, "ops", module)).read()
    assert not re.search(r"^\s*try\s*:", src, re.M)
    for count in counts:
        assert src.count(count) == 1, count  # counted where the kernel launches, nowhere else


def test_both_kernels_build_through_the_shared_helper():
    from fewshot_detection_tpu_torch.ops import _build

    for name in ("nms", "bn_sums"):
        assert os.path.isfile(_build.source_path(name))
        lib = _build.library_path(name)
        assert os.path.dirname(lib) == os.path.join(PKG, "_build")
        assert re.fullmatch(rf"libfsd_{name}_[0-9a-f]{{12}}\.so", os.path.basename(lib))
    assert "-fmad=false" in _build.NVCC_FLAGS and "--use_fast_math" not in _build.NVCC_FLAGS
    for module in ("nms_device.py", "bn_sums.py"):
        src = open(os.path.join(PKG, "ops", module)).read()
        assert "load_library(" in src and "subprocess" not in src and "nvcc" not in src.split('"""')[2]


def test_chip_smoke_fails_without_a_gpu():
    """The smoke script is for the card: here it must exit non-zero and
    print no result line."""
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_points_default_to_cuda_and_raise_without_one():
    import torch

    from fewshot_detection_tpu_torch.eval.detector import MetaDetector, resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    cfgs = [os.path.join(REPO, "cfg", n) for n in ("tiny_darknet_dynamic.cfg", "tiny_reweighting.cfg")]
    with pytest.raises(RuntimeError):
        MetaDetector(*cfgs)  # device defaults to "cuda"

    import inspect

    from fewshot_detection_tpu_torch.cli import train_meta_cli
    from fewshot_detection_tpu_torch.train import MetaTrainer

    assert inspect.signature(MetaTrainer.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(train_meta_cli.main).parameters["device"].default == "cuda"
    m = MetaDetector(*cfgs, device="cpu")
    with pytest.raises(RuntimeError):
        MetaTrainer(m.spec)
    with pytest.raises(RuntimeError):
        train_meta_cli.main("no.data", *cfgs, "no.weights")  # refused before any file is read


def test_plain_family_entry_points_default_to_cuda_and_raise_without_one():
    import inspect
    import runpy

    import torch

    from fewshot_detection_tpu_torch.cli import train_plain_cli
    from fewshot_detection_tpu_torch.eval import valid
    from fewshot_detection_tpu_torch.eval.detector import PlainDetector
    from fewshot_detection_tpu_torch.train import PlainTrainer

    scripts = {n: runpy.run_path(os.path.join(REPO, n), run_name="not_main")
               for n in ("detect_torch.py", "eval_torch.py", "recall_torch.py")}
    defaults = [PlainDetector.__init__, PlainTrainer.__init__, train_plain_cli.main,
                valid.run_valid, valid.run_valid_meta, valid.run_valid_ensemble,
                scripts["eval_torch.py"]["main"], scripts["recall_torch.py"]["main"],
                *scripts["detect_torch.py"]["VARIANTS"].values()]
    for fn in defaults:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    plain = os.path.join(REPO, "cfg", "tiny-yolo-voc.cfg")
    with pytest.raises(RuntimeError):
        PlainDetector(plain)
    with pytest.raises(RuntimeError):
        PlainTrainer(PlainDetector(plain, device="cpu").spec)
    with pytest.raises(RuntimeError):
        train_plain_cli.main("no.data", plain, "no.weights")  # refused before any file is read


def test_workflow_defaults_to_cuda_and_raises_without_one(tmp_path, monkeypatch):
    import inspect

    import torch

    from fewshot_detection_tpu_torch.cli import workflow

    for name, value in workflow.DEFAULTS.items():  # main() sets them; put back after
        monkeypatch.setattr(workflow, name, value)

    assert workflow.parse_args([]).device == "cuda"
    assert workflow.DEVICE == "cuda"
    assert set(inspect.signature(workflow.main).parameters) == {"argv"}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    root = str(tmp_path / "wf")
    with pytest.raises(RuntimeError):
        workflow.main(["--tiny", "--root", root, "--n-train", "20", "--n-test", "4",
                       "--base-batches", "1"])  # the data stage runs, base refuses
    assert os.path.exists(workflow.done_marker(root, "data"))
    assert not os.path.exists(workflow.done_marker(root, "base"))


def test_analysis_tools_default_to_cuda_and_raise_without_one(tmp_path):
    """The five analysis tools that run a model take --device, default
    cuda, and refuse before they write anything when there is no card."""
    import inspect
    import runpy

    import torch

    from fewshot_detection_tpu_torch.cli import workflow

    tools = {n: runpy.run_path(os.path.join(REPO, "scripts", f"{n}_torch.py"), run_name="x")
             for n in ("shot_sweep", "learning_check", "support_snr", "eval_widerface",
                       "multiscale_epoch")}
    for fn in (tools["support_snr"]["measure"], tools["support_snr"]["draw_codes"],
               tools["eval_widerface"]["eval_widerface"]):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    root = str(tmp_path / "tiny")
    workflow.mark_done(root, "data", {"mode": "tiny"})
    workflow.mark_done(root, "base", {"ckpt": "none.weights"})
    defaults = {k: getattr(workflow, k) for k in workflow.DEFAULTS}
    calls = [
        lambda: tools["shot_sweep"]["main"](["--root", root]),
        lambda: tools["learning_check"]["main"](["--root", str(tmp_path / "lc")]),
        lambda: tools["support_snr"]["main"](["support_snr_torch.py", "no.data", "a.cfg",
                                              "b.cfg"]),
        lambda: tools["eval_widerface"]["main"](["eval_widerface_torch.py",
                                                 os.path.join(REPO, "cfg", "tiny-yolo-voc.cfg"),
                                                 "", str(tmp_path), str(tmp_path / "out")]),
        lambda: tools["multiscale_epoch"]["main"](["--root", str(tmp_path / "ms")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()
    assert sorted(os.listdir(tmp_path)) == ["tiny"]
    assert not os.path.exists(os.path.join(root, "shot1"))
    assert {k: getattr(workflow, k) for k in workflow.DEFAULTS} == defaults


def test_bench_scripts_default_to_cuda_and_raise_without_one(tmp_path):
    """The five bench scripts take --device, default cuda, and refuse
    before they measure or write anything when there is no card."""
    import runpy

    import torch

    scripts = ("bench_torch.py", "scripts/roofline_b384_torch.py",
               "scripts/bench_meta_pipeline_torch.py", "scripts/bench_int8_meta_torch.py",
               "scripts/bench_input_pipeline_torch.py")
    mains = {n: runpy.run_path(os.path.join(REPO, n), run_name="x")["main"] for n in scripts}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    for name, main in mains.items():
        argv = ["--root", str(tmp_path)] if "input_pipeline" in name else []
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert os.listdir(tmp_path) == []


def test_train_imports_nothing_from_eval():
    """The train step sits below the sweep: nothing under train/ imports
    from eval/ (the device check it needs lives in utils/card.py)."""
    import ast

    train = os.path.join(PKG, "train")
    for name in sorted(os.listdir(train)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(train, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert "eval" not in (node.module or "").split("."), (name, node.module)
