"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
nor PIL, and holds no quiet way around its kernel."""

import os
import re
import subprocess
import sys

import pytest

from torch_port_util import REPO

PKG = os.path.join(REPO, "fewshot_detection_tpu_torch")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "valid_ensemble_torch.py")]
    for root, _, names in os.walk(PKG):
        if "_build" in root or "__pycache__" in root:
            continue
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu"))]
    return sorted(files)


def test_importing_every_submodule_loads_no_jax_no_pil_no_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import fewshot_detection_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert len(names) >= 20, names\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'PIL')\n"
        "       or k == 'fewshot_detection_tpu' or k.startswith('fewshot_detection_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n"
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
    "fallback on is_available()": re.compile(r"is_available\(\)\s+else"),
    "bare except": re.compile(r"^\s*except\s*:", re.M),
    "torchvision": re.compile(r"^\s*(import|from)\s+torchvision\b", re.M),
    "torch.compile": re.compile(r"torch\.compile\("),
}


@pytest.mark.parametrize("what", sorted(FORBIDDEN))
def test_port_sources_hold_no(what):
    files = _port_sources()
    assert len(files) > 20
    hits = [os.path.relpath(f, REPO) for f in files if FORBIDDEN[what].search(open(f).read())]
    assert not hits, f"{what} in {hits}"


def test_kernel_wrapper_has_no_try_around_build_or_launch():
    src = open(os.path.join(PKG, "ops", "nms_device.py")).read()
    assert not re.search(r"^\s*try\s*:", src, re.M)
    assert "nms_rows.launches += 1" in src


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
