"""How the port's native library is built: from every source under
`native/src/`, linked with zlib and pthreads only (no libjpeg, no libpng),
under a name that changes when any source changes, and imported without
PIL or any image library."""

import os
import shutil
import subprocess
import sys

import pytest

from fewshot_detection_tpu_torch.native import loader as t_loader


def test_build_command_links_zlib_and_pthreads_only():
    cmd = t_loader.build_command("out.so")
    assert "-pthread" in cmd and cmd[-1] == "-lz"
    assert not [a for a in cmd if a.startswith("-l") and a != "-lz"]
    src_dir = os.path.join(os.path.dirname(t_loader.__file__), "src")
    on_disk = {os.path.join(src_dir, f) for f in os.listdir(src_dir)}
    assert on_disk == set(t_loader.SOURCES) | set(t_loader.HEADERS)
    assert all(s in cmd for s in t_loader.SOURCES)
    for path in (*t_loader.SOURCES, *t_loader.HEADERS):
        with open(path) as f:
            text = f.read()
        assert "jpeglib.h" not in text and "<png.h>" not in text, path


@pytest.mark.parametrize("which", range(4))
def test_editing_any_source_renames_the_library(monkeypatch, tmp_path, which):
    copies = []
    for path in (*t_loader.SOURCES, *t_loader.HEADERS):
        copy = tmp_path / os.path.basename(path)
        shutil.copy(path, copy)
        copies.append(str(copy))
    n = len(t_loader.SOURCES)
    monkeypatch.setattr(t_loader, "SOURCES", tuple(copies[:n]))
    monkeypatch.setattr(t_loader, "HEADERS", tuple(copies[n:]))
    before = t_loader.library_path()
    with open(copies[which], "a") as f:
        f.write("\n// edited\n")
    assert t_loader.library_path() != before


def test_built_library_needs_no_image_library():
    lib = t_loader.build_library()
    ldd = subprocess.run(["ldd", lib], capture_output=True, text=True)
    assert ldd.returncode == 0, ldd.stderr
    assert "libz" in ldd.stdout
    assert "libjpeg" not in ldd.stdout and "libpng" not in ldd.stdout, ldd.stdout


def test_import_needs_no_pil():
    code = ("import sys; sys.modules['PIL'] = None\n"
            "from fewshot_detection_tpu_torch.native import loader\n"
            "p = loader.NativeImagePipe(n_threads=2)\n"
            "print(p.image_size(sys.argv[1]))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code, os.path.join(repo, "predictions.jpg")],
                          capture_output=True, text=True, cwd=repo, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "(400, 300)"
