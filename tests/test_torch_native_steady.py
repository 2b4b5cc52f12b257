"""The JAX package's native library as the port's tests load it
(`torch_port_util.jax_native_loader`), under the race that test processes
run into: the JAX loader compiles straight into its output file, and every
test process asks for it while being collected, so compilers write one path
at once while other processes load it.

Processes started together first let the JAX loader build in place into
one fresh path (the race), then call `jax_native_loader`: each must load the
library and decode a committed fixture to its digest, whatever its first
load gave. A process whose first load met a file cut short (the loader then
keeps the failure for the life of the process) must load it too."""

import json
import os
import subprocess
import sys

from torch_port_util import REPO

FIXTURE = "tests/data_torch/jpeg/adobe_rgb.jpg"
CHILD = r"""
import hashlib, json, sys
from fewshot_detection_tpu.native import loader
from torch_port_util import jax_native_loader

default, build_dir, cut_short, fixture = sys.argv[1:5]
loader._LIB = default
if cut_short == "1":
    with open(default, "wb") as f:
        f.write(b"\x7fELF\x02\x01\x01")  # a library whose writer has not finished
first = loader.native_available()
error = loader.build_error()
j = jax_native_loader(default_lib=default, build_dir=build_dir)
arr = j.NativeImagePipe(n_threads=1).decode(fixture)
print(json.dumps({"first": first, "error": error,
                  "sha": hashlib.sha256(arr.tobytes()).hexdigest()}))
"""


def _start(default, build_dir, cut_short):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, str(default), str(build_dir), cut_short,
         os.path.join(REPO, FIXTURE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def _finish(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_processes_building_at_once_each_load_the_whole_library(tmp_path):
    with open(os.path.join(REPO, "tests", "data_torch", "jpeg", "manifest.json")) as f:
        want = json.load(f)[os.path.basename(FIXTURE)]["jax"]
    build_dir = tmp_path / "build"
    (tmp_path / "race").mkdir()
    racers = [_start(tmp_path / "race" / "libimagepipe.so", build_dir, "0") for _ in range(4)]
    results = [_finish(p) for p in racers]
    assert [r["sha"] for r in results] == [want] * len(results)

    (tmp_path / "cut").mkdir()
    cut = _finish(_start(tmp_path / "cut" / "libimagepipe.so", build_dir, "1"))
    assert cut["first"] is False and "too short" in cut["error"]
    assert cut["sha"] == want
    # one private copy and the lock; no temporary file left behind
    names = sorted(os.listdir(build_dir))
    assert len(names) == 2 and names[0] == "jax_libimagepipe.lock", names
    assert names[1].startswith("jax_libimagepipe_") and names[1].endswith(".so"), names
