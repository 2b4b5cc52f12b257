"""Running a cell of the miniature checkout in a process of its own."""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

SCRIPT = """
import json, sys
sys.path[:0] = [{repo!r}, {here!r}]
import faults
if {fault!r}:
    faults.apply({fault!r})
from benchmark import run
rc = run.main({argv!r}, device="cpu", root={root!r})
banned = sorted({{m.split(".")[0] for m in sys.modules}}
                & {{"jax", "jaxlib", "flax", "fewshot_detection_tpu"}})
print("RC " + json.dumps({{"rc": rc, "banned": banned}}))
"""


def run_cell(root: str, cell: str, seed: int = 2147483900, trace: int = 0,
             fault: str = "", seconds: float = 1.0) -> tuple[dict, dict]:
    """(the result line, {"rc", "banned"}) of one CPU run of `cell`."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    code = SCRIPT.format(repo=REPO, here=HERE, fault=fault, argv=argv, root=root)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=root)
    lines = out.stdout.strip().splitlines()
    tail = [l for l in lines if l.startswith("RC ")]
    assert tail, f"no result:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}"
    status = json.loads(tail[-1][3:])
    result = json.loads(lines[lines.index(tail[-1]) - 1]) if status["rc"] == 0 else {}
    return result, status
