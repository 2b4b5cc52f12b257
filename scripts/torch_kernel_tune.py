#!/usr/bin/env python3
"""The port's two redesigned CUDA kernels against variants of themselves,
timed on the card.

    python3 scripts/torch_kernel_tune.py [--seed N] [--other-nms FILE.cu ...]

Needs a CUDA device and `nvcc`. The kernels have no tuning arguments: a
variant is a copy of the source in which one constant or a few lines are
replaced (`NMS_VARIANTS`, `BN_VARIANTS` below; a replacement that no longer
finds its text fails), built beside the product into the build directory.
Prints JSON lines:

  nms_rows     `csrc/nms.cu` at (320, 256) full and sparse rows and at
               (16, 845): as it is, with one thread a candidate, with the
               division of `over` skipped far from the threshold, and every
               `--other-nms` source (an earlier version of the kernel, say:
               anything with the interface of `fsd_nms_rows`)
  bn_sums_fwd  `csrc/bn_sums.cu`'s forward at the training step's main
               shapes, float32 and bfloat16: as it is, with other tile widths
               (LANES), and with other numbers of row blocks

Every variant's result is held against the product's, then all are timed in
turn on the same inputs, twice round (`device_ms` holds both readings): the
launches queued behind a kernel that keeps the card busy until the host is
done queueing, so what is read is what the card takes. Keep the card's name
and power limit, printed first, beside any number taken from here.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from fewshot_detection_tpu_torch.ops import _build, bn_sums as bn_mod  # noqa: E402
from fewshot_detection_tpu_torch.ops.nms_device import nms_rows  # noqa: E402

NMS_VARIANTS = {
    "one_thread_a_candidate": [("PAIRED_THREADS = 512;", "PAIRED_THREADS = 0;")],
    # A pair whose intersection is further than 2^-20 (relative) from thresh
    # times the union is decided by that product, without the division: each
    # rounding is off by at most 2^-24 relative, so the rounded quotient
    # falls on the same side. Holds for a threshold in [2^-10, 1].
    "division_shortcut": [(
        "  return __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thresh;\n",
        "  const float u = fmaxf(uni, 1e-12f);\n"
        "  if (inter > __fmul_rn(u, __fmul_rn(thresh, 1.0f + 0x1p-20f))) return true;\n"
        "  if (inter < __fmul_rn(u, __fmul_rn(thresh, 1.0f - 0x1p-20f))) return false;\n"
        "  return __fdiv_rn(inter, u) > thresh;\n")],
}
BN_VARIANTS = {f"lanes_{n}": [("constexpr int LANES = 8;", f"constexpr int LANES = {n};")]
               for n in (4, 16, 32)}
NMS_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p]


def start_variant(name: str, tag: str, edits: list):
    """Start `nvcc` on a copy of csrc/<name>.cu in which every (old, new) of
    `edits` has replaced its one occurrence; returns (process, library path)."""
    with open(_build.source_path(name)) as f:
        src = f.read()
    for old, new in edits:
        cs.check(src.count(old) == 1, f"variant {tag}: {old!r} is not in csrc/{name}.cu once")
        src = src.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"variant_{name}_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    return start_source(path)


def start_source(path: str):
    lib = os.path.join(_build.BUILD_DIR, "tune_" + os.path.basename(path) + ".so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    return subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, path]), lib


def finish(started, symbol: str, argtypes: list):
    """The built library's `symbol`."""
    proc, lib = started
    cs.check(proc.wait() == 0, f"nvcc failed on {lib}")
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def time_in_turn(launchers: dict, repeats: int = 50) -> dict:
    """{name: [device ms, first round and second]}."""
    out = {name: [] for name in launchers}
    for _ in range(2):
        for name, fn in launchers.items():
            out[name].append(cs.card_ms(fn, repeats))
    return out


def sparse_rows(rng, r: int, k: int):
    """Rows filled like the serving path's: 45 live candidates on average,
    the fullest row at 215 of 256."""
    boxes, conf = cs.make_nms_rows(rng, r, k)
    n_valid = np.minimum(rng.geometric(1 / 45, r), 215)
    n_valid[0] = 215
    for row in range(r):
        conf[row, n_valid[row]:] = 0.0
    return boxes, conf


def tune_nms(seed: int, others: list) -> None:
    started = {tag: start_variant("nms", tag, edits) for tag, edits in NMS_VARIANTS.items()}
    started.update({path: start_source(path) for path in others})
    fns = {tag: finish(s, "fsd_nms_rows", NMS_ARGTYPES) for tag, s in started.items()}
    rng = np.random.default_rng(seed)
    cases = [("full", *cs.make_nms_rows(rng, 320, 256)), ("sparse", *sparse_rows(rng, 320, 256)),
             ("full", *cs.make_nms_rows(rng, 16, 845))]
    for kind, boxes, conf in cases:
        boxes, conf = torch.from_numpy(boxes).cuda(), torch.from_numpy(conf).cuda()
        r, k = conf.shape
        want = nms_rows(boxes, conf, cs.NMS_THRESH)
        keep = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def launcher(tag):
            def launch():
                err = fns[tag](boxes.data_ptr(), conf.data_ptr(), keep.data_ptr(), r, k,
                               cs.NMS_THRESH, stream)
                cs.check(err == 0, f"nms variant {tag} failed with CUDA error {err}")
            return launch

        launchers = {"product": lambda: nms_rows(boxes, conf, cs.NMS_THRESH)}
        for tag in fns:
            launchers[tag] = launcher(tag)
            keep.zero_()
            launchers[tag]()
            torch.cuda.synchronize()
            cs.check(torch.equal(keep, want), f"nms variant {tag} disagrees with the product")
        print(json.dumps({"phase": "nms_rows", "rows": kind, "shape": [r, k],
                          "valid": int((conf > 0).sum()), "kept": int(want.sum()),
                          "device_ms": time_in_turn(launchers)}), flush=True)


def tune_bn(seed: int) -> None:
    product, _ = bn_mod._kernels()
    started = {tag: start_variant("bn_sums", tag, edits) for tag, edits in BN_VARIANTS.items()}
    fns = {tag: finish(s, "fsd_bn_sums_fwd", product.argtypes) for tag, s in started.items()}
    fns["product"] = product
    stream = torch.cuda.current_stream().cuda_stream

    def blocks(m, c, vec, lanes, resident):
        """`row_blocks` of the wrapper for another tile width and fill."""
        saved = bn_mod._VEC_LANES, bn_mod._VECTOR_RESIDENT
        bn_mod._VEC_LANES, bn_mod._VECTOR_RESIDENT = lanes, resident
        try:
            return bn_mod.row_blocks(m, c, vec, forward=True)
        finally:
            bn_mod._VEC_LANES, bn_mod._VECTOR_RESIDENT = saved

    for dtype in (torch.float32, torch.bfloat16):
        for m, c in cs.BN_MAIN_SHAPES:
            x = cs.make_activation(seed, m, c, dtype)
            vec = bn_mod.vector_width(c, x.element_size(), x.data_ptr())
            want = bn_mod._launch_forward(x)
            out = torch.empty((2, c), dtype=torch.float32, device=x.device)
            path = ctypes.c_int(-1)

            def launcher(tag, g):
                def launch():
                    ws, slots = bn_mod._workspace(x.device, stream, c, 2 * g * c)
                    err = fns[tag](x.data_ptr(), ws.data_ptr(), slots, out.data_ptr(), m, c, g,
                                   int(dtype == torch.bfloat16), stream, ctypes.byref(path))
                    cs.check(err == 0, f"bn_sums variant {tag} g={g} failed with CUDA error {err}")
                return launch

            resident = bn_mod._VECTOR_RESIDENT
            launchers, grids, seen = {}, {}, set()
            for tag, lanes, fill in [("product", 8, resident), ("lanes_4", 4, resident),
                                     ("lanes_16", 16, resident), ("lanes_32", 32, resident),
                                     ("product", 8, resident // 2), ("product", 8, 2 * resident)]:
                g = blocks(m, c, vec, lanes, fill)
                name = f"{tag}_resident_{fill}"
                if (tag, g) in seen:
                    continue  # the shape has too few rows for this fill to differ
                seen.add((tag, g))
                grids[name] = g
                launchers[name] = launcher(tag, g)
                launchers[name]()
                torch.cuda.synchronize()
                # another geometry adds in another order: close, not equal
                close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-2) for a, b in zip(out, want))
                cs.check(close and path.value == 1, f"bn_sums variant {name} disagrees at {(m, c)}")
            launchers["torch.var_mean"] = lambda: torch.var_mean(x, dim=0, correction=0)
            print(json.dumps({"phase": "bn_sums_fwd", "shape": [m, c],
                              "dtype": str(dtype).split(".")[-1], "row_blocks": grids,
                              "bound_ms": cs.bn_bound_ms(m, c, x.element_size(), False),
                              "device_ms": time_in_turn(launchers, 30)}), flush=True)
            del x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--other-nms", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    tune_nms(args.seed, args.other_nms)
    tune_bn(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
