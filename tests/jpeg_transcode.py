"""Lossless transcodes of JPEG files into progressive and arithmetic coding,
for the port's decoder tests and fixtures.

`tests/data_torch/jpeg/transcode.c` is built with the system's libjpeg
(`gcc ... -ljpeg`), under a file lock that every test process takes, into
the port's gitignored `_build/` directory, named by the source's digest,
written under a temporary name and moved into place whole. It is test
tooling, never part of the port."""

import fcntl
import hashlib
import os
import subprocess
import tempfile

from torch_port_util import JAX_LIB_BUILD_DIR, REPO

SOURCE = os.path.join(REPO, "tests", "data_torch", "jpeg", "transcode.c")


def tool(build_dir: str = JAX_LIB_BUILD_DIR) -> str:
    """The transcoder's path, built if missing."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    out = os.path.join(build_dir, f"jpeg_transcode_{digest}")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "jpeg_transcode.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.tmp.{os.getpid()}"
            subprocess.run(["gcc", "-O1", "-o", tmp, SOURCE, "-ljpeg"], check=True,
                           capture_output=True)
            os.replace(tmp, out)
    return out


def transcode(data: bytes, arith=False, progressive=False, restart=0, script=None) -> bytes:
    """The file's coefficients written again: arithmetic coding (SOF9, or
    SOF10 when progressive), libjpeg's standard progressive script or
    `script` (scans as "c0,c1:Ss:Se:Ah:Al" joined by ';'), and a restart
    interval of `restart` MCUs."""
    args = [tool()]
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.jpg"), os.path.join(d, "out.jpg")
        with open(src, "wb") as f:
            f.write(data)
        args += [src, dst]
        if arith:
            args.append("-a")
        if progressive:
            args.append("-p")
        if restart:
            args += ["-r", str(restart)]
        if script:
            args += ["-s", script]
        proc = subprocess.run(args, capture_output=True, text=True)
        if proc.returncode:
            raise ValueError(f"transcode {args[3:]}: {proc.stderr.strip()}")
        with open(dst, "rb") as f:
            return f.read()


def with_dac(data: bytes, pairs) -> bytes:
    """The file with a DAC segment of (table index, value) pairs before its
    first SOS: an arithmetic decoder then conditions on other statistics
    bins than the encoder did, and decodes other (deterministic)
    coefficients."""
    i = data.index(b"\xff\xda")
    body = bytes(v for pair in pairs for v in pair)
    return data[:i] + b"\xff\xcc" + (len(body) + 2).to_bytes(2, "big") + body + data[i:]


def random_script(rng, n_comps: int, complete: bool = False) -> str:
    """A progressive scan script that libjpeg's encoder accepts: the DC
    first (all components interleaved, or one scan each) at some Al, AC
    bands of one component each, some sent at Al > 0, then successive
    approximation down to Al = 0. Unless `complete`, the script may leave
    bands out and stop refining early, so that the decoder's coefficients
    are incomplete (libjpeg's block smoothing then runs)."""
    first, chains = [], []
    comps = list(range(n_comps))

    def refinements(spec, al):  # Ah = al .. stop+1, each one bit lower
        stop = 0 if complete else int(rng.randint(0, al + 1))
        return [f"{spec}:{a}:{a - 1}" for a in range(al, stop, -1)]

    dc_al = int(rng.randint(0, 3))
    if n_comps > 1 and rng.rand() < 0.5:
        first += [f"{c}:0:0:0:{dc_al}" for c in comps]
    else:
        first.append(",".join(map(str, comps)) + f":0:0:0:{dc_al}")
    chains.append(refinements(",".join(map(str, comps)) + ":0:0", dc_al))
    for c in comps:
        cuts = sorted(set(int(v) for v in rng.randint(2, 63, int(rng.randint(0, 3)))))
        edges = [1] + cuts + [64]
        for ss, nxt in zip(edges[:-1], edges[1:]):
            if not complete and rng.rand() < 0.15:
                continue  # the band is never sent
            al = int(rng.randint(0, 3))
            first.append(f"{c}:{ss}:{nxt - 1}:0:{al}")
            chains.append(refinements(f"{c}:{ss}:{nxt - 1}", al))
    return ";".join(first + [s for i in rng.permutation(len(chains)) for s in chains[i]])
