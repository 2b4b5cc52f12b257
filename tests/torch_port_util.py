"""Helpers shared by the tests/test_torch_*.py parity tests: one numpy
parameter tree and one numpy input go to the JAX package and to the
PyTorch port, both on the CPU."""

import contextlib
import fcntl
import hashlib
import io
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The test run uses several worker processes; PyTorch would give each of them
# one thread per core, and the oversubscribed cores then make every test slow.
torch.set_num_threads(min(2, torch.get_num_threads()))


def cfg(name):
    return os.path.join(REPO, "cfg", name)


def randomize_bn(params, rng):
    """Give every BN non-trivial statistics (the init is gamma=1, var=1),
    in place on a numpy tree; returns it."""
    for p in params:
        if p and "bn" in p:
            c = p["bn"]["gamma"].shape[0]
            p["bn"] = {
                "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "beta": rng.uniform(-0.3, 0.3, c).astype(np.float32),
                "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
            }
    return params


def to_jnp_tree(params):
    """numpy tree -> jnp tree for the JAX package's functions."""
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, params)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def in_env(root, env, fn):
    """fn() run from directory `root` with the variables of `env` set (a
    value of None unsets one); both restored afterwards."""
    cwd = os.getcwd()
    os.chdir(root)
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.chdir(cwd)


def read_results(prefix, tag):
    """{class name: lines} of the result files `<prefix>/<tag><class>.txt`."""
    files = sorted(fn for fn in os.listdir(prefix) if fn.startswith(tag))
    return {fn[len(tag):]: open(os.path.join(prefix, fn)).read().splitlines() for fn in files}


def assert_results_close(got, want, tol):
    """Same files, same lines (image ids, number and order of boxes); the
    printed floats within `tol`. Returns the number of lines compared."""
    assert sorted(got) == sorted(want)
    n_lines = 0
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            gp, wp = g.split(), w.split()
            assert gp[0] == wp[0] and len(gp) == len(wp) == 6
            np.testing.assert_allclose([float(v) for v in gp[1:]], [float(v) for v in wp[1:]],
                                       rtol=tol, atol=tol)
            n_lines += 1
    return n_lines



def files_under(roots):
    out = {}
    for root in roots:
        for d, _, names in os.walk(root):
            for n in names:
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[p] = (os.stat(p).st_mtime_ns, f.read())
    return out


def outputs_of(roots, fn):
    """(files fn wrote under the roots, with their bytes; what it printed;
    what it returned); the trees are put back as they were."""
    before = files_under(roots)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn()
    after = files_under(roots)
    written = {p: b for p, (t, b) in after.items() if before.get(p, (None,))[0] != t}
    for p in written:
        if p in before:
            with open(p, "wb") as f:
                f.write(before[p][1])
            os.utime(p, ns=(before[p][0], before[p][0]))
        else:
            os.remove(p)
    return written, buf.getvalue(), ret


def same_outputs(roots, t_fn, j_fn):
    """The port's `t_fn` and the JAX package's `j_fn` on the same trees:
    the same files written, byte for byte, the same prints and returns."""
    roots = [roots] if isinstance(roots, str) else roots
    got, want = outputs_of(roots, t_fn), outputs_of(roots, j_fn)
    assert sorted(got[0]) == sorted(want[0]) and got[0]
    for p in want[0]:
        assert got[0][p] == want[0][p], p
    assert got[1:] == want[1:]
    return got


JAX_LIB_BUILD_DIR = os.path.join(REPO, "fewshot_detection_tpu_torch", "_build")


def _build_whole(loader, path):
    """The JAX loader's own compile command, written under a temporary name
    and moved into place whole."""
    tmp = f"{path}.tmp.{os.getpid()}"
    lib = loader._LIB
    loader._LIB = tmp
    try:
        err = loader._build()
    finally:
        loader._LIB = lib
    assert err is None, err
    os.replace(tmp, path)


def build_jax_native_library(default_lib=None, build_dir=JAX_LIB_BUILD_DIR) -> str:
    """The JAX package's native library whole on disk, at its own path
    (`default_lib`, the package's `native/libimagepipe.so`) and as a private
    copy under `build_dir` named by the source's digest; returns the copy's
    path.

    The JAX loader compiles straight into its output file and decides by
    mtime, so processes that ask for it at once can load a file another is
    still writing. Here, under a file lock that every test process takes,
    each of the two is compiled under a temporary name with the loader's own
    command and moved into place whole, if missing or stale. Loader
    processes the JAX package spawns load the package's path; nothing ever
    writes the private copy in place."""
    from fewshot_detection_tpu.native import loader

    default_lib = default_lib or os.path.join(os.path.dirname(loader.__file__), "libimagepipe.so")
    with open(loader._SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    private = os.path.join(build_dir, f"jax_libimagepipe_{digest}.so")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "jax_libimagepipe.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for path in (default_lib, private):
            if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(loader._SRC):
                _build_whole(loader, path)
    return private


def jax_native_loader(default_lib=None, build_dir=JAX_LIB_BUILD_DIR):
    """The JAX package's native loader module, its library whole on disk
    (`build_jax_native_library`) and loaded in this process from the private
    copy. Fails when it cannot be built, because the JAX datasets would then
    fall back to PIL, and a comparison with the port's native path would
    compare different things.

    The loader's state in this process (`_LIB`, `_lib`, `_build_error`) is
    pointed at the private copy, dropping whatever it loaded or failed to
    load before: a process that asked while another was writing the
    package's path keeps that failure ("file too short") for its life, or a
    library loaded from a file then rewritten under it."""
    from fewshot_detection_tpu.native import loader

    private = build_jax_native_library(default_lib, build_dir)
    with loader._lock:
        if loader._LIB != private:
            loader._LIB, loader._lib, loader._build_error = private, None, None
    assert loader.native_available(), loader.build_error()
    return loader
