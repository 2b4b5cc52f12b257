"""Helpers shared by the tests/test_torch_*.py parity tests: one numpy
parameter tree and one numpy input go to the JAX package and to the
PyTorch port, both on the CPU."""

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



def jax_native_loader():
    """The JAX package's native loader module, its library in place and
    loaded. That loader compiles straight into its output file, so test
    processes building it side by side (worker processes of a loader
    included) could read each other's half-written library: here it is
    compiled under a temporary name with the loader's own command and moved
    into place whole. Fails when it cannot be built, because the JAX
    datasets would then fall back to PIL, and a comparison with the port's
    native path would compare different things."""
    from fewshot_detection_tpu.native import loader

    lib = loader._LIB
    if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(loader._SRC):
        tmp = f"{lib}.tmp.{os.getpid()}"
        loader._LIB = tmp
        try:
            err = loader._build()
        finally:
            loader._LIB = lib
        assert err is None, err
        os.replace(tmp, lib)
    assert loader.native_available(), loader.build_error()
    return loader
