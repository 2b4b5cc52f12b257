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
