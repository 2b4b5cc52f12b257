"""SGD + LR schedule with torch-0.3 semantics.

The reference optimizer (train_meta.py:143-147):
  optim.SGD(params, lr=learning_rate/batch_size, momentum=0.9, dampening=0,
            weight_decay=decay*batch_size*factor)
torch SGD update: d = g + wd*p; buf = mu*buf + d; p -= lr*buf.

BatchNorm running statistics live inside the same parameter tree but are
STATE, not weights: the update skips any leaf whose path contains 'mean' or
'var' (they get overwritten from the forward pass's bn_updates instead).
The plain trainer additionally exempts BN affine + biases from weight decay
(train.py:132-138); the meta trainer decays everything, matching
train_meta.py:143-147.

The trees are nested dicts and lists with tensor leaves (`models.convert`).
`sgd_update` writes parameters and momentum IN PLACE under
`torch.no_grad()` and returns the same trees, where the JAX package donates
its buffers and returns new ones.

The step-LR warmup schedule (cfg steps=-1,500,40000,60000 /
scales=0.1,10,.1,.1 — train_meta.py:150-163) and the neg-ratio LR factor
(train_meta.py:123-135) are reproduced as pure functions.
"""

from __future__ import annotations

import torch


def tree_leaves_with_path(tree, path=()):
    """Yield (path, leaf) for every non-None leaf of nested dicts, lists and
    tuples, dicts in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def tree_map(fn, tree, *rest):
    """Apply fn to the matching leaves of same-shaped trees (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """A tree of tree's shape with fn(path, leaf) at every non-None leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _is_bn_stat(path) -> bool:
    return ("mean" in path) or ("var" in path)


def _is_no_decay(path) -> bool:
    """BN affine (gamma/beta inside a 'bn' dict) and biases."""
    return ("bn" in path) or (len(path) > 0 and path[-1] == "b")


def init_momentum(params):
    return tree_map(torch.zeros_like, params)


def clip_by_global_norm(grads, max_norm: float):
    """Scale the gradient tree so its global L2 norm is <= max_norm.

    NOT part of the reference (its recipes always start from a pretrained
    darknet19 backbone and never need it); opt-in via FSD_CLIP_NORM for
    from-scratch runs, where the early conf loss can diverge SGD."""
    leaves = [g for _, g in tree_leaves_with_path(grads)]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


@torch.no_grad()
def sgd_update(
    params,
    grads,
    momentum_buf,
    lr,
    *,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    decay_bn_and_bias: bool = True,
    clip_norm: float = 0.0,
):
    """One torch-semantics SGD step over the full parameter tree, in place;
    BN running stats pass through untouched. clip_norm > 0 applies
    global-norm gradient clipping first (an opt-in extension — see
    clip_by_global_norm). Returns (params, momentum_buf), the trees it was
    given.

    The leaves are updated as lists, one a weight-decay value, by
    `torch._foreach_*` operations: each leaf takes the same elementwise
    operations as alone (the same bits), in a few launches a list instead of
    five a leaf, which at YOLOv3's 222 leaves was a fifth of the host's
    work a step."""
    if clip_norm and clip_norm > 0:
        grads = clip_by_global_norm(grads, clip_norm)
    g_leaves = dict(tree_leaves_with_path(grads))
    m_leaves = dict(tree_leaves_with_path(momentum_buf))
    groups: dict[float, tuple[list, list, list]] = {}
    for path, p in tree_leaves_with_path(params):
        if _is_bn_stat(path):
            continue
        wd = 0.0 if not decay_bn_and_bias and _is_no_decay(path) else weight_decay
        ps, ds, ms = groups.setdefault(wd, ([], [], []))
        ps.append(p)
        ds.append(g_leaves[path].to(p.dtype))
        ms.append(m_leaves[path])
    for wd, (ps, ds, ms) in groups.items():
        if wd:
            ds = torch._foreach_add(ds, torch._foreach_mul(ps, wd))  # d = g + wd * p
        torch._foreach_mul_(ms, momentum)
        torch._foreach_add_(ms, ds)
        torch._foreach_sub_(ps, torch._foreach_mul(ms, lr))
    return params, momentum_buf


def lr_schedule(
    processed_batches: int,
    base_lr: float,
    steps: tuple[float, ...],
    scales: tuple[float, ...],
) -> float:
    """adjust_learning_rate (train_meta.py:150-163): multiply by scale[i]
    for each step threshold crossed; stop scanning at the first step the
    batch count hasn't reached (or exactly equals)."""
    lr = base_lr
    for i, step in enumerate(steps):
        scale = scales[i] if i < len(scales) else 1.0
        if processed_batches >= step:
            lr = lr * scale
            if processed_batches == step:
                break
        else:
            break
    return lr


def neg_ratio_lr_factor(neg_ratio, n_meta_classes: int) -> float:
    """LR divisor keyed to the neg sampling ratio (train_meta.py:123-135)."""
    if neg_ratio == "full":
        return 15.0
    if neg_ratio == 1:
        return 3.0
    if neg_ratio == 0:
        return 1.5
    if neg_ratio == 5:
        return 8.0
    return float(n_meta_classes)
