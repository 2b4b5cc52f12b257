"""Train steps (meta + plain) with replica-group semantics.

Counterparts of the JAX package's `train/trainer.py:MetaTrainer` and
`PlainTrainer`. A step takes inputs with a leading replica-group axis R.
The JAX package vmaps the per-group episode over R and shards that axis one
group per device. Here a trainer runs the groups it is given one after
another on its device: each group normalizes with its OWN batch
statistics, the groups' losses are summed and differentiated once, the
metrics are summed, and the new BN running statistics are AVERAGED over
the groups. This reproduces the reference's DataParallel layout — for the
meta step each replica gets its own support batch with one sample per
class (train_meta.py:137-141, dataset.py:348).

With a `mesh` (parallel/mesh.py; one rank a device) each rank is given its
own contiguous share of the R groups (`shard_batch`), and the step sums
over the ranks what the groups give: the gradients and the metrics are
all-reduced with SUM, the BN updates summed over every group and divided by
R. So `clip_norm` sees the global norm, every rank ends the step with the
same tree, and N ranks take the step that R groups take on one device. This
is not DDP, which averages gradients and broadcasts rank 0's BN buffers.

Parameters and momentum are updated IN PLACE (the JAX package donates its
buffers instead): `step` returns the trees it was given. Every leaf except
the BN running statistics must require gradients
(`models.convert.require_grads`).
"""

from __future__ import annotations

import torch

from ..models import meta as meta_mod
from ..models.darknet import apply_network
from ..models.spec import NetSpec
from ..ops.bn_act import bn_act
from ..ops.bn_sums import bn_sums
from ..ops.mish import mish
from ..ops.pool2x2 import maxpool2x2
from ..ops.region_loss import region_loss, region_loss_v2
from ..ops.yolo_loss import yolo_loss
from ..utils.card import resolve_device
from ..utils.profiling import span, step_span
from .optim import sgd_update, tree_leaves_with_path, tree_map, tree_map_with_path
from .staging import to_device


def _decode_images(arrays, dtype):
    """uint8-shipped image tensors (FSD_INPUT_U8) -> [0,1] compute dtype;
    non-u8 inputs pass through."""
    return tuple(a.to(dtype) / 255.0 if a.dtype == torch.uint8 else a for a in arrays)


@torch.no_grad()
def apply_bn_updates(params: list, updates: dict[int, dict]) -> list:
    """Write new running stats into the per-layer params list, in place."""
    for idx, stats in updates.items():
        bn = params[idx]["bn"]
        bn["mean"].copy_(stats["mean"])
        bn["var"].copy_(stats["var"])
    return params


def apply_meta_bn_updates(params: dict, bn: dict) -> dict:
    # stem updates (feat_layer>0) apply first; detect-pass updates win on
    # overlap, mirroring the reference's sequential in-place updates
    apply_bn_updates(params["darknet"], bn.get("darknet_stem", {}))
    apply_bn_updates(params["darknet"], bn.get("darknet", {}))
    apply_bn_updates(params["learnet"], bn.get("learnet", {}))
    return params


def _mean_over_groups(trees: list):
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *xs: torch.stack(xs).mean(dim=0), *trees)


def _sum_over_groups(trees: list):
    return tree_map(lambda *xs: torch.stack(xs).sum(dim=0), *trees)


def _sum_metrics(per_group: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in per_group]).sum(dim=0) for k in per_group[0]}


class _GroupTrainer:
    """What both trainers share: the R groups of a batch one after another,
    one backward over the summed loss, in-place SGD and the BN merge.
    A subclass names its batch keys (`_KEYS`, the images first), its
    per-group `_episode_loss(params, *group_tensors, seen)` -> (loss,
    bn_updates, metrics), whether weight decay reaches BN affine and biases,
    and how the averaged BN updates are written back."""

    _KEYS: tuple[str, ...] = ()
    _DECAY_BN_AND_BIAS = True

    def __init__(self, *, momentum, weight_decay, clip_norm, image_dtype,
                 warmup_seen, device, mesh=None):
        self.device = resolve_device(device)
        # the data-parallel world (parallel.Mesh), or None for one process
        self.mesh = mesh
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        # coord warm-up threshold (settings.warmup_seen; reference hardcodes
        # 12800, region_loss.py:70-79)
        self.warmup_seen = warmup_seen
        # compute dtype that uint8-shipped inputs decode to (FSD_INPUT_U8)
        self.image_dtype = image_dtype

    def loss_and_grads(self, params, batch: dict, seen: int):
        """Forward and backward of one step, nothing updated: (summed loss,
        gradient tree of params' shape, per-group bn_updates, summed
        metrics). A leaf the loss does not reach, and the BN running
        statistics, get zero gradients. Spans: `train.to_device` (with the
        batch's `bytes`, and of them the `staged_bytes` that went through
        the pinned ring in its `chunks`, and its `slot_waits`;
        `train/staging.py`), `train.forward` a group (with its `group`),
        `train.backward`."""
        with span("train.to_device") as sp:
            tensors, counts = to_device([batch[k] for k in self._KEYS], self.device)
            sp.add("bytes", sum(t.nbytes for t in tensors))
            for k, v in counts.items():
                sp.add(k, v)
        paths, leaves = zip(*(
            (p, t) for p, t in tree_leaves_with_path(params) if t.requires_grad
        ))
        losses, bns, metrics = [], [], []
        for r in range(tensors[0].shape[0]):
            with span("train.forward") as sp:
                sp.add("group", r)
                loss, bn, m = self._episode_loss(params, *(t[r] for t in tensors), seen)
            losses.append(loss)
            bns.append(bn)
            metrics.append({k: v.detach() for k, v in m.items()})
        total = losses[0] if len(losses) == 1 else torch.stack(losses).sum()
        with span("train.backward"):
            got = dict(zip(paths, torch.autograd.grad(total, leaves, allow_unused=True)))
            grads = tree_map_with_path(
                lambda path, t: got[path] if got.get(path) is not None else torch.zeros_like(t),
                params,
            )
        return total.detach(), grads, bns, _sum_metrics(metrics)

    def step(self, params, mom, batch: dict, seen: int, lr: float):
        """One train step; returns (params, mom, metrics) with the metrics
        as 0-d tensors left on the device (summed over the groups, and over
        the ranks with a mesh). With a mesh, `batch` holds this rank's
        groups only. Spans: `train.step`, which starts a step identifier
        and counts the step's `bn_sums`, `bn_act` and `maxpool2x2` kernel
        launches (`pool_forward`, `pool_backward`) and its Mish calls each
        way (`mish_forward`, `mish_backward`: `ops/mish.py`), around those of
        `loss_and_grads`, `train.allreduce` (with a mesh) and
        `train.update` (the BN merge, `sgd_update`, `_apply_bn`)."""
        with step_span("train.step") as sp:
            fwd, bwd = bn_sums.launches, bn_sums.backward_launches
            act_fwd, act_bwd = bn_act.launches, bn_act.backward_launches
            pool_fwd, pool_bwd = maxpool2x2.launches, maxpool2x2.backward_launches
            mish_fwd, mish_bwd = mish.launches, mish.backward_launches
            _, grads, bns, metrics = self.loss_and_grads(params, batch, seen)
            if self.mesh is not None:
                # this rank's groups summed, then everything summed over the
                # ranks in one flat buffer a dtype (float32 and int64: two
                # collectives a step)
                n_groups = len(bns) * self.mesh.size
                bn = _sum_over_groups(bns)
                with span("train.allreduce"):
                    self.mesh.all_reduce_sum((grads, bn, metrics))
            with span("train.update"):
                if self.mesh is None:
                    bn = _mean_over_groups(bns)
                else:
                    bn = tree_map(lambda x: x / n_groups, bn)
                sgd_update(
                    params, grads, mom, lr,
                    momentum=self.momentum, weight_decay=self.weight_decay,
                    decay_bn_and_bias=self._DECAY_BN_AND_BIAS, clip_norm=self.clip_norm,
                )
                self._apply_bn(params, bn)
            sp.add("bn_sums_forward", bn_sums.launches - fwd)
            sp.add("bn_sums_backward", bn_sums.backward_launches - bwd)
            sp.add("bn_act_forward", bn_act.launches - act_fwd)
            sp.add("bn_act_backward", bn_act.backward_launches - act_bwd)
            sp.add("pool_forward", maxpool2x2.launches - pool_fwd)
            sp.add("pool_backward", maxpool2x2.backward_launches - pool_bwd)
            sp.add("mish_forward", mish.launches - mish_fwd)
            sp.add("mish_backward", mish.backward_launches - mish_bwd)
        return params, mom, metrics


class MetaTrainer(_GroupTrainer):
    """Episodic meta-detector training step.

    Step inputs (R = replica groups, b = per-group detection batch), numpy
    arrays or tensors on any device:
      x      (R, b, H, W, 3)        detection images
      metax  (R, n_cls, Hm, Wm, Cm) support images (one per class, in order)
      mask   (R, n_cls, hm, wm, 1)  support masks
      target (R, b, n_cls, 50, 5)   per-class-binned labels
      keep   (R, b*n_cls)           neg-filter weights (host-sampled)
      seen   host int               sample counter (warm-up switch)
      lr     host float             current learning rate (already /batch)
    Weight decay reaches every parameter (train_meta.py decays everything).
    """

    _KEYS = ("x", "metax", "mask", "target", "keep")

    def __init__(
        self,
        spec: meta_mod.MetaSpec,
        *,
        momentum: float = 0.9,
        weight_decay: float = 0.0,
        metain_type: int = 2,
        remat: bool = False,
        s2d: bool = False,
        clip_norm: float = 0.0,
        image_dtype: torch.dtype = torch.float32,
        warmup_seen: int = 12800,
        device="cuda",
        mesh=None,
    ):
        # `remat` is accepted and ignored: the JAX trainer's
        # rematerialization keeps the conv outputs and BN statistics, which
        # is all that training BN keeps here (ops/layers.py:bn_train_activate)
        del remat
        super().__init__(momentum=momentum, weight_decay=weight_decay,
                         clip_norm=clip_norm, image_dtype=image_dtype,
                         warmup_seen=warmup_seen, device=device, mesh=mesh)
        self.spec = spec
        self.region = spec.region
        self.metain_type = metain_type
        # the space-to-depth stem where a network's first layers allow it
        # (models/darknet.py:can_fuse_s2d_stem)
        self.s2d = s2d

    def _episode_loss(self, params, x, metax, mask, target, keep, seen):
        x, metax, mask = _decode_images((x, metax, mask), self.image_dtype)
        n_cls = metax.shape[0]
        y, aux = meta_mod.forward(
            self.spec, params, x, metax, mask,
            metain_type=self.metain_type, train=True, s2d=self.s2d,
        )
        loss, metrics = region_loss_v2(
            y, target, keep, seen, self.region, n_cls, warmup_seen=self.warmup_seen
        )
        return loss, aux["bn_updates"], metrics

    _apply_bn = staticmethod(apply_meta_bn_updates)

    def multi_step(self, params, mom, batches: dict, seens, lrs):
        """N train steps, one after another: the same math as N step()
        calls. (The JAX package scans them inside one compiled program to
        save dispatches; here a step is eager either way.)

        batches: the step() dict with an extra leading axis N on every
        leaf; seens/lrs: N values, seens[i] already including step i's
        images (the CLI increments `seen` before each step). Returns
        (params, mom, metrics) with metrics stacked (N, ...)."""
        per_step = []
        for i, (seen, lr) in enumerate(zip(seens, lrs)):
            batch = {k: v[i] for k, v in batches.items()}
            params, mom, metrics = self.step(params, mom, batch, int(seen), float(lr))
            per_step.append(metrics)
        return params, mom, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


class PlainTrainer(_GroupTrainer):
    """Baseline YOLOv2 training step (reference train.py:126-225), and
    YOLOv3's: the loss is the spec's, `ops/yolo_loss.py` for a net with
    [yolo] heads, the region loss otherwise.

    Step inputs (R = replica groups, b = per-group batch), numpy arrays or
    tensors on any device: x (R, b, H, W, 3), target (R, b, 50, 5), keep
    (R, b); seen and lr as for MetaTrainer. Weight decay exempts BN affine
    and biases (train.py:132-138). Every training BN goes through the
    `bn_sums` and `bn_act` kernels, one forward and one backward launch of
    each a BN layer and group. Span: `train.loss` around the loss (with
    `heads`, `predictions` and `truth_rows`, counts known on the host)."""

    _KEYS = ("x", "target", "keep")
    _DECAY_BN_AND_BIAS = False

    def __init__(
        self,
        spec: NetSpec,
        *,
        momentum: float = 0.9,
        weight_decay: float = 0.0,
        zero_tcls: bool = False,
        remat: bool = False,
        s2d: bool = False,
        clip_norm: float = 0.0,
        image_dtype: torch.dtype = torch.float32,
        warmup_seen: int = 12800,
        device="cuda",
        mesh=None,
    ):
        # `remat` is accepted and ignored: the JAX trainer's
        # rematerialization keeps the conv outputs and BN statistics, which
        # is all that training BN keeps here (ops/layers.py:bn_train_activate)
        del remat
        super().__init__(momentum=momentum, weight_decay=weight_decay,
                         clip_norm=clip_norm, image_dtype=image_dtype,
                         warmup_seen=warmup_seen, device=device, mesh=mesh)
        self.spec = spec
        self.region = spec.region
        self.zero_tcls = zero_tcls
        self.s2d = s2d

    def _episode_loss(self, params, x, target, keep, seen):
        (x,) = _decode_images((x,), self.image_dtype)
        y, aux = apply_network(self.spec, params, x, train=True, s2d_stem=self.s2d)
        yolo = self.spec.yolo_heads
        heads = y if yolo else (y,)
        per_prediction = 5 + (yolo[0] if yolo else self.region).num_classes
        with span("train.loss", heads=len(heads),
                  predictions=sum(h.numel() for h in heads) // per_prediction,
                  truth_rows=target.shape[0] * target.shape[1]):
            if yolo:
                loss, metrics = yolo_loss(heads, target, keep, yolo, (x.shape[2], x.shape[1]))
            else:
                loss, metrics = region_loss(
                    y, target, keep, seen, self.region, zero_tcls=self.zero_tcls,
                    warmup_seen=self.warmup_seen,
                )
        return loss, aux["bn_updates"], metrics

    _apply_bn = staticmethod(apply_bn_updates)
