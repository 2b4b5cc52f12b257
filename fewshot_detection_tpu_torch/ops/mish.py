"""Mish, x * tanh(softplus(x)) (Misra, arXiv:1908.08681), YOLOv4's backbone
activation, on PyTorch's own kernels.

`mish(x)` runs `F.mish` forward and `aten.mish_backward` backward: the
kernels autograd runs for `F.mish`, so the values and gradients are its
bits. The function only counts them: `mish.launches` one a forward call and
`mish.backward_launches` one a backward, on any device (on the card each is
one kernel launch). It saves its input for the backward, one tensor a Mish
layer. In training the batch norm before it is `bn_act`'s linear epilogue
(`ops/layers.py:bn_train_activate`), so a Mish layer runs two elementwise
kernels each way where a leaky one runs one; darknet computes softplus with
a threshold of 20, PyTorch's kernel with its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _Mish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        mish.launches += 1
        return F.mish(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        mish.backward_launches += 1
        return torch.ops.aten.mish_backward(g, x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), differentiable; counted in `mish.launches`
    and `mish.backward_launches`."""
    return _Mish.apply(x)


mish.launches = 0
mish.backward_launches = 0
