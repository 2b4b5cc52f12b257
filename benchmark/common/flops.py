"""Operations and bytes of a step, from the cfg alone (frozen copy).

Rewritten from `scripts/roofline_b384_torch.py:spec_flops` on the
benchmark's own cfg walk: convolutions and matrix products only. A conv
is 2*N*Ho*Wo*Cin*Cout*k^2 forward, as much again for its weight gradient,
and as much again for its input gradient except at a net's first conv,
whose input needs none; recomputed operations are not counted. A dynamic
1x1 conv followed by a 1x1 head is the fused reweight + head product,
(N*H*W, C) x (C, n_cls*K): 2*N*H*W*C*n_cls*K forward and both operand
gradients in a step.

`bn_layers` lists the (M, C) of every batch-normalised conv output, the
shapes the `bn_sums` kernels read.
"""

from __future__ import annotations

from .cfgparse import Layer


def net_flops(layers: list[Layer], n: int, n_cls: int = 1, train: bool = True) -> int:
    """FLOPs of one net over `n` images (a step's forward and both
    gradients with `train`, the forward alone without)."""
    total, first, skip = 0, True, False
    for i, layer in enumerate(layers):
        if layer.kind != "conv":
            continue
        if skip:  # the head inside the fused product
            skip = False
            continue
        if layer.dynamic:
            head = layers[i + 1]
            if not (layer.size == 1 and head.kind == "conv" and head.size == 1
                    and not head.dynamic and not layer.bn):
                raise ValueError(f"layer {layer.index}: a dynamic conv not fused with its head")
            fwd = 2 * n * layer.side_out ** 2 * layer.c_in * n_cls * head.c_out
            total += fwd * (3 if train else 1)
            skip = True
            continue
        fwd = 2 * n * layer.side_out ** 2 * layer.c_in * layer.c_out * layer.size ** 2
        total += fwd * ((2 if first else 3) if train else 1)
        first = False
    return total


def meta_step_flops(darknet: list[Layer], learnet: list[Layer], batch: int, n_cls: int) -> int:
    """A meta training step: the learnet on the n_cls supports, the
    backbone and the fused head on the batch."""
    return net_flops(learnet, n_cls, n_cls) + net_flops(darknet, batch, n_cls)


def bn_layers(layers: list[Layer], n: int) -> list[tuple[int, int]]:
    """(M, C) of every batch-normalised conv output of a net over n images."""
    return [(n * l.side_out ** 2, l.c_out) for l in layers if l.kind == "conv" and l.bn]


def bn_sums_bytes(shapes: list[tuple[int, int]], itemsize: int) -> int:
    """Least bytes of the BN statistics of a training step: the forward
    reads x once and writes 2*C float32 sums, the backward reads x and
    the two float32 cotangents and writes dx."""
    fwd = sum(m * c * itemsize + 2 * c * 4 for m, c in shapes)
    bwd = sum(2 * m * c * itemsize + 2 * c * 4 for m, c in shapes)
    return fwd + bwd
