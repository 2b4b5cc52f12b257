"""Focal loss (reference FocalLoss.py:13-96 — present in the codebase but
unused on the main path; kept for surface parity), the port's counterpart of
the JAX package's ops/focal_loss.py.

loss(x, cls) = -alpha[cls] * (1 - softmax(x)[cls])^gamma * log softmax(x)[cls]
"""

from __future__ import annotations

import torch


def focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 2.0,
    alpha: torch.Tensor | None = None,
    size_average: bool = True,
) -> torch.Tensor:
    """logits (N, C); targets (N,) int. gamma=0 with uniform alpha reduces
    to cross-entropy (the reference's own self-check, FocalLoss.py:80-105).
    """
    c = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    logp_t = torch.gather(logp, -1, targets.long()[:, None])[:, 0]
    p_t = torch.exp(logp_t)
    a = (torch.ones((c,), dtype=logits.dtype, device=logits.device) if alpha is None
         else torch.as_tensor(alpha, dtype=logits.dtype, device=logits.device).reshape(-1))
    a_t = a[targets.long()]
    loss = -a_t * (1.0 - p_t) ** gamma * logp_t
    return loss.mean() if size_average else loss.sum()
