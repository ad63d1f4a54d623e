"""The untargeted norm-bounded colour attack (the NB attack of
PointSecGuard's ``nontarget.py``), plain: iterations of the sign of the
gradient of the summed per-point cross-entropy over the points' count,
with respect to the colours only, projected onto the L∞ ball of radius
eps around the clean colours and clipped to [0, 1]."""

from __future__ import annotations

import torch

from perfbench.reference.layers import log_softmax_ce

COLORS = (3, 6)


def with_color(points: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    lo, hi = COLORS
    return torch.cat([points[..., :lo], color, points[..., hi:]], dim=-1)


def nb_step(outputs_fn, points: torch.Tensor, labels: torch.Tensor, color: torch.Tensor, *,
            eps: float, alpha: float) -> torch.Tensor:
    """One iteration from the colours ``color`` [B, N, 3] of ``points``,
    whose own colours are the clean ones → the next colours."""
    lo, hi = COLORS
    points = points.detach()
    color0 = points[..., lo:hi]
    leaf = color.detach().requires_grad_(True)
    ce = log_softmax_ce(outputs_fn(with_color(points, leaf)), labels)
    (g,) = torch.autograd.grad(torch.sum(ce) / points.shape[1], leaf)
    with torch.no_grad():
        stepped = color + alpha * torch.sign(g)
        return torch.clamp(color0 + torch.clamp(stepped - color0, -eps, eps), 0.0, 1.0)


def nb_attack(outputs_fn, points: torch.Tensor, labels: torch.Tensor, *, eps: float,
              alpha: float, iters: int) -> torch.Tensor:
    """→ the adversarial points [B, N, C]; ``outputs_fn(points)`` gives
    per-point outputs, taken as logits."""
    lo, hi = COLORS
    color = points[..., lo:hi].detach()
    for _ in range(iters):
        color = nb_step(outputs_fn, points, labels, color, eps=eps, alpha=alpha)
    return with_color(points.detach(), color)
