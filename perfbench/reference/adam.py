"""Plain Adam (Kingma and Ba 2015; ``torch.optim.Adam`` without weight
decay): β 0.9 / 0.999, ε 1e-8 outside the root, bias-corrected moments."""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@torch.no_grad()
def update(mu: torch.Tensor, nu: torch.Tensor, t: int, g: torch.Tensor, lr: float):
    """Update ``t`` (from 1) of moments ``mu``, ``nu`` by gradient ``g``
    → (the new first moment, the new second moment, the step that is
    subtracted from the parameters)."""
    mu = torch.add(torch.mul(mu, B1), g, alpha=1.0 - B1)
    nu = torch.addcmul(torch.mul(nu, B2), g, g, value=1.0 - B2)
    c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    return mu, nu, lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS)

