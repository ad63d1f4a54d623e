"""Plain layers over a flat state dict: a 1×1 convolution is a linear map
over the trailing feature axis (channels last), and batch normalisation
takes its statistics over every other axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def linear(x: torch.Tensor, state: dict, name: str) -> torch.Tensor:
    return F.linear(x, state[name + ".weight"], state.get(name + ".bias"))


def batch_norm(x: torch.Tensor, state: dict, name: str, stats: dict | None) -> torch.Tensor:
    """Evaluation (``stats`` None): the running statistics. Training: the
    batch's mean and biased variance; ``stats[name]`` then receives the
    mean and the unbiased variance, the running statistics at keep 0.
    Normalised as (x − mean) · (1 / √(var + ε)) · scale + bias."""
    if stats is None:
        mean, var = state[name + ".mean"], state[name + ".var"]
    else:
        axes = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, unbiased=False)
        stats[name] = (mean.detach(), (var * (n / max(n - 1, 1))).detach())
    inv = torch.reciprocal(torch.sqrt(var + BN_EPS))
    return (x - mean) * inv * state[name + ".scale"] + state[name + ".bias"]


def set_statistics(state: dict, stats: dict) -> None:
    """Write ``batch_norm``'s collected statistics into ``state`` as its
    running mean and variance."""
    for name, (mean, var) in stats.items():
        state[name + ".mean"].copy_(mean)
        state[name + ".var"].copy_(var)


def log_softmax_ce(outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-entry cross-entropy of ``outputs`` taken as logits."""
    lp = torch.log_softmax(outputs, dim=-1)
    return -torch.gather(lp, -1, labels.long()[..., None])[..., 0]
