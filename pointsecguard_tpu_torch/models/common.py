"""Shared building blocks (port of ``pointsecguard_tpu/models/common.py``).

A 1×1 convolution over points is a Linear over the trailing feature axis
(channels-last [B, ..., C] everywhere, as in the JAX package).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Batch normalisation over all non-feature axes, torch-style stats.

    ``momentum`` is a call argument and is the *keep* fraction
    (``1 - m_torch``; torch's default 0.1 ⇒ 0.9), so the reference's
    per-epoch momentum annealing needs no module rebuild. Buffers
    ``mean``/``var`` and parameters ``scale``/``bias`` carry the JAX
    package's leaf names.
    """

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.var(x, dim=axes, unbiased=False)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():  # torch stores the unbiased variance
                unbiased = var * (n / max(n - 1, 1))
                self.mean.mul_(momentum).add_((1.0 - momentum) * mean)
                self.var.mul_(momentum).add_((1.0 - momentum) * unbiased)
        else:
            mean, var = self.mean, self.var
        # written as the JAX package writes it: reciprocal of the sqrt
        inv = torch.reciprocal(torch.sqrt(var + self.epsilon))
        return (x - mean) * inv * self.scale + self.bias


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor | None,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout keeping the entries where ``mask`` is true, or
    where a draw of ``generator`` (on ``x``'s device; torch's default
    generator without one) is ≥ ``rate``."""
    if mask is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return nn.functional.leaky_relu(x, negative_slope=0.2)


_ACTS = {"relu": torch.relu, "leaky_relu": leaky_relu, "none": lambda x: x}


class PointConv(nn.Module):
    """Per-point Linear + BatchNorm + activation (a 1×1 conv).

    ``act`` is "relu" (PointNet++), "leaky_relu" (slope 0.2, RandLA-Net)
    or "none"; the defaults keep PointNet++'s module and numbers."""

    def __init__(self, in_features: int, features: int, *, act: str = "relu",
                 bn_epsilon: float = 1e-5):
        super().__init__()
        self.act = _ACTS[act]
        self.dense = nn.Linear(in_features, features)
        self.bn = BatchNorm(features, epsilon=bn_epsilon)

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        return self.act(self.bn(self.dense(x), momentum))


class PointMLP(nn.Module):
    """Stack of PointConv layers (a shared per-point MLP)."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        widths = (in_features, *features)
        self.convs = nn.ModuleList(
            PointConv(a, b) for a, b in zip(widths[:-1], widths[1:])
        )

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x, momentum)
        return x


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to ±2


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator, *,
                    scale: float = 1.0) -> None:
    """Initialise ``model`` as flax initialises the JAX model: every
    Linear weight from a normal of variance scale / fan_in truncated at
    two standard deviations (``lecun_normal``; ResGCN's ``kaiming_normal``
    is scale 2), every Linear bias zero;
    BatchNorm keeps scale 1, bias 0, mean 0, var 1. ``nn.Linear``'s own
    default (uniform in ±1/sqrt(fan_in), a third of that variance, and a
    random bias) trains to another band. ``generator`` is a CPU
    generator: the draw does not depend on the device the model runs on."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            u = torch.rand(mod.weight.shape, generator=generator, dtype=torch.float64)
            unit = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
            std = math.sqrt(scale / mod.in_features) / _TRUNC_STD
            mod.weight.copy_((unit * std).to(mod.weight))
            if mod.bias is not None:
                mod.bias.zero_()
