"""Shared building blocks (port of ``pointsecguard_tpu/models/common.py``).

A 1×1 convolution over points is a Linear over the trailing feature axis
(channels-last [B, ..., C] everywhere, as in the JAX package).

Mixed precision: every module takes a ``dtype``. ``None`` keeps the
float32 path (the inputs' own dtype, so float64 runs stay float64);
``torch.bfloat16`` runs every Linear in bf16 through ``linear`` while
the parameters stay float32. BatchNorm statistics, softmaxes, logits,
losses and all neighbour search stay float32, so the neighbourhoods are
the same in both precisions and only the MLP arithmetic is rounded.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from pointsecguard_tpu_torch.utils.runtime import batch_draw


class BatchNorm(nn.Module):
    """Batch normalisation over all non-feature axes, torch-style stats.

    ``momentum`` is a call argument and is the *keep* fraction
    (``1 - m_torch``; torch's default 0.1 ⇒ 0.9), so the reference's
    per-epoch momentum annealing needs no module rebuild. Buffers
    ``mean``/``var`` and parameters ``scale``/``bias`` carry the JAX
    package's leaf names.

    ``group`` (set by ``parallel.sync_batchnorm``): the process group of a
    data-parallel run's data axis. In training the statistics are then
    those of the global batch, as GSPMD takes them: the per-channel sum and
    the sum of squared deviations from the global mean are all-reduced over
    the group (with autograd), over a count of every rank's equal slice.
    The running variance stays unbiased over that count. Evaluation reads
    the running statistics, as without a group.
    """

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.group = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        # statistics in float32 at least (bf16 ones would corrupt the
        # running statistics); the output in the caller's dtype
        out_dtype = x.dtype
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            axes = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            if self.group is None:
                mean = torch.mean(x, dim=axes)
                var = torch.var(x, dim=axes, unbiased=False)
            else:
                mean, var, n = _global_moments(x, axes, n, self.group)
            with torch.no_grad():  # torch stores the unbiased variance
                unbiased = var * (n / max(n - 1, 1))
                self.mean.mul_(momentum).add_((1.0 - momentum) * mean)
                self.var.mul_(momentum).add_((1.0 - momentum) * unbiased)
        else:
            mean, var = self.mean, self.var
        # written as the JAX package writes it: reciprocal of the sqrt
        inv = torch.reciprocal(torch.sqrt(var + self.epsilon))
        return ((x - mean) * inv * self.scale + self.bias).to(out_dtype)


def _global_moments(x: torch.Tensor, axes: tuple, n: int, group):
    """(mean, biased variance, count) over ``axes`` of the global batch
    whose equal slices the ranks of ``group`` hold: two passes, as
    ``torch.var`` takes them, each an all-reduce with autograd."""
    from pointsecguard_tpu_torch.parallel.spmd_ops import all_reduce

    n = n * dist.get_world_size(group)
    mean = all_reduce(torch.sum(x, dim=axes), group=group) / n
    dev = x - mean
    var = all_reduce(torch.sum(dev * dev, dim=axes), group=group) / n
    return mean, var, n


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype | None = None
           ) -> torch.Tensor:
    """``layer(x)``, or with a ``dtype`` flax's mixed-precision Dense: x,
    the weight and the bias cast to ``dtype``, the product rounded to it,
    then the bias added in it. Two steps, not one ``F.linear``: cuBLAS
    would add the bias inside the GEMM in float32 and round once, where
    JAX rounds twice."""
    if dtype is None:
        return layer(x)
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).t())
    return y if layer.bias is None else y + layer.bias.to(dtype)


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor | None,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout keeping the entries where ``mask`` is true, or
    where a draw of ``generator`` (on ``x``'s device; torch's default
    generator without one) is ≥ ``rate``; a rank of a data-parallel run
    keeps its rows of the global batch's draw (``batch_draw``)."""
    if mask is None:
        mask = batch_draw(lambda shape: torch.rand(shape, generator=generator,
                                                   device=x.device), x.shape) >= rate
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return nn.functional.leaky_relu(x, negative_slope=0.2)


_ACTS = {"relu": torch.relu, "leaky_relu": leaky_relu, "none": lambda x: x}


class PointConv(nn.Module):
    """Per-point Linear + BatchNorm + activation (a 1×1 conv).

    ``act`` is "relu" (PointNet++), "leaky_relu" (slope 0.2, RandLA-Net)
    or "none"; the defaults keep PointNet++'s module and numbers."""

    def __init__(self, in_features: int, features: int, *, act: str = "relu",
                 bn_epsilon: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.act = _ACTS[act]
        self.dtype = dtype
        self.dense = nn.Linear(in_features, features)
        self.bn = BatchNorm(features, epsilon=bn_epsilon)

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        return self.act(self.bn(linear(x, self.dense, self.dtype), momentum))


class PointMLP(nn.Module):
    """Stack of PointConv layers (a shared per-point MLP)."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 dtype: torch.dtype | None = None):
        super().__init__()
        widths = (in_features, *features)
        self.convs = nn.ModuleList(
            PointConv(a, b, dtype=dtype) for a, b in zip(widths[:-1], widths[1:])
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
