"""Input-transformation defenses (port of
``pointsecguard_tpu/attacks/defenses.py:23-229,243-252``): on the colour
channels the ones ``cli.attack`` reaches, on the coordinates SOR and SRS,
which ``cli.attack_object`` deploys.

The reference's ares defense module (`RandLA-Net/ares/ares/defense/`:
bit-depth reduction, randomization, JPEG, the input-transformation
decorator) on point batches. Each composes with any model closure through
``apply_color_defense``, so a defended model is attacked and evaluated by
the same engines (BPDA-style: a non-differentiable transform passes the
gradient straight through).

Randomness: ``jax.random`` cannot be matched bit for bit, so each random
transform takes its draw as an argument (``noise=``, ``choice=``) or a
``torch.Generator`` that makes it, and ``randomized_defense_wraps`` takes a
``draw(shape, j)`` that gives its fixed draws.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pointsecguard_tpu_torch.attacks.common import COLOR_SLICE, set_color
from pointsecguard_tpu_torch.ops import knn
from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel


def randomized_defense_wraps(
    transform: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    draw: Callable[[tuple, int], torch.Tensor],
    eot: int = 1,
) -> tuple[Callable, Callable]:
    """``(eval_wrap, attack_wrap)`` for a randomized input-transform
    defense: the contract both attack loops share.

    ``transform(points, d)`` applies the defense with the draw ``d``;
    ``draw(shape, j)`` gives the draw for points of ``shape``: ``j = 0`` the
    deployed one, ``j = 1 … eot`` the EoT ones. Each draw is made once per
    shape and device and reused on every call, as the JAX package reuses
    its one key and its ``eot`` split keys.

    ``eval_wrap`` wraps a model closure with the DEPLOYED defense (the one
    fixed draw); every reported metric comes from it. ``attack_wrap`` is
    what the attacker differentiates: the same closure when ``eot <= 1``,
    else the mean output over the ``eot`` fixed draws (EoT, Athalye et al.
    2018), so that the gradient integrates over the defense's randomness.
    """
    cache: dict = {}

    def draws(points):
        key = (tuple(points.shape), points.device)
        if key not in cache:
            cache[key] = [draw(key[0], j).to(points.device)
                          for j in range(1 + (eot if eot > 1 else 0))]
        return cache[key]

    def eval_wrap(f):
        return lambda p: f(transform(p, draws(p)[0]))

    if eot <= 1:
        return eval_wrap, eval_wrap

    def attack_wrap(f):
        def defended(p):
            outs = [f(transform(p, d)) for d in draws(p)[1:]]
            return torch.stack(outs).mean(dim=0)

        return defended

    return eval_wrap, attack_wrap


def seeded_draws(sample: Callable[[tuple, torch.Generator], torch.Tensor],
                 seed: int) -> Callable[[tuple, int], torch.Tensor]:
    """A ``draw(shape, j)`` for ``randomized_defense_wraps``: draw ``j``
    from a CPU generator seeded from ``seed`` (``j = 0``: ``seed`` itself;
    EoT draws: seeds taken from that generator, as ``jax.random.split``
    derives keys). On the CPU, so the card and the CPU see the same draws."""
    def draw(shape, j):
        if j == 0:
            s = seed
        else:
            gen = torch.Generator().manual_seed(seed)
            s = int(torch.randint(0, 2**62, (j,), generator=gen)[-1])
        return sample(shape, torch.Generator().manual_seed(s))

    return draw


def bit_depth_reduction(points: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Quantize colours to 2^bits levels (`defense/bit_depth_reduction.py`).
    Straight-through gradient (the identity)."""
    levels = 2.0**bits - 1.0
    color = points[..., COLOR_SLICE]
    # divided by a tensor on the colour's device: CUDA divides by a Python
    # scalar as a multiplication by its reciprocal, one ulp off the CPU's
    quant = torch.round(color * levels) / color.new_tensor(levels)
    return set_color(points, color + (quant - color).detach())


def random_color_jitter(points: torch.Tensor, sigma: float = 0.02, *,
                        noise: torch.Tensor | None = None,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Gaussian colour noise, clipped to [0, 1] (the point-cloud analogue of
    ares' randomization). ``noise`` is the standard normal draw [B, N, 3];
    else it is drawn from ``generator``."""
    color = points[..., COLOR_SLICE]
    if noise is None:
        if generator is None:
            raise ValueError("random_color_jitter needs noise= or generator=")
        noise = torch.randn(color.shape, generator=generator, device=generator.device)
    noise = noise.to(device=color.device, dtype=color.dtype)
    return set_color(points, torch.clamp(color + sigma * noise, 0.0, 1.0))


def _dct_matrix(n: int) -> torch.Tensor:
    """Orthonormal DCT-II basis [n, n] (rows = frequencies), in float32 as
    the JAX package builds it, on the CPU (so every device gets the same
    constants)."""
    k = torch.arange(n, dtype=torch.float32)
    basis = torch.cos(math.pi * (2.0 * k[None, :] + 1.0) * k[:, None] / (2 * n))
    basis = basis * (2.0 / n) ** 0.5
    basis[0] = basis[0] / torch.sqrt(torch.tensor(2.0))
    return basis


def _jpeg_steps(quality: int, block: int) -> torch.Tensor:
    """The quantization step of each frequency [block], on the CPU: the
    libjpeg quality curve (S = 5000/q below 50, else 200 − 2q) over a base
    table that grows with frequency like the zigzag-ordered luminance table
    (16 … ~120 in 0–255 units), in [0, 1] sample units and scaled by the
    orthonormal coefficients' √(block/2) amplitude factor."""
    q = float(quality)
    scale = (5000.0 / q if q < 50 else 200.0 - 2.0 * q) / 100.0
    freq = torch.arange(block, dtype=torch.float32)
    step = (16.0 + 4.0 * freq) * scale / 255.0
    return torch.clamp(step * (block / 2.0) ** 0.5, min=1e-6)


def jpeg_color_compression(points: torch.Tensor, quality: int = 95,
                           block: int = 64) -> torch.Tensor:
    """Frequency-domain colour quantization, the point-cloud analogue of
    ares' JPEG defense (`defense/jpeg_compression.py:8-30`): a blockwise
    orthonormal DCT-II of ``block`` points along the point axis per colour
    channel, a quantization step that grows with frequency and follows
    libjpeg's quality curve (S = 5000/q below 50, else 200 − 2q), the
    inverse, a [0, 1] clip. Straight-through gradient, as the reference's
    `jpeg_compress_grad` identity (`jpeg_compression.py:25-26`)."""
    if not 1 <= quality <= 100:
        # libjpeg's range: q = 0 divides by zero, q > 100 a negative scale
        raise ValueError(f"jpeg quality must be in [1, 100], got {quality}")
    color = points[..., COLOR_SLICE]  # [B, N, 3]
    B, N, C = color.shape
    pad = (-N) % block
    x = torch.nn.functional.pad(color, (0, 0, 0, pad))
    nb = x.shape[1] // block
    x = x.reshape(B, nb, block, C)
    D = _dct_matrix(block).to(color.device, color.dtype)
    coeffs = torch.einsum("fk,bnkc->bnfc", D, x)
    step = _jpeg_steps(quality, block).to(color.device, color.dtype)[None, None, :, None]
    quant = torch.round(coeffs / step) * step
    y = torch.einsum("fk,bnfc->bnkc", D, quant)  # x = Dᵀ·coeffs
    y = torch.clamp(y.reshape(B, nb * block, C)[:, :N], 0.0, 1.0)
    return set_color(points, color + (y - color).detach())


def self_knn(points: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distances, indices) [B, N, k] of the k nearest spatial
    neighbours of each point, self included, nearest first. k ≤ 48 takes
    the D = 3 kNN kernel (its plain version on a CPU tensor); larger k the
    square-distance route with a stable sort per block of queries, as
    ``dense_knn_graph`` routes it, so that no k raises from inside an
    attack. No gradient."""
    xyz = points[..., :3].detach().float().contiguous()
    strategy = "auto" if k <= knn_kernel.MAX_K else "pallas"
    return knn(xyz, xyz, k, strategy=strategy, tile=knn_kernel.PLAIN_TILE)


def resample_neighbors(points: torch.Tensor, k: int) -> torch.Tensor:
    """The indices [B, N, k] int32 of ``self_knn``."""
    return self_knn(points, k)[1]


def random_color_resample(points: torch.Tensor, k: int = 8, *,
                          choice: torch.Tensor | None = None,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """Each point takes the colour of one of its ``k`` nearest spatial
    neighbours (self included), picked uniformly: the point-cloud analogue
    of ares' randomization-by-resizing (`defense/randomization.py`).
    Positions and labels stay, so the per-point protocols stay aligned.

    ``choice`` is the pick, [B, N, 1] integers in [0, min(k, N)); else it
    is drawn from ``generator``. The transform is an exact gather, so the
    attacker's gradient is the true one (a scatter of the cotangent over the
    picked neighbours). The kNN is on xyz, which colour attacks never
    move."""
    color = points[..., COLOR_SLICE]
    B, N = points.shape[:2]
    k_eff = min(k, N)
    idx = resample_neighbors(points, k_eff)  # [B, N, k]
    if choice is None:
        if generator is None:
            raise ValueError("random_color_resample needs choice= or generator=")
        choice = torch.randint(0, k_eff, (B, N, 1), generator=generator,
                               device=generator.device)
    picked = torch.gather(idx.long(), 2, choice.to(idx.device).long())  # [B, N, 1]
    resampled = torch.gather(color, 1, picked.expand(-1, -1, color.shape[-1]))
    return set_color(points, resampled)


def statistical_outlier_removal(points: torch.Tensor, k: int = 10,
                                alpha: float = 1.1) -> torch.Tensor:
    """SOR, the coordinate-domain defense of DUP-Net (Zhou et al. 2019,
    §3.1; JAX `attacks/defenses.py:167-206`): a point is an outlier when
    its mean distance to its k nearest neighbours exceeds μ + α·σ of the
    cloud's (σ the population deviation).

    Shapes stay fixed: each outlier takes the whole row of the first inlier
    in its neighbour list (an inlier itself: the self point leads the
    list, up to distance-0 ties, which first occurrence breaks), which max
    pooling treats as a removal. The transform is a gather, so an attacker
    gets the true gradient; the masks come from distances, with none."""
    B, N = points.shape[:2]
    k_eff = min(k + 1, N)  # + 1: a point is the nearest neighbour of itself
    d2, idx = self_knn(points, k_eff)
    mean_d = torch.sqrt(torch.clamp(d2[..., 1:], min=0.0)).mean(dim=2)  # [B, N]
    mu = mean_d.mean(dim=1, keepdim=True)
    sd = mean_d.std(dim=1, keepdim=True, correction=0)
    inlier = mean_d <= mu + alpha * sd
    flags = torch.gather(inlier, 1, idx.long().reshape(B, -1)).reshape(idx.shape)
    # argmax over integers returns the first maximum: the first inlier
    first = torch.argmax(flags.to(torch.int8), dim=2, keepdim=True)
    donor = torch.gather(idx.long(), 2, first)[..., 0]
    own = torch.arange(N, device=points.device).expand(B, N)
    donor = torch.where(flags.any(dim=2), donor, own)
    return torch.gather(points, 1, donor[..., None].expand(-1, -1, points.shape[-1]))


def srs_donors(shape: tuple, ratio: float, generator: torch.Generator) -> torch.Tensor:
    """SRS's draw for clouds of ``shape`` [B, N, ...]: per cloud a random
    permutation keeps its first round(ratio·N) points, each dropped slot
    takes a uniformly chosen kept point → donor indices [B, N] int64 (a
    kept point its own)."""
    B, N = shape[:2]
    n_keep = max(1, int(round(ratio * N)))
    donors = []
    for _ in range(B):
        kept = torch.randperm(N, generator=generator)[:n_keep]
        fill = kept[torch.randint(0, n_keep, (N,), generator=generator)]
        keep = torch.zeros(N, dtype=torch.bool)
        keep[kept] = True
        donors.append(torch.where(keep, torch.arange(N), fill))
    return torch.stack(donors)


def simple_random_subsample(points: torch.Tensor, ratio: float = 0.875, *,
                            donor: torch.Tensor | None = None,
                            generator: torch.Generator | None = None) -> torch.Tensor:
    """SRS, the randomized coordinate-domain defense (JAX
    `attacks/defenses.py:209-229`): keep a random ``ratio`` of the points;
    each dropped slot takes the whole row of a kept point (duplicates are
    removals under max pooling). ``donor`` [B, N] is the draw
    (``srs_donors``, or JAX's permutation in the parity tests); else it
    is drawn from the CPU ``generator``."""
    if donor is None:
        if generator is None:
            raise ValueError("simple_random_subsample needs donor= or generator=")
        donor = srs_donors(points.shape, ratio, generator)
    donor = donor.to(points.device).long()
    return torch.gather(points, 1, donor[..., None].expand(-1, -1, points.shape[-1]))


def apply_color_defense(outputs_fn: Callable, defense: Callable, *defense_args) -> Callable:
    """Wrap a model closure with an input defense
    (`defense/input_transformation.py` decorator pattern)."""

    def defended(points):
        return outputs_fn(defense(points, *defense_args))

    return defended
