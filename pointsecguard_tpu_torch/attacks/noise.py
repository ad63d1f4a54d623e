"""The random-noise control of equal norm (port of
``pointsecguard_tpu/attacks/noise.py``).

The reference reports, next to every attack, the accuracy under uniform
random colour noise scaled to the L2 norm of the adversarial perturbation
(`RandLA-Net/ares/ares/attack/NUattack.py:236-254`,
`ResGCN/sem_seg_dense/test.py:47-109`): it separates "the model is fragile
to any colour change" from "the attack found a damaging direction".
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.utils.runtime import batch_draw



def equal_norm_color_noise(
    points: torch.Tensor,
    l2_norm: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    channels: tuple[int, int] = (3, 6),
    clip: tuple[float, float] | None = (0.0, 1.0),
    centered: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Add uniform colour noise rescaled to a per-cloud L2 norm.

    Args:
      points: [B, N, C] clean inputs.
      l2_norm: [B] target norms (e.g. the attack's measured distortion).
      mask: optional [B, N] bool — the noise lands on these points only.
      channels: the perturbed channel slice (the colours; the object
        tasks pass (0, 3), the coordinates, with no clip).
      clip: the perturbed channels' box (None: no clip).
      centered: draw U[-1, 1) instead of the references' positive U[0, 1)
        (`NUattack.py:236` np.random.uniform(0, 1), `test.py:77`
        uniform_(0, 1)).
      noise: the draw itself, [B, N, hi − lo] in the range above (the
        parity tests pass ``jax.random.uniform``'s); else it is drawn from
        ``generator`` on the generator's device.

    Returns:
      [B, N, C] points whose colours moved by exactly
      ``l2_norm`` per cloud before the clip (a cloud whose draw is all
      zero stays unmoved: the norm is floored at 1e-12).
    """
    lo, hi = channels
    color0 = points[..., lo:hi]
    if noise is None:
        if generator is None:
            raise ValueError("equal_norm_color_noise needs noise= or generator=")
        noise = batch_draw(lambda shape: torch.rand(shape, generator=generator,
                                                    device=generator.device), color0.shape)
        if centered:
            noise = 2.0 * noise - 1.0
    noise = noise.to(device=points.device, dtype=points.dtype)
    if mask is not None:
        noise = noise * mask.to(noise.dtype)[..., None]
    flat = noise.reshape(points.shape[0], -1)
    unit = flat / torch.clamp(torch.linalg.norm(flat, dim=1, keepdim=True), min=1e-12)
    out = color0 + (unit * l2_norm.to(unit)[:, None]).reshape(color0.shape)
    if clip is not None:
        out = torch.clamp(out, clip[0], clip[1])
    return torch.cat([points[..., :lo], out, points[..., hi:]], dim=-1)
