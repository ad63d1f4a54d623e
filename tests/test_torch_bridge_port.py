"""The port needs no counterpart of ``pointsecguard_tpu/models/torch_bridge.py``:
its attack engines take any torch callable. Shown here on the CPU: the
port's ``pgd_color_attack`` drives a foreign ``nn.Module`` in the
reference's segmentation convention (``wrap_reference_semseg``'s:
channels-first [B, C, N] in, ``(log_probs [B, N, K], trans_feat)`` out,
evaluation mode) through a closure that transposes its input, and reaches
the adversary that the JAX package's engine reaches through the bridge.

The module is the tiny pair of ``tests/test_torch_bridge.py``: a
two-layer point classifier with numpy-seeded float32 weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.attacks.pgd import PGDConfig as JaxPGDConfig
from pointsecguard_tpu.attacks.pgd import pgd_color_attack as jax_pgd
from pointsecguard_tpu.models.torch_bridge import wrap_reference_semseg
from pointsecguard_tpu_torch.attacks.pgd import PGDConfig, pgd_color_attack


class ChannelsFirstNet(torch.nn.Module):
    """The tiny pair's classifier as a reference-convention module."""

    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(0)
        self.w1 = torch.nn.Parameter(torch.from_numpy(rng.randn(9, 16).astype(np.float32) * 0.5))
        self.w2 = torch.nn.Parameter(torch.from_numpy(rng.randn(16, 13).astype(np.float32) * 0.5))

    def forward(self, x):  # [B, C, N]
        return torch.tanh(x.transpose(1, 2) @ self.w1) @ self.w2, None


@pytest.mark.parametrize("iters", [1, 5])
def test_port_attack_drives_a_foreign_channels_first_module(iters):
    rng = np.random.RandomState(4)
    pts = rng.rand(2, 64, 9).astype(np.float32)
    labels = rng.randint(0, 13, (2, 64))

    want = jax_pgd(wrap_reference_semseg(ChannelsFirstNet()), jnp.asarray(pts),
                   jnp.asarray(labels), JaxPGDConfig(eps=0.1, alpha=0.05, iters=iters))

    module = ChannelsFirstNet().eval().requires_grad_(False)
    got = pgd_color_attack(lambda p: module(p.transpose(1, 2))[0], torch.from_numpy(pts),
                           torch.from_numpy(labels), PGDConfig(eps=0.1, alpha=0.05, iters=iters))

    np.testing.assert_allclose(got.points_adv.numpy(), np.asarray(want.points_adv), atol=1e-5)
    assert float(got.acc) == pytest.approx(float(want.acc), abs=1e-6)
    np.testing.assert_allclose(got.l2_dist.numpy(), np.asarray(want.l2_dist), atol=1e-5)
    delta = got.points_adv.numpy() - pts
    assert np.abs(delta[..., 3:6]).max() > 0  # the colours moved, and only they
    np.testing.assert_array_equal(delta[..., :3], 0)
    np.testing.assert_array_equal(delta[..., 6:], 0)
    assert not module.training
