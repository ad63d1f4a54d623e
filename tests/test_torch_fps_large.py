"""Farthest point sampling above 8192 points (the cluster and streaming
kernels' range in ``csrc/fps.cu``), on the CPU against the JAX package.

The port's ``farthest_point_sample`` (``fps_plain`` for a CPU tensor)
equals JAX's ``lax.scan`` (``pointsecguard_tpu/ops/sampling.py``) index
for index at N = 8193, 10000 and 16384, and at the cluster kernel's
capacity and one point past it (npoint 64), from index 0 and from starts drawn
with numpy (passed to both as ``start_idx``); ``build_geometry_cls`` of
10,000-point shapes (ModelNet40's resampled size) equals JAX's, centres
and groups; the argument check takes N up to ``MAX_N`` = 2²² and refuses
one more, on a meta tensor, before any dispatch; ``opcheck`` of
``psg::fps`` at N = 10000. The kernel itself runs only on a card
(``chip_smoke.py`` phase 82).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.models.pointnet2_cls import build_geometry_cls as jax_geometry_cls
from pointsecguard_tpu.ops.sampling import farthest_point_sample as jax_fps
from pointsecguard_tpu_torch.models import build_geometry_cls
from pointsecguard_tpu_torch.ops import farthest_point_sample
from pointsecguard_tpu_torch.ops.cuda import fps


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cloud(n: int, seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).random((b, n, 3), dtype=np.float32)


@pytest.mark.parametrize("start", ["zero", "drawn"])
@pytest.mark.parametrize("n,npoint", [(8193, 256), (10000, 512), (16384, 1024),
                                     (fps.CLUSTER_MAX_N, 64), (fps.CLUSTER_MAX_N + 1, 64)])
def test_fps_equals_jax_above_8192(n, npoint, start):
    xyz = _cloud(n, n)
    starts = (np.zeros(2, np.int32) if start == "zero"
              else np.random.default_rng(n + 1).integers(0, n, 2).astype(np.int32))
    want = np.asarray(jax_fps(jnp.asarray(xyz), npoint, start_idx=jnp.asarray(starts)))
    before = fps.launches
    got = farthest_point_sample(torch.from_numpy(xyz), npoint,
                                start_idx=torch.from_numpy(starts))
    assert fps.launches == before  # a CPU tensor: the plain version
    assert got.dtype == torch.int32 and got.shape == (2, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0].numpy() == starts).all()


def test_build_geometry_cls_at_10000_points():
    """Two shapes of 10,000 points: FPS 10000 → 512 → 128, the ball query
    [2, 512, 10000] k = 32 (the wide-row bottom-k's route) and [2, 128,
    512] k = 64, all equal to JAX's."""
    xyz = _cloud(10000, 7)
    want = jax_geometry_cls(jnp.asarray(xyz))["sa"]
    got = build_geometry_cls(torch.from_numpy(xyz))["sa"]
    for (jc, jidx), (pc, pidx) in zip(want, got):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    assert got[0][1].shape == (2, 512, 32) and got[1][1].shape == (2, 128, 64)


def test_check_args_takes_up_to_max_n_on_a_meta_tensor():
    """N = 2²² passes the check, 2²² + 1 is refused naming the ceiling;
    meta tensors hold no data, so the shapes cost nothing."""
    assert fps.MAX_N == 1 << 22
    start = torch.zeros(1, dtype=torch.int32, device="meta")
    fps.check_args(torch.empty((1, fps.MAX_N, 3), device="meta"), 512, start)
    with pytest.raises(ValueError, match=f"N={fps.MAX_N + 1} outside the kernel's 1..{fps.MAX_N}"):
        fps.check_args(torch.empty((1, fps.MAX_N + 1, 3), device="meta"), 512, start)


def test_opcheck_fps_at_10000_points():
    xyz = torch.from_numpy(_cloud(10000, 3, b=1))
    torch.library.opcheck(torch.ops.psg.fps.default,
                          (xyz, 64, torch.tensor([17], dtype=torch.int32)))
