"""Farthest point sampling: CUDA kernel A and its plain PyTorch version.

Replaces ``pointsecguard_tpu/ops/pallas/fps.py:67`` ``fps_pallas``
(``_fps_kernel``). ``csrc/fps.cu`` holds three kernels with one argmax and
one rounding, and ``psg_fps_route(N)`` there says which takes a cloud:

- ``fps_kernel``, N ≤ ``REGISTER_MAX_N`` = 8192: one CTA a cloud, its
  points and running min-distances in registers, the cloud also in shared
  memory for the next centroid's coordinates;
- ``fps_cluster_kernel``, up to ``CLUSTER_MAX_N`` = 16 · 8192 = 131,072
  (``PORTABLE_CLUSTER_MAX_N`` = 8 · 8192 where the card cannot place a
  cluster of 16): a cloud split over the CTAs of a thread-block cluster,
  each slice in its CTA's registers; each step the CTAs' winners travel
  with their coordinates through distributed shared memory, counted on
  each CTA's mbarrier;
- ``fps_stream_kernel``, beyond, up to ``MAX_N`` = 2²² (the wide-row
  bottom-k's ceiling): one CTA of 1024 threads a cloud, the cloud and its
  min-distances streamed from a device-memory workspace that the op
  allocates (``psg_fps_workspace_floats``).

Each is bounded by latency, not by bytes or operations: the npoint steps
are a recurrence, so what counts is the way from one step's distances to
the next centroid. The argmax is two hardware warp reductions on the
distance's bits (a min-distance is ≥ 0, so they order as a signed int;
ties go to the lowest index), one barrier a step (the cluster kernel: the
CTA's, then a wait on its mbarrier), every warp reducing the partials
itself. Up to 8192 points one CTA's pass is short and the cluster's
exchange would cost more than it saves; above, one CTA's pass would stream from L2 and a cluster
keeps the cloud in registers; beyond the cluster's registers only the
stream is left. Bounds: float32 [B, N, 3], 1 ≤ N ≤ ``MAX_N``, npoint ≥ 1,
start [B] on the same device.

``fps`` checks its arguments first, on any device, then calls the custom
op ``psg::fps`` (``library.py``): the dispatcher launches a kernel for a
CUDA tensor, and only a CPU tensor goes to ``fps_plain``. The indices
carry no gradient (JAX's ``stop_gradient``).
"""

from __future__ import annotations

import torch

MAX_N = 1 << 22
REGISTER_MAX_N = 8192  # fps_kernel's last N
CLUSTER_MAX_N = 16 * REGISTER_MAX_N  # fps_cluster_kernel's, at 16 CTAs a cluster
PORTABLE_CLUSTER_MAX_N = 8 * REGISTER_MAX_N  # its, where the card places 8 at most
launches = 0  # kernel launches by ``psg::fps`` (all three); never the plain version or a trace
# of those, the cluster kernel's and the streaming kernel's (``csrc/fps.cu``'s
# ``psg_fps_route`` says which clouds each takes)
cluster_launches = 0
stream_launches = 0


def fps_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """The scan of ``pointsecguard_tpu/ops/sampling.py:59-69`` as a loop.

    xyz [B, N, 3] float32, start [B] int → [B, npoint] int32."""
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(B, device=xyz.device)
    min_dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = start.to(device=xyz.device, dtype=torch.long)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for j in range(npoint):
        out[:, j] = far
        if j == npoint - 1:
            break
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        min_dist = torch.minimum(min_dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(min_dist, dim=-1)  # first occurrence on ties
    return out


def check_args(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> None:
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps: want float32 [B, N, 3], got {xyz.dtype} "
                         f"{tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"fps: N={N} outside the kernel's 1..{MAX_N}")
    if npoint < 1:
        raise ValueError(f"fps: npoint={npoint} < 1")
    if start.shape != (B,) or start.device != xyz.device:
        raise ValueError("fps: start must be [B] on the same device")


def fps(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """Farthest point sampling → [B, npoint] int32 (see module doc)."""
    check_args(xyz, npoint, start)
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fps: unsupported device {xyz.device}")
    return torch.ops.psg.fps(xyz.detach(), npoint, start)
