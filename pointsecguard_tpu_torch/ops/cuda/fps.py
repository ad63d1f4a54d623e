"""Farthest point sampling: CUDA kernel A and its plain PyTorch version.

Replaces ``pointsecguard_tpu/ops/pallas/fps.py:_fps_kernel`` (entry point
``fps_pallas``). The kernel (``csrc/fps.cu``) runs one CTA per cloud with
the cloud and its running min-distance in registers. It is bounded by
latency, not by bytes or operations: the npoint steps are a recurrence,
so what counts is the way from one step's distances to the next
centroid. The design keeps that way short: the argmax is two hardware
warp reductions on the distance's bits (a min-distance is ≥ 0, so they
order as a signed int; ties go to the lowest index), one barrier a step,
every warp reducing the per-warp partials itself, and the next centroid
read from a copy of the cloud in shared memory. Bounds: float32
[B, N, 3], 1 ≤ N ≤ 8192, npoint ≥ 1, start [B] on the same device.

``fps`` checks its arguments first, on any device; then it launches the
kernel for a CUDA tensor, and only a CPU tensor goes to ``fps_plain``.
"""

from __future__ import annotations

import torch

MAX_N = 8192
launches = 0  # kernel launches by ``fps``; never counts the plain version


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


def _check(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> None:
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
    _check(xyz, npoint, start)
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, start)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    B, N, _ = xyz.shape
    from pointsecguard_tpu_torch.ops.cuda import build

    lib = build.load_library()
    build.require_sm90(xyz.device)
    xyz = xyz.contiguous()
    # a start outside [0, N) is not read: the kernel writes -1 for that
    # cloud (checking here would cost a device-to-host sync per call)
    start = start.to(torch.int32).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    code = lib.psg_fps(xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                       B, N, npoint, stream)
    build.check(code, "psg_fps")
    global launches
    launches += 1
    return out
