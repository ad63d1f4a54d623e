"""The collectives that the port's ranks run (port of
``pointsecguard_tpu/parallel/spmd_ops.py``).

JAX runs the Pallas kNN under ``shard_map``: every device all-gathers the
candidate xyz over the ``points`` axis and runs the kernel on its own
query shard, the O(N²/P) distance work split for O(N) traffic, and the
indices come out bit-identical to the unsharded op (same candidates, same
order, same kernel). ``knn_points_sharded`` is that body on a rank: the
candidates are gathered over the points group in rank order, and
``ops.knn`` (``psg::knn`` on a card) runs on the rank's query shard.

Everything else that GSPMD derived is written out here:

- ``all_reduce``: a sum over a group with autograd (BatchNorm's global
  statistics).
- ``all_gather``: an all-gather with autograd whose backward sums the
  ranks' gradients and keeps the rank's part (an all-reduce, which gloo
  takes for CPU and CUDA tensors alike; ``torch.distributed.nn``'s own
  gather needs reduce-scatter or all-to-all there).
- ``gather_for_loss``: the gather of a head every rank scores with the same
  global loss; its backward keeps only the rank's part, so the gradient
  that reaches the rank's activations is that of the global loss through
  its own rows (and, where the tensor is replicated over the points group,
  on one rank of the group only).
- ``points_sharded_forward``: a semseg model's forward on a points shard,
  as GSPMD runs a call it cannot partition: the group's shards are
  all-gathered, the model runs on the whole cloud, and the rank keeps its
  shard of the per-point output.
- ``dp_map``: a host predict function over a batch, each rank taking its
  rows, the outputs gathered back on every rank; ``gather_rows`` the same
  for device tensors (the attack drivers' per-cloud results, the
  benchmark harness's per-point arrays), and ``sum_rows`` the sum over
  the data slices (pooled counts: a trajectory's steps, a sweep's probe).

The pointwise layers are not split along the points axis: under
``--shard_points`` every rank of a points group runs the whole cloud's
MLPs, and only the kNN work is divided.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.parallel.mesh import RankContext


def _group_rank(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _part(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    _, size = _group_rank(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        rank, size = _group_rank(ctx.group)
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return _part(g, ctx.dim, rank, size).contiguous(), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``t`` over ``group``, with autograd (each
    rank's gradient is the sum of the ranks' gradients of the sum)."""
    return _AllReduce.apply(t, group)


class _LossGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, keep):
        ctx.group, ctx.dim, ctx.keep = group, dim, keep
        return _gather(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        rank, size = _group_rank(ctx.group)
        g = _part(grad, ctx.dim, rank, size).contiguous()
        return (g if ctx.keep else torch.zeros_like(g)), None, None, None


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim`` in rank
    order; the gradient of each part is the sum of the ranks' gradients of
    it. ``group=None`` (an axis of size 1): ``t`` itself."""
    if group is None:
        return t
    if not t.requires_grad:
        return _gather(t, group, dim)
    return _AllGather.apply(t, group, dim)


def gather_for_loss(t: torch.Tensor, ctx: RankContext | None, *,
                    per_point: bool = False) -> torch.Tensor:
    """``t`` of every rank assembled into the global batch, for a loss that
    every rank computes alike: the data slices along axis 0, and with
    ``per_point`` (a head sharded along the points axis) the points shards
    along axis 1 first. The backward hands each rank the gradient of its own
    part; a tensor replicated over the points group (not ``per_point``)
    passes it on its group's first rank only, so that no row counts twice."""
    if ctx is None:
        return t
    keep = per_point or ctx.points_rank == 0
    if per_point and ctx.points_group is not None:
        t = _LossGather.apply(t, ctx.points_group, 1, True)
    if ctx.data_group is not None:
        t = _LossGather.apply(t, ctx.data_group, 0, keep)
    elif not keep:
        t = t.detach()
    return t


def points_shard(t: torch.Tensor, ctx: RankContext, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous shard of ``t``'s points axis."""
    return _part(t, dim, ctx.points_rank, ctx.points_size).contiguous()


def sp_shapes_ok(ctx: RankContext | None, *arrays) -> bool:
    """True when there are ranks and every array's axis 1 divides their
    points axis (of size 1 too) — the precondition of
    ``knn_points_sharded``. The arrays are the rank's data slice with the
    whole points axis, so the batch axis needs no check here:
    ``make_batch_put`` already held it to the data axis. Callers fall back
    to the plain op when this fails."""
    if ctx is None:
        return False
    return all(a.dim() >= 2 and a.shape[1] % ctx.points_size == 0 for a in arrays)


def knn_points_sharded(query: torch.Tensor, points: torch.Tensor, k: int,
                       ctx: RankContext) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the query and candidate points axes split over the
    points group of ``ctx``.

    Args:
      query: [B, S, D] query positions, points: [B, N, D] candidates, the
        whole points axis of the rank's data slice (every rank of the
        points group holds the same).
      k: neighbour count, ≤ N.

    Returns:
      (sq_dists, idx) [B, S / P, k] of this rank's query shard, with
      GLOBAL indices (into the whole candidate axis): the rows of
      ``ops.knn(query, points, k)`` that the shard covers, bit-identical.
    """
    if k > points.shape[1]:
        raise ValueError(f"k={k} > N={points.shape[1]}")
    if not sp_shapes_ok(ctx, query, points):
        raise ValueError(
            f"shapes {tuple(query.shape)}/{tuple(points.shape)} do not divide "
            f"the points axis ({1 if ctx is None else ctx.points_size}); use ops.knn instead")
    # candidates are contiguous shards in rank order, so the gather rebuilds
    # the original point order and the local kNN's indices are global
    full = all_gather(points_shard(points.detach(), ctx), ctx.points_group, dim=1)
    return ops.knn(points_shard(query.detach(), ctx), full, k)


def points_sharded_forward(fn: Callable, ctx: RankContext) -> Callable:
    """``fn(points, *args) → per-point output [B, N, ...]`` as a function of
    this rank's points shard [B, N / P, C]: the shards of the points group
    are all-gathered with autograd, ``fn`` runs on the whole cloud, and the
    rank's shard of the output is returned. The gradient that reaches the
    shard is the sum over the group's ranks of their shards' gradients."""

    def sharded(points_part: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        whole = all_gather(points_part, ctx.points_group, dim=1)
        return points_shard(fn(whole, *args, **kwargs), ctx)

    return sharded


def gather_rows(t: torch.Tensor, ctx: RankContext | None) -> torch.Tensor:
    """The data slices' ``t`` (rows of a batch) gathered into the whole
    batch on every rank, without autograd; ``t`` itself without a data
    axis."""
    if ctx is None or ctx.data_group is None:
        return t
    return _gather(t, ctx.data_group, 0)


def sum_rows(t: torch.Tensor, ctx: RankContext | None) -> torch.Tensor:
    """The sum of the data slices' ``t`` over the data group, on every
    rank, without autograd (a new tensor); ``t`` itself without a data
    axis."""
    if ctx is None or ctx.data_group is None:
        return t
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=ctx.data_group)
    return t


def dp_map(fn: Callable, ctx: RankContext | None) -> Callable:
    """``fn(batch numpy [B, ...]) → numpy [B, ...]`` run data-parallel: the
    batch is padded to a multiple of the data axis by repeating its last
    row, each rank runs ``fn`` on its rows (the ranks of a points group on
    the same rows), and the outputs are all-gathered, so every rank returns
    what one process would. Every rank must call it with the same batch."""
    if ctx is None or ctx.data_group is None:
        return fn

    def mapped(batch: np.ndarray) -> np.ndarray:
        B, n = len(batch), ctx.data_size
        b = -(-B // n)
        if b * n > B:
            batch = np.concatenate([batch, np.repeat(batch[-1:], b * n - B, axis=0)])
        local = fn(batch[ctx.data_rank * b : (ctx.data_rank + 1) * b])
        whole = _gather(torch.from_numpy(np.ascontiguousarray(local)).to(ctx.device),
                        ctx.data_group, 0)
        return whole.cpu().numpy()[:B]

    return mapped


def all_reduce_sum(t: torch.Tensor, ctx: RankContext | None) -> torch.Tensor:
    """Sum ``t`` over every rank of the mesh in place (the data-parallel
    gradient)."""
    if ctx is not None and ctx.world_size > 1:
        dist.all_reduce(t, group=ctx.group)
    return t


def sync_batchnorm(model: torch.nn.Module, ctx: RankContext | None) -> torch.nn.Module:
    """Make every ``models.common.BatchNorm`` of ``model`` take its
    training statistics over the global batch (the data group of
    ``ctx``); returns the model."""
    from pointsecguard_tpu_torch.models.common import BatchNorm

    group = None if ctx is None else ctx.data_group
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group
    return model
