"""Block sampling on the device (``cli.train --device_sampler``; port of
``pointsecguard_tpu/data/device_sampler.py``).

The rooms are staged on the card once, as one flat float32 tensor; each
training block is then drawn there, with its z-rotation, so that no batch
crosses from the host in the epoch. The host sampler
(``data.s3dis.S3DISBlockSampler``) stays the default, equal to the
reference's draws; this path is equal to it in distribution only:

- the room is drawn with probability ∝ its point count (iid draws, where
  the host walks a shuffled, size-proportional list of rooms);
- the block's centre is a uniformly drawn room point, retried ``tries``
  times (8; the host 100) until the 1 m × 1 m block holds more than
  ``min_points`` points, else the densest candidate;
- the block's points are drawn uniformly with replacement (the rank-th
  member of the block through the membership mask's prefix sum), or with
  ``replacement=False`` without it (the ``num_point`` largest Gumbel keys
  over the mask, a stable sort) where the block holds at least
  ``num_point`` points, as the host draws;
- the features are ``_nine_channel``'s (`S3DISDataLoader.py:66-75`), and
  the z-rotation is `provider.py:66-84`'s matrix on channels 0:3.

Every draw comes from one ``torch.Generator`` on the staged tensor's
device, in this order for a batch: the rooms [B], the candidate centres
[B, tries], the point draws [B, num_point], the Gumbel noise [B, num_max]
(``replacement=False`` only) and the angles [B] (``augment_z`` only). The
JAX sampler takes its uniform point draws and its Gumbel noise from one
key (`device_sampler.py:168, 222`); here they are two draws.

A block never gathers its room's whole window of ``num_max`` rows: the
membership test reads the window's xy only, and the P selected rows are
gathered at the end. A batch is drawn ``chunk`` blocks at a time, which
bounds the [chunk, tries, num_max] membership test.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class StagedRooms(NamedTuple):
    """The rooms on the device."""

    flat: torch.Tensor  # [N_total + num_max, 7] x y z r g b label, float32
    start: torch.Tensor  # [R] int64, each room's first row
    count: torch.Tensor  # [R] int64, each room's point count
    coord_max: torch.Tensor  # [R, 3] float32, each room's coordinate maxima
    prob: torch.Tensor  # [R] float32, the room draw's probabilities (∝ count)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


class BlockDraws(NamedTuple):
    """A batch's draws, in the order the sampler takes them from its
    generator: ``room`` [B] room indices; ``candidates`` [B, tries] point
    indices within the room (< its count); ``u`` [B, num_point] uniforms
    in [0, 1); ``gumbel`` [B, num_max] (None with replacement); ``angle``
    [B] in [0, 2π) (None without the rotation)."""

    room: torch.Tensor
    candidates: torch.Tensor
    u: torch.Tensor
    gumbel: torch.Tensor | None
    angle: torch.Tensor | None


def stage_rooms(rooms, device) -> tuple[StagedRooms, int]:
    """A ``RoomSet`` as one flat tensor on ``device``; returns ``(staged,
    num_max)``, ``num_max`` the largest room's count rounded up to 128 (the
    window every block reads, padded so that the last room's stays in
    bounds)."""
    counts = np.array([len(lab) for lab in rooms.labels], np.int64)
    num_max = -(-int(counts.max()) // 128) * 128
    flat = np.zeros((int(counts.sum()) + num_max, 7), np.float32)
    start = np.zeros(len(counts), np.int64)
    off = 0
    for i, (pts, lab) in enumerate(zip(rooms.points, rooms.labels)):
        start[i] = off
        flat[off : off + len(lab), :6] = pts
        flat[off : off + len(lab), 6] = lab
        off += len(lab)
    staged = StagedRooms(
        flat=torch.from_numpy(flat).to(device),
        start=torch.from_numpy(start).to(device),
        count=torch.from_numpy(counts).to(device),
        coord_max=torch.from_numpy(np.stack(rooms.coord_max).astype(np.float32)).to(device),
        prob=torch.from_numpy((counts / counts.sum()).astype(np.float32)).to(device),
    )
    return staged, num_max


def make_device_block_sampler(
    *,
    batch_size: int,
    num_point: int,
    num_max: int,
    block_size: float = 1.0,
    min_points: int = 1024,
    tries: int = 8,
    augment_z: bool = True,
    replacement: bool = True,
    stage1_mode: str = "auto",
    chunk: int = 8,
) -> Callable:
    """Build ``sample(staged, generator=None, draws=None) → (points
    [B, P, 9] float32, labels [B, P] int64)`` on ``staged``'s device.

    ``draws`` (a ``BlockDraws``) replaces the generator's, so that a test
    can feed the JAX sampler's own; ``sample.draw(staged, generator)``
    takes a batch's draws as ``sample`` would. ``stage1_mode`` is the first stage of
    the rank search over the [C = num_max / 128, 128] chunked mask: a
    dense [P, C] compare (``dense``; ``auto`` for C ≤ 1024) or a second
    level of 128-chunk groups (``super``); both give the same indices."""
    if num_max % 128:
        raise ValueError(f"num_max={num_max} must be a multiple of 128 "
                         "(stage_rooms rounds it up)")
    if stage1_mode not in ("auto", "dense", "super"):
        raise ValueError(f"stage1_mode {stage1_mode!r}")
    half = block_size / 2.0
    C = num_max // 128
    dense = stage1_mode == "dense" or (stage1_mode == "auto" and C <= 1024)
    lanes_on: dict = {}  # arange(num_max) on each device it is asked for

    def draw(staged: StagedRooms, generator) -> BlockDraws:
        dev = staged.flat.device
        kw = dict(generator=generator, device=dev)
        room = torch.multinomial(staged.prob, batch_size, replacement=True,
                                 generator=generator)
        cnt = staged.count[room]
        cand = torch.rand((batch_size, tries), **kw)
        cand = torch.minimum((cand * cnt[:, None]).long(), cnt[:, None] - 1)
        u = torch.rand((batch_size, num_point), **kw)
        gumbel = None
        if not replacement:
            e = torch.rand((batch_size, num_max), **kw)
            gumbel = -torch.log(-torch.log(e.clamp_(min=torch.finfo(e.dtype).tiny)))
        angle = torch.rand(batch_size, **kw) * (2 * math.pi) if augment_z else None
        return BlockDraws(room, cand, u, gumbel, angle)

    def rank_positions(m: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
        """The position of each ``ranks`` [b, P]-th member (1-based) of the
        masks ``m`` [b, num_max] (JAX `device_sampler.py:160-213`)."""
        b = m.shape[0]
        m2 = m.reshape(b, C, 128)
        chunk_cum = torch.cumsum(m2.sum(dim=2, dtype=torch.int32), dim=1,
                                 dtype=torch.int32)  # [b, C]
        if dense:
            below = chunk_cum[:, None, :] < ranks[:, :, None]  # [b, P, C]
            idx_chunk = below.sum(dim=2)
            prev = torch.where(below, chunk_cum[:, None, :], 0).amax(dim=2)
        else:
            C2 = -(-C // 128)
            pad = chunk_cum[:, -1:].expand(b, C2 * 128 - C)
            ccp = torch.cat([chunk_cum, pad], dim=1).reshape(b, C2, 128)
            super_cum = ccp[:, :, -1]  # [b, C2]
            below_s = super_cum[:, None, :] < ranks[:, :, None]  # [b, P, C2]
            idx_super = below_s.sum(dim=2)
            prev_super = torch.where(below_s, super_cum[:, None, :], 0).amax(dim=2)
            row = torch.gather(ccp, 1, idx_super[..., None].expand(-1, -1, 128))  # [b, P, 128]
            below_r = row < ranks[:, :, None]
            idx_chunk = idx_super * 128 + below_r.sum(dim=2)
            prev = torch.maximum(torch.where(below_r, row, 0).amax(dim=2), prev_super)
        rows_m = torch.gather(m2, 1, idx_chunk[..., None].expand(-1, -1, 128))  # [b, P, 128]
        row_cum = torch.cumsum(rows_m.to(torch.int32), dim=2, dtype=torch.int32)
        local = torch.argmax((row_cum >= (ranks - prev)[:, :, None]).to(torch.int32), dim=2)
        return idx_chunk * 128 + local

    def sample_chunk(staged: StagedRooms, d: BlockDraws):
        room, cand = d.room, d.candidates
        b = room.shape[0]
        start, cnt = staged.start[room], staged.count[room]
        lanes = lanes_on.get(start.device)
        if lanes is None:
            lanes = lanes_on[start.device] = torch.arange(num_max, device=start.device)
        xy = staged.flat[start[:, None] + lanes, :2]  # the window's xy only: [b, num_max, 2]
        valid = lanes < cnt[:, None]
        centers = staged.flat[start[:, None] + cand, :2]  # [b, T, 2]
        lo, hi = centers - half, centers + half
        inb = ((xy[:, None, :, 0] >= lo[..., 0, None]) & (xy[:, None, :, 0] <= hi[..., 0, None])
               & (xy[:, None, :, 1] >= lo[..., 1, None]) & (xy[:, None, :, 1] <= hi[..., 1, None])
               & valid[:, None, :])  # [b, T, num_max]
        del xy
        counts = inb.sum(dim=2)  # [b, T]
        eligible = counts > min_points
        t_star = torch.where(eligible.any(dim=1), torch.argmax(eligible.to(torch.int32), dim=1),
                             torch.argmax(counts, dim=1))
        pick = torch.arange(b, device=room.device)
        m = inb[pick, t_star]  # [b, num_max]
        del inb
        cnt_in = counts[pick, t_star]
        ranks = torch.minimum((d.u * cnt_in[:, None].to(torch.float32)).to(torch.int32),
                              (cnt_in[:, None] - 1).to(torch.int32)) + 1
        idx = rank_positions(m, ranks)
        if d.gumbel is not None:
            # the num_point largest keys, equal keys in index order (as
            # lax.top_k takes them): float32 draws tie in a block of tens
            # of thousands of points, and torch.topk orders ties as it likes
            g = torch.where(m, d.gumbel, -torch.inf)
            idx_wo = torch.sort(g, dim=1, descending=True, stable=True).indices[:, :num_point]
            idx = torch.where((cnt_in >= num_point)[:, None], idx_wo, idx)
        rows = staged.flat[start[:, None] + idx]  # [b, P, 7]
        center = centers[pick, t_star]  # [b, 2]
        cmax = staged.coord_max[room]  # [b, 3]
        feats = torch.cat([rows[..., 0:1] - center[:, None, 0:1],
                           rows[..., 1:2] - center[:, None, 1:2],
                           rows[..., 2:3],
                           rows[..., 3:6] / 255.0,
                           rows[..., :3] / cmax[:, None, :]], dim=2)
        if d.angle is not None:
            c, s = torch.cos(d.angle), torch.sin(d.angle)
            zero, one = torch.zeros_like(c), torch.ones_like(c)
            rot = torch.stack([torch.stack([c, s, zero], 1), torch.stack([-s, c, zero], 1),
                               torch.stack([zero, zero, one], 1)], 1)  # [b, 3, 3]
            feats = torch.cat([torch.bmm(feats[..., :3], rot), feats[..., 3:]], dim=2)
        return feats, rows[..., 6].long()

    def sample(staged: StagedRooms, generator: torch.Generator | None = None,
               draws: BlockDraws | None = None):
        d = draws if draws is not None else draw(staged, generator)
        parts = [sample_chunk(staged, BlockDraws(*(None if t is None else t[i : i + chunk]
                                                   for t in d)))
                 for i in range(0, d.room.shape[0], chunk)]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))

    sample.draw = draw
    return sample


def make_sampled_multi_train_step(step_fn: Callable, sample_fn: Callable,
                                  ctx=None) -> Callable:
    """``multi_step(state, staged, class_weights, lr, bn_momentum, k,
    generator) → losses [k]`` (JAX `device_sampler.py:260-323`): k steps of
    ``step_fn`` (a ``make_train_step``), each on a batch it samples with
    ``sample_fn`` from ``generator`` first, then the step's own draws.
    ``ctx``: a rank of a data-parallel run (``--devices N``), whose
    generator is seeded as every other rank's: ``sample_fn`` draws the
    global batch and the rank keeps its rows, so the ranks' slices make up
    the one-process batch."""

    def rows(t):
        if ctx is None or ctx.data_size == 1:
            return t
        b = t.shape[0] // ctx.data_size
        return t[ctx.data_rank * b : (ctx.data_rank + 1) * b]

    def multi_step(state, staged: StagedRooms, class_weights, lr, bn_momentum, k: int,
                   generator: torch.Generator):
        losses = []
        for _ in range(k):
            pts, labels = (rows(t) for t in sample_fn(staged, generator))
            losses.append(step_fn(state, pts, labels, class_weights, lr, bn_momentum,
                                  generator))
        return torch.stack(losses)

    return multi_step


def epoch_calls(n_samples: int, batch_size: int, steps_per_call: int) -> list[int]:
    """The steps of each call of a device-sampled epoch: ``ceil(n_samples /
    batch_size)`` steps (the host epoch's, its wrapped tail included) in
    calls of ``steps_per_call``, the remainder one step a call (JAX
    `train/loops.py:211-231, 576-588`)."""
    n_steps = max(-(-n_samples // batch_size), 1)
    full, rem = divmod(n_steps, steps_per_call)
    return [steps_per_call] * full + [1] * rem
