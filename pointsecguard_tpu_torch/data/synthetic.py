"""Synthetic class-coloured S3DIS-style rooms, numpy only (port of
``pointsecguard_tpu/data/synthetic.py:60-160``).

A copy of the JAX package's fixture generator with the same RNG calls, so
the same seed writes array-equal rooms: geometry loosely shaped like an
S3DIS office (floor/ceiling planes, four walls, a few furniture boxes),
each class painted a fixed colour, written as collected ``Area_X_*.npy``
rooms (Nx7 [x y z r g b label], minimum corner at the origin) that
``RoomSet.load`` and ``WholeSceneBlocks`` read.
"""

from __future__ import annotations

import os

import numpy as np

from pointsecguard_tpu_torch.data.s3dis import S3DIS_CLASSES

_LBL = {c: i for i, c in enumerate(S3DIS_CLASSES)}

# Fixed, well-separated base colors per class (0..255). Color ↦ label is
# (noisily) injective, which is what makes the fixture easy to learn.
_CLASS_COLOR = {
    "ceiling": (235, 235, 235),
    "floor": (90, 60, 20),
    "wall": (200, 180, 140),
    "table": (150, 20, 20),
    "chair": (20, 20, 150),
    "board": (20, 150, 20),
    "clutter": (120, 120, 120),
}


def _paint(rng: np.random.Generator, name: str, n: int) -> np.ndarray:
    base = np.array(_CLASS_COLOR[name], np.float64)
    rgb = base + rng.normal(0.0, 6.0, (n, 3))
    return np.clip(rgb, 0.0, 255.0)


def _part(rng, name, n, xr, yr, zr):
    """n points uniform in the box xr×yr×zr, painted + labeled as name."""
    xyz = np.stack(
        [
            rng.uniform(xr[0], xr[1], n),
            rng.uniform(yr[0], yr[1], n),
            rng.uniform(zr[0], zr[1], n),
        ],
        axis=1,
    )
    lab = np.full((n, 1), _LBL[name], np.float64)
    return np.concatenate([xyz, _paint(rng, name, n), lab], axis=1)


def make_room(
    points_per_room: int = 6000,
    *,
    rng: np.random.Generator,
    size: tuple[float, float, float] = (4.0, 4.0, 2.8),
) -> np.ndarray:
    """One synthetic office room → Nx7 [x y z r g b label].

    Class shares: ceiling/floor/wall ≈ 25 % each (majority-class floor of
    the fixture is therefore ~0.25), remainder split over table, chair,
    board, and clutter.
    """
    W, D, H = size
    n = points_per_room
    counts = {
        "ceiling": int(0.25 * n),
        "floor": int(0.25 * n),
        "wall": int(0.25 * n),
        "table": int(0.10 * n),
        "chair": int(0.08 * n),
        "board": int(0.04 * n),
    }
    counts["clutter"] = n - sum(counts.values())

    parts = [
        _part(rng, "ceiling", counts["ceiling"], (0, W), (0, D), (H - 0.04, H)),
        _part(rng, "floor", counts["floor"], (0, W), (0, D), (0, 0.04)),
    ]
    # four walls, points split evenly
    nw = counts["wall"]
    quarters = [nw // 4] * 3 + [nw - 3 * (nw // 4)]
    walls = [
        ((0, W), (0, 0.04)), ((0, W), (D - 0.04, D)),
        ((0, 0.04), (0, D)), ((W - 0.04, W), (0, D)),
    ]
    for q, (xr, yr) in zip(quarters, walls):
        parts.append(_part(rng, "wall", q, xr, yr, (0.0, H)))
    # furniture at fixed-ish spots (jittered per room)
    tx, ty = rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2)
    parts.append(
        _part(rng, "table", counts["table"],
              (tx, tx + 1.2), (ty, ty + 0.8), (0.68, 0.76))
    )
    cx, cy = rng.uniform(2.4, 2.8), rng.uniform(2.2, 2.6)
    parts.append(
        _part(rng, "chair", counts["chair"],
              (cx, cx + 0.5), (cy, cy + 0.5), (0.40, 0.50))
    )
    bx = rng.uniform(1.0, 2.0)
    parts.append(
        _part(rng, "board", counts["board"],
              (bx, bx + 1.4), (0.04, 0.08), (1.0, 2.0))
    )
    parts.append(
        _part(rng, "clutter", counts["clutter"], (0, W), (0, D), (0, H))
    )

    data = np.concatenate(parts, axis=0)
    data = data[rng.permutation(len(data))]
    data[:, 0:3] -= np.amin(data[:, 0:3], axis=0)  # collect_room origin shift
    return data


def make_synthetic_rooms(
    out_dir: str,
    *,
    points_per_room: int | tuple[int, int] = 6000,
    seed: int = 0,
    train_areas: tuple[int, ...] = (1,),
    test_area: int = 5,
    rooms_per_area: int = 1,
) -> list[str]:
    """Write the fixture set under ``out_dir`` in collected-`.npy` layout:
    one room per (area, index) — by default ``Area_1_synth_1.npy`` (train)
    and ``Area_5_synth_1.npy`` (test), the minimal 2-room train/eval split.
    Returns the written paths.

    ``points_per_room`` may be an ``(lo, hi)`` tuple: per-room counts are
    then drawn log-uniformly from [lo, hi] (the real S3DIS room-size
    distribution is heavy-tailed — collected rooms run ~0.1M to ~2.5M
    points, `data_prepare_s3dis.py:29-72` operates on exactly these), and
    the room's FLOOR AREA scales with the count at ~25k points/m² so
    block densities stay realistic (a 1 m² block of a 2.5M-point room
    holds tens of thousands of points, like real S3DIS)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = []
    for area in (*train_areas, test_area):
        for i in range(rooms_per_area):
            if isinstance(points_per_room, tuple):
                lo, hi = points_per_room
                n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
                side = float(np.clip(np.sqrt(n / 25_000.0), 4.0, 14.0))
                size = (side, side, 2.8)
            else:
                n = points_per_room
                size = (4.0, 4.0, 2.8)
            path = os.path.join(out_dir, f"Area_{area}_synth_{i + 1}.npy")
            np.save(path, make_room(n, rng=rng, size=size))
            written.append(path)
    return written
