"""The benchmark's inputs: synthetic S3DIS-shaped rooms and the blocks an
attack or a training run takes from them, made from the seed on the host.

``make_room`` is a frozen copy of the port's ``data/synthetic.py:make_room``
(an office of floor, ceiling, four walls and furniture boxes, each class
painted its colour with noise, [x y z r g b label] rows); ``room_blocks``
of ``data/s3dis.py:WholeSceneBlocks.room_blocks``, the cutter the attack
driver reads blocks with (1 m windows at a 0.5 m stride, each window's
points shuffled and cut into blocks of ``block_points``, the last padded
with repeats; channels: block-centred xy, z | rgb / 255 | xyz over the
room's extent). ``make_pool`` reads a workload's ``pool`` entry.
"""

from __future__ import annotations

import numpy as np

# S3DIS's class order
LABELS = {c: i for i, c in enumerate((
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter"))}

COLORS = {
    "ceiling": (235, 235, 235),
    "floor": (90, 60, 20),
    "wall": (200, 180, 140),
    "table": (150, 20, 20),
    "chair": (20, 20, 150),
    "board": (20, 150, 20),
    "clutter": (120, 120, 120),
}


def _part(rng, name, n, xr, yr, zr):
    xyz = np.stack([rng.uniform(xr[0], xr[1], n), rng.uniform(yr[0], yr[1], n),
                    rng.uniform(zr[0], zr[1], n)], axis=1)
    rgb = np.clip(np.array(COLORS[name], np.float64) + rng.normal(0.0, 6.0, (n, 3)), 0.0, 255.0)
    return np.concatenate([xyz, rgb, np.full((n, 1), LABELS[name], np.float64)], axis=1)


def make_room(n: int, rng: np.random.Generator, size=(4.0, 4.0, 2.8)) -> np.ndarray:
    """One room of ``n`` points → [n, 7] rows [x y z r g b label]."""
    W, D, H = size
    counts = {"ceiling": int(0.25 * n), "floor": int(0.25 * n), "wall": int(0.25 * n),
              "table": int(0.10 * n), "chair": int(0.08 * n), "board": int(0.04 * n)}
    counts["clutter"] = n - sum(counts.values())
    parts = [_part(rng, "ceiling", counts["ceiling"], (0, W), (0, D), (H - 0.04, H)),
             _part(rng, "floor", counts["floor"], (0, W), (0, D), (0, 0.04))]
    nw = counts["wall"]
    quarters = [nw // 4] * 3 + [nw - 3 * (nw // 4)]
    walls = [((0, W), (0, 0.04)), ((0, W), (D - 0.04, D)),
             ((0, 0.04), (0, D)), ((W - 0.04, W), (0, D))]
    for q, (xr, yr) in zip(quarters, walls):
        parts.append(_part(rng, "wall", q, xr, yr, (0.0, H)))
    tx, ty = rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2)
    parts.append(_part(rng, "table", counts["table"], (tx, tx + 1.2), (ty, ty + 0.8), (0.68, 0.76)))
    cx, cy = rng.uniform(2.4, 2.8), rng.uniform(2.2, 2.6)
    parts.append(_part(rng, "chair", counts["chair"], (cx, cx + 0.5), (cy, cy + 0.5), (0.40, 0.50)))
    bx = rng.uniform(1.0, 2.0)
    parts.append(_part(rng, "board", counts["board"], (bx, bx + 1.4), (0.04, 0.08), (1.0, 2.0)))
    parts.append(_part(rng, "clutter", counts["clutter"], (0, W), (0, D), (0, H)))
    data = np.concatenate(parts, axis=0)
    data = data[rng.permutation(len(data))]
    data[:, 0:3] -= np.amin(data[:, 0:3], axis=0)
    return data


def room_blocks(room: np.ndarray, block_points: int, rng: np.random.Generator,
                stride: float = 0.5, block_size: float = 1.0, padding: float = 0.001):
    """A room's whole-scene blocks → (points [nb, P, 9] float32, labels
    [nb, P] int64)."""
    points, labels = room[:, :6], room[:, 6].astype(np.int64)
    coord_min, coord_max = np.amin(points[:, :3], axis=0), np.amax(points[:, :3], axis=0)
    grid_x = max(int(np.ceil((coord_max[0] - coord_min[0] - block_size) / stride) + 1), 1)
    grid_y = max(int(np.ceil((coord_max[1] - coord_min[1] - block_size) / stride) + 1), 1)
    data_l, label_l = [], []
    for iy in range(grid_y):
        for ix in range(grid_x):
            e_x = min(coord_min[0] + ix * stride + block_size, coord_max[0])
            s_x = e_x - block_size
            e_y = min(coord_min[1] + iy * stride + block_size, coord_max[1])
            s_y = e_y - block_size
            idx = np.where((points[:, 0] >= s_x - padding) & (points[:, 0] <= e_x + padding)
                           & (points[:, 1] >= s_y - padding) & (points[:, 1] <= e_y + padding))[0]
            if idx.size == 0:
                continue
            size = int(np.ceil(idx.size / block_points)) * block_points
            extra = rng.choice(idx, size - idx.size, replace=(size - idx.size) > idx.size)
            idx = np.concatenate([idx, extra])
            rng.shuffle(idx)
            batch = points[idx].copy()
            norm_xyz = batch[:, :3] / coord_max
            batch[:, 0] -= s_x + block_size / 2.0
            batch[:, 1] -= s_y + block_size / 2.0
            batch[:, 3:6] /= 255.0
            data_l.append(np.concatenate([batch, norm_xyz], axis=1))
            label_l.append(labels[idx])
    data = np.concatenate(data_l).reshape(-1, block_points, 9)
    return data.astype(np.float32), np.concatenate(label_l).reshape(-1, block_points)


def make_pool(pool: dict, batch: int, points: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``pool["batches"]`` batches of ``batch`` blocks of ``points`` points
    from rooms of ``pool["room_points"]`` points and ``pool["room_size"]``
    metres, in the order the cutter gives them; the same seed gives the
    same batches. With ``pool["rooms_seed"]`` the rooms come from that
    seed, the same blocks for every seed, and the seed deals them into
    batches in an order of its own: a cell whose cost follows the rooms'
    contents then does the same work on every seed.
    → [(points [B, P, 9] float32, labels [B, P] int64)]."""
    rng = np.random.default_rng([pool.get("rooms_seed", seed), 1])
    need = pool["batches"] * batch
    pts, labs = [], []
    while sum(len(p) for p in pts) < need:
        room = make_room(pool["room_points"], rng, tuple(pool["room_size"]))
        p, lab = room_blocks(room, points, rng)
        pts.append(p)
        labs.append(lab)
    pts, labs = np.concatenate(pts)[:need], np.concatenate(labs)[:need]
    if "rooms_seed" in pool:
        order = np.random.default_rng([seed, 3]).permutation(need)
        pts, labs = pts[order], labs[order]
    return [(np.ascontiguousarray(pts[i:i + batch]), np.ascontiguousarray(labs[i:i + batch]))
            for i in range(0, need, batch)]
