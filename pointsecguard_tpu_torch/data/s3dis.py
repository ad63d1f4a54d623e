"""S3DIS rooms and whole-scene blocks, numpy only (port of
``pointsecguard_tpu/data/s3dis.py:73-113,285-367``).

A copy, not an import: the JAX package's ``__init__`` imports JAX, which
the machine with the card does not have. The code and its RNG calls are
the JAX package's, so the same seed gives array-equal blocks (a test
holds the two against each other).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# `PointNet/data_utils/meta/class_names.txt`
S3DIS_CLASSES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
)
NUM_CLASSES = len(S3DIS_CLASSES)


def inverse_cube_root_weights(label_hist: np.ndarray) -> np.ndarray:
    """(max_freq / freq)^(1/3) label weights (`S3DISDataLoader.py:33-35`)."""
    freq = label_hist.astype(np.float32)
    freq = freq / np.sum(freq)
    return np.power(np.amax(freq) / np.maximum(freq, 1e-12), 1.0 / 3.0)


@dataclass
class RoomSet:
    """In-memory room collection for one split."""

    names: list[str]
    points: list[np.ndarray]  # [N, 6] xyzrgb per room
    labels: list[np.ndarray]  # [N] per room
    coord_min: list[np.ndarray]
    coord_max: list[np.ndarray]
    label_weights: np.ndarray = field(default_factory=lambda: np.ones(NUM_CLASSES))

    @classmethod
    def load(cls, data_root: str, split: str = "train", test_area: int = 5):
        """Collected ``Area_*.npy`` rooms (Nx7 xyzrgbl) of one split."""
        rooms = sorted(
            r for r in os.listdir(data_root) if "Area_" in r and r.endswith(".npy")
        )
        tag = f"Area_{test_area}"
        if split == "train":
            rooms = [r for r in rooms if tag not in r]
        else:
            rooms = [r for r in rooms if tag in r]
        names, pts_l, lab_l, cmin, cmax = [], [], [], [], []
        hist = np.zeros(NUM_CLASSES)
        for r in rooms:
            data = np.load(os.path.join(data_root, r))
            pts, lab = data[:, :6], data[:, 6].astype(np.int64)
            h, _ = np.histogram(lab, range(NUM_CLASSES + 1))
            hist += h
            names.append(r)
            pts_l.append(pts)
            lab_l.append(lab)
            cmin.append(np.amin(pts[:, :3], axis=0))
            cmax.append(np.amax(pts[:, :3], axis=0))
        return cls(names, pts_l, lab_l, cmin, cmax, inverse_cube_root_weights(hist))


class WholeSceneBlocks:
    """Stride-0.5 sliding-window blocker over full rooms
    (`S3DISDataLoader.py:124-175`): every ``block_points``-point block of
    a room plus the original point indices for vote pooling."""

    def __init__(
        self,
        rooms: RoomSet,
        block_points: int = 4096,
        stride: float = 0.5,
        block_size: float = 1.0,
        padding: float = 0.001,
    ):
        self.rooms = rooms
        self.block_points = block_points
        self.stride = stride
        self.block_size = block_size
        self.padding = padding

    def __len__(self):
        return len(self.rooms.names)

    def room_blocks(self, index: int, rng: np.random.Generator):
        """→ (data [nb, P, 9], labels [nb, P], weights [nb, P],
        point_idx [nb, P]) for room ``index``."""
        points = self.rooms.points[index]
        labels = self.rooms.labels[index]
        coord_min = np.amin(points[:, :3], axis=0)
        coord_max = np.amax(points[:, :3], axis=0)
        bs, st = self.block_size, self.stride
        # one block still covers a room narrower than block_size − stride
        grid_x = max(
            int(np.ceil((coord_max[0] - coord_min[0] - bs) / st) + 1), 1
        )
        grid_y = max(
            int(np.ceil((coord_max[1] - coord_min[1] - bs) / st) + 1), 1
        )
        data_l, label_l, weight_l, index_l = [], [], [], []
        for iy in range(grid_y):
            for ix in range(grid_x):
                s_x = coord_min[0] + ix * st
                e_x = min(s_x + bs, coord_max[0])
                s_x = e_x - bs
                s_y = coord_min[1] + iy * st
                e_y = min(s_y + bs, coord_max[1])
                s_y = e_y - bs
                idx = np.where(
                    (points[:, 0] >= s_x - self.padding)
                    & (points[:, 0] <= e_x + self.padding)
                    & (points[:, 1] >= s_y - self.padding)
                    & (points[:, 1] <= e_y + self.padding)
                )[0]
                if idx.size == 0:
                    continue
                num_batch = int(np.ceil(idx.size / self.block_points))
                size = num_batch * self.block_points
                replace = (size - idx.size) > idx.size
                extra = rng.choice(idx, size - idx.size, replace=replace)
                idx = np.concatenate([idx, extra])
                rng.shuffle(idx)
                batch = points[idx].copy()
                norm_xyz = batch[:, :3] / coord_max
                batch[:, 0] -= s_x + bs / 2.0
                batch[:, 1] -= s_y + bs / 2.0
                batch[:, 3:6] /= 255.0
                data_l.append(np.concatenate([batch, norm_xyz], axis=1))
                lab = labels[idx]
                label_l.append(lab)
                weight_l.append(self.rooms.label_weights[lab])
                index_l.append(idx)
        data = np.concatenate(data_l).reshape(-1, self.block_points, 9)
        lab = np.concatenate(label_l).reshape(-1, self.block_points)
        w = np.concatenate(weight_l).reshape(-1, self.block_points)
        pidx = np.concatenate(index_l).reshape(-1, self.block_points)
        return (
            data.astype(np.float32),
            lab.astype(np.int32),
            w.astype(np.float32),
            pidx.astype(np.int64),
        )
