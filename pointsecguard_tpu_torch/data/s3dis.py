"""S3DIS rooms, the training block sampler and whole-scene blocks, numpy
only (port of ``pointsecguard_tpu/data/s3dis.py:25-367``), with the
collection of raw ``Area_*/room/Annotations`` trees into room files.

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
_CLASS2LABEL = {c: i for i, c in enumerate(S3DIS_CLASSES)}


def collect_room(anno_path: str) -> np.ndarray:
    """Aggregate one room's per-instance annotation files into an Nx7
    xyzrgbl array (`indoor3d_util.py:36-77`). Unknown classes map to
    clutter; xyz is shifted to put the minimum corner at the origin."""
    import glob

    points_list = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in _CLASS2LABEL:
            cls = "clutter"
        pts = np.loadtxt(f)
        labels = np.full((pts.shape[0], 1), _CLASS2LABEL[cls], np.float64)
        points_list.append(np.concatenate([pts, labels], axis=1))
    data = np.concatenate(points_list, axis=0)
    data[:, 0:3] -= np.amin(data, axis=0)[0:3]
    return data


def collect_s3dis(raw_root: str, out_root: str) -> list[str]:
    """Batch collection driver (`collect_indoor3d_data.py`): every
    Area_*/room/Annotations directory → ``<out_root>/<area>_<room>.npy``."""
    os.makedirs(out_root, exist_ok=True)
    written = []
    for area in sorted(os.listdir(raw_root)):
        area_dir = os.path.join(raw_root, area)
        if not area.startswith("Area_") or not os.path.isdir(area_dir):
            continue
        for room in sorted(os.listdir(area_dir)):
            anno = os.path.join(area_dir, room, "Annotations")
            if not os.path.isdir(anno):
                continue
            out = os.path.join(out_root, f"{area}_{room}.npy")
            np.save(out, collect_room(anno))
            written.append(out)
    return written


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


def _nine_channel(
    selected: np.ndarray, center_xy: np.ndarray, coord_max: np.ndarray
) -> np.ndarray:
    """Build the 9-channel feature layout (`S3DISDataLoader.py:66-75`):
    [x−cx, y−cy, z, r/255, g/255, b/255, x/max_x, y/max_y, z/max_z]."""
    n = selected.shape[0]
    out = np.zeros((n, 9), np.float32)
    out[:, 6] = selected[:, 0] / coord_max[0]
    out[:, 7] = selected[:, 1] / coord_max[1]
    out[:, 8] = selected[:, 2] / coord_max[2]
    out[:, 0] = selected[:, 0] - center_xy[0]
    out[:, 1] = selected[:, 1] - center_xy[1]
    out[:, 2] = selected[:, 2]
    out[:, 3:6] = selected[:, 3:6] / 255.0
    return out


class _BlockIndex:
    """Uniform 2-D grid over a room's xy plane for fast block queries.

    ``query(lo, hi)`` returns exactly what the brute-force
    ``np.where((x>=lo0)&(x<=hi0)&(y>=lo1)&(y<=hi1))[0]`` returns —
    same inclusive bounds, same ascending index order — so the sampler's
    downstream ``rng.choice`` draws are bit-identical. Only the cost
    changes: candidates come from the ≤3×3 covering grid cells instead
    of a full-room mask (the mask was ~80% of per-block sample time on
    a 262k-point room)."""

    def __init__(self, xy: np.ndarray, cell: float):
        # contiguous copy: strided views make every vector op here ~10×
        # slower; comparisons stay in the ORIGINAL dtype so boundary
        # semantics match the brute-force mask exactly
        self.xy = np.ascontiguousarray(xy)
        self.cell = cell
        self.origin = self.xy.min(axis=0)
        # bin with the SAME f64 divide-then-floor the query uses: an f32
        # reciprocal-multiply here can bin an exact-boundary point one
        # cell below the query's floor-division, dropping it from the
        # candidate set (IEEE divide + floor are monotone, so construct
        # and query agree for any cell size, not just powers of two)
        ij = np.floor(
            (self.xy.astype(np.float64) - self.origin.astype(np.float64))
            / cell
        ).astype(np.int64)
        self.nx = int(ij[:, 0].max()) + 1
        self.ny = int(ij[:, 1].max()) + 1
        flat = ij[:, 0] * self.ny + ij[:, 1]
        # non-stable sort: query() re-sorts its final result anyway
        self.order = np.argsort(flat)
        counts = np.bincount(flat, minlength=self.nx * self.ny)
        self.starts = np.concatenate([[0], np.cumsum(counts)])

    def query(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        # f64 divide-then-floor, matching __init__'s binning (a float32
        # subtraction here could disagree with the construction bins on
        # exact-boundary points)
        ox, oy, c = float(self.origin[0]), float(self.origin[1]), self.cell
        i0 = max(int(np.floor((float(lo[0]) - ox) / c)), 0)
        j0 = max(int(np.floor((float(lo[1]) - oy) / c)), 0)
        i1 = min(int(np.floor((float(hi[0]) - ox) / c)), self.nx - 1)
        j1 = min(int(np.floor((float(hi[1]) - oy) / c)), self.ny - 1)
        if i1 < i0 or j1 < j0:
            return np.empty(0, np.int64)
        # each i-row's j-range is one contiguous slice of the sorted order
        chunks = [
            self.order[self.starts[i * self.ny + j0]:
                       self.starts[i * self.ny + j1 + 1]]
            for i in range(i0, i1 + 1)
        ]
        cand = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        sub = self.xy[cand]
        m = (
            (sub[:, 0] >= lo[0]) & (sub[:, 0] <= hi[0])
            & (sub[:, 1] >= lo[1]) & (sub[:, 1] <= hi[1])
        )
        return np.sort(cand[m])


class S3DISBlockSampler:
    """Random 1 m × 1 m block sampler for training
    (`S3DISDataLoader.py:45-77`). ``sample(rng)`` → (points [P,9], labels [P])."""

    def __init__(
        self,
        rooms: RoomSet,
        num_point: int = 4096,
        block_size: float = 1.0,
        sample_rate: float = 1.0,
        min_points: int = 1024,
        max_tries: int = 100,
    ):
        self.rooms = rooms
        self.num_point = num_point
        self.block_size = block_size
        self.min_points = min_points
        self.max_tries = max_tries
        self._grids: dict[int, _BlockIndex] = {}  # lazy per-room indexes
        n_all = np.array([len(l) for l in rooms.labels], np.float64)
        prob = n_all / n_all.sum()
        # floor at one draw: a dataset smaller than num_point/sample_rate
        # points would otherwise produce an EMPTY sampler and the train
        # loop's first next() would die with a bare StopIteration
        num_iter = max(int(n_all.sum() * sample_rate / num_point), 1)
        idxs = []
        for i in range(len(rooms.names)):
            idxs.extend([i] * int(round(prob[i] * num_iter)))
        if not idxs:
            idxs = [int(np.argmax(n_all))]
        self.room_idxs = np.array(idxs, np.int64)

    def __len__(self):
        return len(self.room_idxs)

    def sample(self, rng: np.random.Generator, idx: int | None = None):
        room = (
            self.room_idxs[idx % len(self.room_idxs)]
            if idx is not None
            else rng.integers(len(self.rooms.names))
        )
        points = self.rooms.points[room]
        labels = self.rooms.labels[room]
        half = self.block_size / 2.0
        grid = self._grids.get(room)
        if grid is None:
            grid = self._grids[room] = _BlockIndex(points[:, :2], half)
        # the reference loops unconditionally until a block has >1024 points
        # (`S3DISDataLoader.py:52-60`); bound the retries so sparse rooms
        # (tests, tiny scans) fall back to the densest block found
        best = None
        for _ in range(self.max_tries):
            center = points[rng.integers(len(points))][:3]
            lo, hi = center[:2] - half, center[:2] + half
            in_block = grid.query(lo, hi)
            if best is None or in_block.size > best[0].size:
                best = (in_block, center)
            if in_block.size > self.min_points:
                break
        in_block, center = best
        replace = in_block.size < self.num_point
        sel = rng.choice(in_block, self.num_point, replace=replace)
        # fancy indexing already yields a fresh array — no .copy()
        feats = _nine_channel(
            points[sel], center[:2], self.rooms.coord_max[room]
        )
        return feats, labels[sel]

    def batches(
        self, rng: np.random.Generator, batch_size: int, *, keep_tail: bool = True
    ):
        """Yield (points [B,P,9], labels [B,P]) for one epoch.

        The reference DataLoader keeps the final partial batch
        (``drop_last`` defaults False, `train_semseg.py:117-123`); a
        partial batch would force a second XLA program here, so the tail
        instead wraps around to the start of the shuffled order — every
        sample is seen at least once per epoch, ≤ B−1 seen twice.
        """
        order = rng.permutation(len(self))
        if keep_tail and len(order) % batch_size:
            order = np.resize(
                order, len(order) + batch_size - len(order) % batch_size
            )
        for start in range(0, len(order) - batch_size + 1, batch_size):
            feats, labs = zip(
                *(self.sample(rng, int(i)) for i in order[start : start + batch_size])
            )
            yield np.stack(feats), np.stack(labs)


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
