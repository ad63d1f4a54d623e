"""ModelNet classification dataset, numpy (a copy of
``pointsecguard_tpu/data/modelnet.py:27-209``: the parse cache, the first-N
load, the random-subset votes, tile padding, ``batches`` and the synthetic
fixture, with the same RNG calls, so that the same generator state gives
the same shapes and batches).

The on-disk format is the public ``modelnet40_normal_resampled``:

- ``modelnet{10,40}_shape_names.txt`` — one class name per line,
- ``modelnet{10,40}_{train,test}.txt`` — shape ids (``airplane_0001``),
- ``<class>/<shape_id>.txt`` — comma-separated ``x,y,z,nx,ny,nz`` rows.

Every sample is exactly ``num_point`` points (the first N of the
resampled file), xyz normalised into the unit sphere on the host;
batches are [B, N, 3|6] float32 and [B] int32.
"""

from __future__ import annotations

import os

import numpy as np


def pc_normalize(xyz: np.ndarray) -> np.ndarray:
    """Center to the centroid and scale into the unit sphere (the
    standard ModelNet normalization the cls models assume)."""
    centroid = xyz.mean(axis=0)
    out = xyz - centroid
    scale = np.sqrt((out**2).sum(axis=1)).max()
    return out / max(scale, 1e-12)


class ModelNetDataset:
    """Index-addressable ModelNet shapes with epoch batch iteration."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        *,
        num_point: int = 1024,
        num_category: int = 40,
        use_normals: bool = True,
        cache: bool = True,
    ):
        if split not in ("train", "test"):
            raise ValueError(f"split must be train|test, got {split!r}")
        self.root = root
        self.num_point = num_point
        self.use_normals = use_normals
        # parsed-file cache: text parsing dominates the host cost of an
        # epoch (np.loadtxt on a ~10k-row CSV per shape, per epoch) and
        # the upstream loader caches for the same reason. Full ModelNet40
        # raw arrays are ~2.4 GB; pass cache=False to trade the parse
        # cost back for the memory.
        self._cache: dict[int, np.ndarray] | None = {} if cache else None
        prefix = f"modelnet{num_category}"
        with open(os.path.join(root, f"{prefix}_shape_names.txt")) as f:
            self.class_names = [ln.strip() for ln in f if ln.strip()]
        self.num_classes = len(self.class_names)
        cls_of = {n: i for i, n in enumerate(self.class_names)}
        with open(os.path.join(root, f"{prefix}_{split}.txt")) as f:
            shape_ids = [ln.strip() for ln in f if ln.strip()]
        self.paths: list[str] = []
        self.labels = np.zeros(len(shape_ids), np.int32)
        for i, sid in enumerate(shape_ids):
            name = sid.rsplit("_", 1)[0]
            self.paths.append(os.path.join(root, name, f"{sid}.txt"))
            self.labels[i] = cls_of[name]

    def __len__(self) -> int:
        return len(self.paths)

    def _parse(self, i: int) -> np.ndarray:
        """Raw file rows (cached; callers must not mutate the result)."""
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        pts = np.loadtxt(self.paths[i], delimiter=",", dtype=np.float32)
        if pts.ndim == 1:  # single-row file
            pts = pts[None, :]
        if self._cache is not None:
            self._cache[i] = pts
        return pts

    def load(
        self, i: int, rng: np.random.Generator | None = None
    ) -> tuple[np.ndarray, int]:
        """→ (points [num_point, 6 or 3] float32, class id). First-N of
        the resampled file (the upstream default path), xyz unit-sphere
        normalized; with ``rng`` a random subset is drawn instead (used
        by the eval vote pool for non-degenerate extra votes)."""
        pts = self._parse(i)
        if rng is not None and pts.shape[0] > self.num_point:
            pts = pts[rng.choice(pts.shape[0], self.num_point, replace=False)]
        else:
            pts = pts[: self.num_point]
        if pts.shape[0] < self.num_point:  # tiny files: repeat points
            reps = -(-self.num_point // pts.shape[0])
            pts = np.tile(pts, (reps, 1))[: self.num_point]
        pts = pts.copy()
        pts[:, :3] = pc_normalize(pts[:, :3])
        if not self.use_normals:
            pts = pts[:, :3]
        return pts, int(self.labels[i])

    def batches(
        self,
        rng: np.random.Generator,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
    ):
        """Yield ([B, N, C] float32, [B] int32) static-shape batches."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, stop, batch_size):
            idx = order[s : s + batch_size]
            if len(idx) < batch_size and not drop_last:
                # wrap-pad the tail to the static batch shape; TILE the
                # order so batch_size > 2·len(dataset) still fills up
                pad = np.resize(order, batch_size - len(idx))
                idx = np.concatenate([idx, pad])
            pts = np.stack([self.load(i)[0] for i in idx])
            yield pts, self.labels[idx].copy()


# four separable synthetic shape families (fixture classes)
_SYNTH_SHAPES = ("ball", "box", "tube", "disk")


def _synth_shape(rng: np.random.Generator, kind: str, n: int) -> np.ndarray:
    """n surface points + outward normals of a simple solid."""
    if kind == "ball":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        return np.concatenate([v, v], axis=1)
    if kind == "box":
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-1, 1, (n, 2))
        xyz = np.zeros((n, 3))
        nrm = np.zeros((n, 3))
        axis, sign = face % 3, np.where(face < 3, 1.0, -1.0)
        for a in range(3):
            m = axis == a
            others = [b for b in range(3) if b != a]
            xyz[m, a] = sign[m]
            xyz[np.ix_(m, others)] = uv[m]
            nrm[m, a] = sign[m]
        return np.concatenate([xyz, nrm], axis=1)
    if kind == "tube":
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-1.5, 1.5, n)
        xyz = np.stack([np.cos(theta), np.sin(theta), z], axis=1)
        nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], axis=1)
        return np.concatenate([xyz, nrm], axis=1)
    # disk: flat annulus in the xy plane
    theta = rng.uniform(0, 2 * np.pi, n)
    r = np.sqrt(rng.uniform(0.04, 1.0, n))
    xyz = np.stack([r * np.cos(theta), r * np.sin(theta), np.zeros(n)], axis=1)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]]), (n, 1))
    return np.concatenate([xyz, nrm], axis=1)


def make_synthetic_modelnet(
    out_dir: str,
    *,
    points_per_shape: int = 512,
    train_per_class: int = 8,
    test_per_class: int = 2,
    seed: int = 0,
    num_category: int = 40,
) -> list[str]:
    """Write a geometry-separable fixture in the real on-disk layout (the
    cls analog of ``make_synthetic_rooms``): 4 primitive shape families
    under ``modelnet{num_category}_*`` metadata files, so the production
    loader parses actual files. Returns the shape file paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    prefix = f"modelnet{num_category}"
    with open(os.path.join(out_dir, f"{prefix}_shape_names.txt"), "w") as f:
        f.write("\n".join(_SYNTH_SHAPES) + "\n")
    written = []
    lists = {"train": [], "test": []}
    counts = {"train": train_per_class, "test": test_per_class}
    for name in _SYNTH_SHAPES:
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        i = 0
        for split in ("train", "test"):
            for _ in range(counts[split]):
                i += 1
                sid = f"{name}_{i:04d}"
                pts = _synth_shape(rng, name, points_per_shape)
                # mild anisotropic scale + jitter so classes have spread
                pts[:, :3] *= rng.uniform(0.8, 1.2, (1, 3))
                pts[:, :3] += rng.normal(0, 0.01, pts[:, :3].shape)
                path = os.path.join(out_dir, name, f"{sid}.txt")
                np.savetxt(path, pts, fmt="%.6f", delimiter=",")
                lists[split].append(sid)
                written.append(path)
    for split in ("train", "test"):
        with open(os.path.join(out_dir, f"{prefix}_{split}.txt"), "w") as f:
            f.write("\n".join(lists[split]) + "\n")
    return written
