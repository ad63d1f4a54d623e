"""RandLA-Net data pipeline, numpy only (port of
``pointsecguard_tpu/data/randla.py:31-137,229-281,325-374``; the label
reduction for datasets with ignored labels comes with their slices).

Preparation of a collected room (`data_prepare_s3dis.py:29-72`: 0.04 m
grid sub-sampling, a KD-tree, the full→sub projection) and the
possibility-driven spatially-regular sampler (`main_S3DIS.py:116-186`).
A copy, not an import, with the JAX package's RNG calls, so the same
prepared directory and seed give array-equal batches (a test holds the
two against each other). The kNN pyramid is built on the device by
``models.randlanet.build_pyramid``.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np
from scipy.spatial import cKDTree

from pointsecguard_tpu_torch.data.ply import read_ply, write_ply
from pointsecguard_tpu_torch.data.s3dis import NUM_CLASSES
from pointsecguard_tpu_torch.ops.subsample import grid_subsample


def prepare_room(room_npy: str, out_dir: str, sub_grid_size: float = 0.04) -> str:
    """One-off preparation of a collected room file (Nx7 xyzrgbl .npy):
    writes ``<name>.ply`` (sub-sampled cloud, colors scaled to [0,1]),
    ``<name>_KDTree.pkl`` and ``<name>_proj.pkl``, mirroring
    `data_prepare_s3dis.py:29-72`. Returns the room's name."""
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(room_npy))[0]
    data = np.load(room_npy)
    xyz = data[:, :3].astype(np.float32)
    colors = data[:, 3:6].astype(np.uint8)
    labels = data[:, 6].astype(np.uint8)

    sub_xyz, sub_colors, sub_labels = grid_subsample(
        xyz, colors, labels, sub_grid_size, NUM_CLASSES
    )
    sub_colors = (sub_colors / 255.0).astype(np.float32)
    write_ply(
        os.path.join(out_dir, name + ".ply"),
        [sub_xyz, sub_colors, sub_labels.astype(np.uint8)],
        ["x", "y", "z", "red", "green", "blue", "class"],
    )
    tree = cKDTree(sub_xyz)
    with open(os.path.join(out_dir, name + "_KDTree.pkl"), "wb") as f:
        pickle.dump(tree, f)
    _, proj_idx = tree.query(xyz, k=1)
    with open(os.path.join(out_dir, name + "_proj.pkl"), "wb") as f:
        pickle.dump([proj_idx.astype(np.int32), labels], f)
    return name


@dataclass
class RandlaCloud:
    name: str
    xyz: np.ndarray  # [N, 3] sub-sampled coordinates
    colors: np.ndarray  # [N, 3] in [0, 1]
    labels: np.ndarray  # [N]
    tree: cKDTree


class SpatiallyRegularSampler:
    """Possibility-driven sampler (`main_S3DIS.py:129-186`).

    Tracks a per-point "possibility" score per cloud; each sample picks
    the least-visited point of the least-visited cloud, queries its
    ``num_points`` nearest neighbors (noised center), shuffles them, and
    bumps the possibility of everything touched.
    """

    def __init__(
        self,
        clouds: list[RandlaCloud],
        num_points: int = 40960,
        noise_init: float = 3.5,
        rng: np.random.Generator | None = None,
    ):
        self.clouds = clouds
        self.num_points = num_points
        self.noise_init = noise_init
        self.rng = rng or np.random.default_rng(0)
        self.possibility = [
            self.rng.random(len(c.labels)) * 1e-3 for c in clouds
        ]
        self.min_possibility = [float(p.min()) for p in self.possibility]

    @classmethod
    def load(
        cls,
        prepared_dir: str,
        *,
        split: str = "train",
        test_area: int = 5,
        num_points: int = 40960,
        rng: np.random.Generator | None = None,
    ):
        """The prepared ``.ply`` clouds of one split (``Area_<test_area>``
        is the test split) with their pickled KD-trees."""
        tag = f"Area_{test_area}"
        clouds = []
        for fname in sorted(os.listdir(prepared_dir)):
            if not fname.endswith(".ply"):
                continue
            name = fname[:-4]
            if (split == "train") == (tag in name):
                continue
            data = read_ply(os.path.join(prepared_dir, fname))
            xyz = np.vstack([data["x"], data["y"], data["z"]]).T.astype(np.float32)
            colors = np.vstack(
                [data["red"], data["green"], data["blue"]]
            ).T.astype(np.float32)
            labels = np.asarray(data["class"], np.int64)
            with open(os.path.join(prepared_dir, name + "_KDTree.pkl"), "rb") as f:
                tree = pickle.load(f)
            clouds.append(RandlaCloud(name, xyz, colors, labels, tree))
        return cls(clouds, num_points=num_points, rng=rng)

    def sample(self):
        """→ (xyz [P,3] centered, colors [P,3], labels [P], idx [P],
        cloud_idx int). P = num_points, up-sampled with replacement for
        small clouds (`helper_tool.py:169-180`)."""
        cloud_idx = int(np.argmin(self.min_possibility))
        cloud = self.clouds[cloud_idx]
        poss = self.possibility[cloud_idx]
        point_ind = int(np.argmin(poss))
        points = cloud.xyz
        center = points[point_ind : point_ind + 1]
        noise = self.rng.normal(scale=self.noise_init / 10, size=center.shape)
        pick = (center + noise).astype(points.dtype)

        k = min(len(points), self.num_points)
        _, queried = cloud.tree.query(pick, k=k)
        queried = queried[0]
        self.rng.shuffle(queried)
        q_xyz = points[queried] - pick
        q_colors = cloud.colors[queried]
        q_labels = cloud.labels[queried]

        dists = np.sum(
            np.square((points[queried] - pick).astype(np.float32)), axis=1
        )
        delta = np.square(1 - dists / np.max(dists))
        poss[queried] += delta
        self.min_possibility[cloud_idx] = float(poss.min())

        if k < self.num_points:  # up-sample with replacement
            dup = self.rng.integers(0, k, self.num_points - k)
            sel = np.concatenate([np.arange(k), dup])
            q_xyz, q_colors = q_xyz[sel], q_colors[sel]
            q_labels, queried = q_labels[sel], queried[sel]
        return (
            q_xyz.astype(np.float32),
            q_colors.astype(np.float32),
            q_labels.astype(np.int32),
            queried.astype(np.int32),
            cloud_idx,
        )

    def batches(self, batch_size: int, steps: int):
        """Yield (xyz [B,P,3], features [B,P,6], labels [B,P], idx, cloud_idx)
        — features = [xyz | rgb] as fed to the model (`main_S3DIS.py:193`)."""
        for _ in range(steps):
            xs, cs, ls, qs, cis = zip(*(self.sample() for _ in range(batch_size)))
            xyz = np.stack(xs)
            feats = np.concatenate([xyz, np.stack(cs)], axis=-1)
            yield xyz, feats, np.stack(ls), np.stack(qs), np.array(cis)


@dataclass(frozen=True)
class RandlaDatasetPreset:
    """What a driver needs to run RandLA on a dataset: its config, its
    class count and a sampler factory over the prepared directory."""

    name: str
    cfg: object
    num_classes: int  # the model's logit width
    make_sampler: object  # (dir, split, num_points, rng, test_area)


def randla_dataset_preset(dataset: str) -> RandlaDatasetPreset:
    """→ preset for ``--randla_dataset``; only ``s3dis`` is ported."""
    from pointsecguard_tpu_torch import configs

    dataset = dataset or "s3dis"
    if dataset in ("semantickitti", "semantic3d"):
        raise SystemExit(f"not ported yet: --randla_dataset {dataset}")
    if dataset != "s3dis":
        raise ValueError(f"unknown randla dataset {dataset!r}")

    def make(d, split, n, rng, test_area=5):
        return SpatiallyRegularSampler.load(
            d, split=split, test_area=test_area, num_points=n, rng=rng
        )

    return RandlaDatasetPreset(
        "s3dis", configs.RandlaConfig(), NUM_CLASSES, make
    )

