"""RandLA-Net data pipeline, numpy only (port of
``pointsecguard_tpu/data/randla.py``).

Preparation of a collected room (`data_prepare_s3dis.py:29-72`: 0.04 m
grid sub-sampling, a KD-tree, the full→sub projection), the
possibility-driven spatially-regular sampler (`main_S3DIS.py:116-186`)
with its loaders for the S3DIS, SemanticKITTI and Semantic3D trees of
``cli.prepare``, and the three datasets' presets with the raw-label
reduction of the datasets that ignore a label.
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


def prepare_room(room_npy: str, out_dir: str, sub_grid_size: float = 0.04,
                 original_dir: str | None = None) -> str:
    """One-off preparation of a collected room file (Nx7 xyzrgbl .npy):
    writes ``<name>.ply`` (sub-sampled cloud, colors scaled to [0,1]),
    ``<name>_KDTree.pkl`` and ``<name>_proj.pkl``, mirroring
    `data_prepare_s3dis.py:29-72`. With ``original_dir``, also writes the
    full-resolution labeled cloud there (`data_prepare_s3dis.py:22,41-43`
    ``original_ply``, the ground truth `6_fold_cv.py:12` reads). Returns
    the room's name."""
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(room_npy))[0]
    data = np.load(room_npy)
    xyz = data[:, :3].astype(np.float32)
    colors = data[:, 3:6].astype(np.uint8)
    labels = data[:, 6].astype(np.uint8)

    if original_dir is not None:
        os.makedirs(original_dir, exist_ok=True)
        write_ply(
            os.path.join(original_dir, name + ".ply"),
            [xyz, colors, labels],
            ["x", "y", "z", "red", "green", "blue", "class"],
        )

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
    colors: np.ndarray | None  # [N, 3] in [0, 1]; None = xyz-only (KITTI)
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

    @classmethod
    def load_semantickitti(
        cls,
        sequences_root: str,
        *,
        split: str = "train",
        val_seq: str = "08",
        num_points: int = 45056,
        rng: np.random.Generator | None = None,
    ):
        """The scans of a SemanticKITTI tree prepared by ``cli.prepare
        --dataset semantickitti``. Sequences 00-10 are labeled, ``val_seq``
        (08) is the ``"test"`` split, sequences >= 11 the unlabeled
        ``"test_scans"`` (`helper_tool.py:18-41`). Scans have no colours:
        features are xyz-only (label 0 = unlabeled, ignored downstream)."""
        clouds = []
        for seq_id in sorted(os.listdir(sequences_root)):
            pc_dir = os.path.join(sequences_root, seq_id, "velodyne")
            if not os.path.isdir(pc_dir):
                continue
            labeled = int(seq_id) < 11
            part = ("test_scans" if not labeled
                    else "test" if seq_id == val_seq else "train")
            if part != split:
                continue
            for fname in sorted(os.listdir(pc_dir)):
                scan_id = os.path.splitext(fname)[0]
                xyz = np.load(os.path.join(pc_dir, fname)).astype(np.float32)
                lab_path = os.path.join(sequences_root, seq_id, "labels", scan_id + ".npy")
                labels = (np.load(lab_path).reshape(-1).astype(np.int64)
                          if os.path.exists(lab_path) else np.zeros(len(xyz), np.int64))
                with open(os.path.join(sequences_root, seq_id, "KDTree", scan_id + ".pkl"),
                          "rb") as f:
                    tree = pickle.load(f)
                clouds.append(RandlaCloud(f"{seq_id}_{scan_id}", xyz, None, labels, tree))
        return cls(clouds, num_points=num_points, rng=rng)

    @classmethod
    def load_semantic3d(
        cls,
        input_dir: str,
        *,
        split: str = "train",
        val_names: tuple = ("bildstein_station3", "sg27_station2"),
        num_points: int = 65536,
        rng: np.random.Generator | None = None,
    ):
        """The labeled clouds of a Semantic3D ``input_0.060`` directory
        prepared by ``cli.prepare --dataset semantic3d``, split by name
        (``val_names`` are the ``"test"`` split); unlabeled clouds are
        skipped. Labels keep the raw 0-8 range (0 = unlabeled, ignored
        downstream)."""
        clouds = []
        for fname in sorted(os.listdir(input_dir)):
            if not fname.endswith(".ply"):
                continue
            name = fname[:-4]
            data = read_ply(os.path.join(input_dir, fname))
            if "class" not in data.dtype.names:
                continue  # unlabeled test cloud
            if (split == "train") == any(v in name for v in val_names):
                continue
            xyz = np.vstack([data["x"], data["y"], data["z"]]).T.astype(np.float32)
            colors = np.vstack(
                [data["red"], data["green"], data["blue"]]
            ).T.astype(np.float32)
            labels = np.asarray(data["class"], np.int64)
            with open(os.path.join(input_dir, name + "_KDTree.pkl"), "rb") as f:
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
        q_colors = (cloud.colors[queried] if cloud.colors is not None
                    else np.zeros((k, 0), np.float32))  # xyz-only (KITTI)
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
        — features = [xyz | rgb] as fed to the model (`main_S3DIS.py:193`);
        [B,P,3] for xyz-only clouds."""
        for _ in range(steps):
            xs, cs, ls, qs, cis = zip(*(self.sample() for _ in range(batch_size)))
            xyz = np.stack(xs)
            feats = np.concatenate([xyz, np.stack(cs)], axis=-1)
            yield xyz, feats, np.stack(ls), np.stack(qs), np.array(cis)


# SemanticKITTI valid classes in learning-map order 1..19
# (`RandLA-Net/utils/semantic-kitti.yaml` learning_map_inv / labels)
SEMANTICKITTI_CLASSES = (
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
)

# Semantic3D classes 1..8 (label 0 = unlabeled; the semantic3d.net
# convention `ConfigSemantic3D` targets, `helper_tool.py:69-100`)
SEMANTIC3D_CLASSES = (
    "man-made terrain", "natural terrain", "high vegetation",
    "low vegetation", "buildings", "hard scape", "scanning artefacts",
    "cars",
)


@dataclass(frozen=True)
class RandlaDatasetPreset:
    """What a driver needs to run RandLA on one of the three datasets: its
    config, its label space and a sampler factory over the prepared tree."""

    name: str
    cfg: object
    num_classes: int  # valid classes = the model's logit width
    class_names: tuple
    ignored_labels: tuple  # raw labels left out of the loss and the metrics
    weights_key: str  # data.class_weights.get_class_weights key
    has_colors: bool  # False: xyz-only features, no colour threat surface
    make_sampler: object  # (dir, split, num_points, rng, test_area)

    def label_table(self) -> np.ndarray:
        """Raw label → valid-class index, −1 on the ignored labels: the one
        table ``reduce_labels`` reads (on the device, a copy made once)."""
        table = label_reduce_lut(self.num_classes, self.ignored_labels)
        table[list(self.ignored_labels)] = -1
        return table

    def reduce(self, labels: np.ndarray):
        """Raw labels → ``(valid, reduced)`` through ``label_table``."""
        return reduce_labels(self.label_table(), labels)


def randla_dataset_preset(dataset: str) -> RandlaDatasetPreset:
    """→ preset for ``--randla_dataset {s3dis,semantickitti,semantic3d}``."""
    from pointsecguard_tpu_torch import configs
    from pointsecguard_tpu_torch.data.s3dis import S3DIS_CLASSES

    dataset = dataset or "s3dis"
    if dataset == "semantickitti":
        def make(d, split, n, rng, test_area=5):
            return SpatiallyRegularSampler.load_semantickitti(
                d, split=split, num_points=n, rng=rng)

        return RandlaDatasetPreset(
            "semantickitti", configs.RandlaSemanticKITTIConfig(), 19,
            SEMANTICKITTI_CLASSES, (0,), "SemanticKITTI", False, make)
    if dataset == "semantic3d":
        def make(d, split, n, rng, test_area=5):
            return SpatiallyRegularSampler.load_semantic3d(
                d, split=split, num_points=n, rng=rng)

        return RandlaDatasetPreset(
            "semantic3d", configs.RandlaSemantic3DConfig(), 8,
            SEMANTIC3D_CLASSES, (0,), "Semantic3D", True, make)
    if dataset == "s3dis":
        def make(d, split, n, rng, test_area=5):
            return SpatiallyRegularSampler.load(
                d, split=split, test_area=test_area, num_points=n, rng=rng)

        return RandlaDatasetPreset(
            "s3dis", configs.RandlaConfig(), NUM_CLASSES, S3DIS_CLASSES, (),
            "S3DIS", True, make)
    raise ValueError(f"unknown randla dataset {dataset!r}")


def label_reduce_lut(num_classes: int, ignored: tuple) -> np.ndarray:
    """Raw-label → valid-class-index lookup (`RandLANet.py:103-124`
    reducing_list semantics): ignored labels map to 0 and must be masked
    out separately; valid labels map to their contiguous index."""
    total = num_classes + len(ignored)
    lut = np.zeros(total, np.int64)
    keep = [c for c in range(total) if c not in set(ignored)]
    lut[keep] = np.arange(num_classes)
    return lut


def reduce_labels(table, labels):
    """The ignored-label rule of `RandLANet.py:103-124`, on numpy arrays or
    on torch tensors alike: ``table`` (a preset's ``label_table``, on the
    labels' device) gives ``(valid, reduced)``, ``valid`` False on the
    ignored labels and ``reduced`` each label's contiguous class index (0
    where ignored, to be masked out by ``valid``)."""
    r = table[labels]
    valid = r >= 0
    return valid, r * valid
