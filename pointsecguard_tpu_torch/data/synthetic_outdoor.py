"""Synthetic raw data in the formats ``cli.prepare`` reads, numpy only.

No SemanticKITTI, Semantic3D or S3DIS file ships with the repository, so
the tests and ``chip_smoke.py`` write small stand-ins in each dataset's own
raw format and prepare them like the real thing:

- ``write_raw_semantickitti``: ``sequences/<seq>/velodyne/<id>.bin``
  (float32 x y z remission) and ``labels/<id>.label`` (uint32, semantic id
  in the low 16 bits, instance id above) for labeled sequences, plus a
  ``semantic-kitti.yaml`` laid out like the dataset's own (its
  ``learning_map`` maps the raw ids to 0..19, 0 the ignored class);
- ``write_raw_semantic3d``: ``<name>.txt`` (x y z intensity r g b per
  line) with a sibling ``<name>.labels`` (0..8, 0 unlabeled) for labeled
  clouds;
- ``write_raw_s3dis``: ``Area_<k>/<room>/Annotations/<class>_<i>.txt``
  (x y z r g b per line) from collected ``.npy`` rooms.

The geometry is a street scene: ground, buildings, vegetation, cars and
poles, each class with its own shape (and, for Semantic3D, colour), with a
share of points under labels that map to the ignored class.
"""

from __future__ import annotations

import os

import numpy as np

# the learning map of the dataset's semantic-kitti.yaml (raw id → 0..19)
KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6, 31: 7,
    32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0, 60: 9, 70: 15,
    71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7, 254: 6, 255: 8,
    256: 5, 257: 5, 258: 4, 259: 5,
}
_KITTI_NAMES = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus", 15: "motorcycle",
    16: "on-rails", 18: "truck", 20: "other-vehicle", 30: "person", 31: "bicyclist",
    32: "motorcyclist", 40: "road", 44: "parking", 48: "sidewalk", 49: "other-ground",
    50: "building", 51: "fence", 52: "other-structure", 60: "lane-marking",
    70: "vegetation", 71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist", 254: "moving-person",
    255: "moving-motorcyclist", 256: "moving-on-rails", 257: "moving-bus",
    258: "moving-truck", 259: "moving-other-vehicle",
}


def kitti_yaml_text() -> str:
    """A semantic-kitti.yaml with the sections of the dataset's own
    (``labels``, ``color_map``, ``content``, ``learning_map``,
    ``learning_map_inv``, ``learning_ignore``, ``split``) and comments."""
    inv = {v: k for k, v in sorted(KITTI_LEARNING_MAP.items(), reverse=True)}
    lines = ["# This file is covered by the LICENSE file in the root of this project.",
             "labels:"]
    lines += [f"  {k}: \"{n}\"" for k, n in _KITTI_NAMES.items()]
    lines += ["color_map: # bgr"]
    lines += [f"  {k}: [{(37 * k) % 256}, {(91 * k) % 256}, {(53 * k) % 256}]"
              for k in _KITTI_NAMES]
    lines += ["content: # as a ratio with the total number of points"]
    lines += [f"  {k}: {1.0 / len(_KITTI_NAMES):.6f}" for k in _KITTI_NAMES]
    lines += ["# classes that are indistinguishable from single scan or inconsistent in",
              "# ground truth are mapped to their closest equivalent",
              "learning_map:"]
    lines += [f"  {k} : {v}     # \"{_KITTI_NAMES[k]}\"" for k, v in KITTI_LEARNING_MAP.items()]
    lines += ["learning_map_inv: # inverse of previous map"]
    lines += [f"  {v}: {k}      # \"{_KITTI_NAMES[k]}\"" for v, k in sorted(inv.items())]
    lines += ["learning_ignore: # Ignore classes"]
    lines += [f"  {v}: {'True' if v == 0 else 'False'}" for v in sorted(inv)]
    lines += ["split: # sequence numbers", "  train:"]
    lines += [f"    - {s}" for s in (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)]
    lines += ["  valid:", "    - 8", "  test:"]
    lines += [f"    - {s}" for s in range(11, 22)]
    return "\n".join(lines) + "\n"


def _street(rng: np.random.Generator, n: int, extent: float):
    """n points of a street scene in [-extent, extent]² → (xyz [n, 3]
    float32, part [n] int): 0 road, 1 sidewalk, 2 building, 3 vegetation,
    4 car, 5 pole, 6 clutter."""
    share = np.array([0.30, 0.10, 0.20, 0.18, 0.10, 0.04, 0.08])
    part = rng.choice(len(share), size=n, p=share)
    xyz = np.empty((n, 3))
    xyz[:, 0] = rng.uniform(-extent, extent, n)
    xyz[:, 1] = rng.uniform(-extent, extent, n)
    xyz[:, 2] = rng.uniform(0.0, 0.05, n)  # ground: road and sidewalk
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    m = part == 0
    xyz[m, 1] = rng.uniform(-0.3 * extent, 0.3 * extent, m.sum())
    m = part == 1
    xyz[m, 1] = side[m] * rng.uniform(0.3 * extent, 0.45 * extent, m.sum())
    xyz[m, 2] += 0.15
    m = part == 2  # facades along both sides
    xyz[m, 1] = side[m] * rng.uniform(0.6 * extent, 0.65 * extent, m.sum())
    xyz[m, 2] = rng.uniform(0.0, 12.0, m.sum())
    m = part == 3  # tree crowns
    xyz[m, 1] = side[m] * rng.uniform(0.47 * extent, 0.58 * extent, m.sum())
    xyz[m, 2] = rng.uniform(3.0, 7.0, m.sum())
    m = part == 4  # cars parked on the road's edges
    xyz[m, 1] = side[m] * rng.uniform(0.2 * extent, 0.28 * extent, m.sum())
    xyz[m, 2] = rng.uniform(0.3, 1.5, m.sum())
    m = part == 5  # poles every 8 m
    xyz[m, 0] = np.round(xyz[m, 0] / 8.0) * 8.0 + rng.normal(0.0, 0.08, m.sum())
    xyz[m, 1] = side[m] * 0.46 * extent + rng.normal(0.0, 0.08, m.sum())
    xyz[m, 2] = rng.uniform(0.0, 6.0, m.sum())
    m = part == 6
    xyz[m, 2] = rng.uniform(0.0, 3.0, m.sum())
    return xyz.astype(np.float32), part


# street part → raw SemanticKITTI id (clutter: the ids learning_map sends to 0)
_KITTI_PART_IDS = (40, 48, 50, 70, 10, 80)
_KITTI_IGNORED_IDS = (0, 1, 52, 99)


def write_raw_semantickitti(root: str, scans: dict | None = None, points: int = 120_000,
                            seed: int = 0) -> tuple[str, str]:
    """Raw SemanticKITTI under ``root``: ``sequences/<seq>`` with ``scans``
    (sequence id → scan count; default 00: 2, 08: 1, 11: 1) of ``points``
    points each, labels for sequences below 11, and ``semantic-kitti.yaml``.
    Returns (sequences dir, yaml path)."""
    rng = np.random.default_rng(seed)
    scans = scans or {"00": 2, "08": 1, "11": 1}
    seq_root = os.path.join(root, "sequences")
    for seq, count in scans.items():
        os.makedirs(os.path.join(seq_root, seq, "velodyne"), exist_ok=True)
        if int(seq) < 11:
            os.makedirs(os.path.join(seq_root, seq, "labels"), exist_ok=True)
        for i in range(count):
            xyz, part = _street(rng, points, 40.0)
            remission = rng.random(points).astype(np.float32)
            scan = np.concatenate([xyz, remission[:, None]], axis=1)
            scan.astype(np.float32).tofile(os.path.join(seq_root, seq, "velodyne",
                                                        f"{i:06d}.bin"))
            if int(seq) >= 11:
                continue
            sem = np.empty(points, np.uint32)
            clutter = part == 6
            sem[~clutter] = np.asarray(_KITTI_PART_IDS, np.uint32)[part[~clutter]]
            sem[clutter] = rng.choice(np.asarray(_KITTI_IGNORED_IDS, np.uint32),
                                      clutter.sum())
            inst = np.where(part == 4, (np.floor(xyz[:, 0] / 5.0) + 100).astype(np.int64),
                            0).astype(np.uint32)
            (sem | (inst << 16)).tofile(os.path.join(seq_root, seq, "labels",
                                                     f"{i:06d}.label"))
    yaml_path = os.path.join(root, "semantic-kitti.yaml")
    with open(yaml_path, "w") as f:
        f.write(kitti_yaml_text())
    return seq_root, yaml_path


# street part → Semantic3D label (1 man-made terrain, 4 low vegetation,
# 5 buildings, 3 high vegetation, 8 cars, 6 hard scape; clutter: 0
# unlabeled and 7 scanning artefacts) and its base colour
_SEM3D_PART_LABELS = (1, 4, 5, 3, 8, 6, 0)
_SEM3D_COLORS = ((90, 90, 95), (70, 150, 60), (200, 170, 140), (30, 110, 30),
                 (180, 30, 30), (160, 160, 40), (120, 120, 120))
SEMANTIC3D_CLOUDS = (("untermaederbrunnen_station1_xyz_intensity_rgb", True),
                     ("bildstein_station3_xyz_intensity_rgb", True),
                     ("birdfountain_station1_xyz_intensity_rgb", False))


def write_raw_semantic3d(raw_dir: str, clouds=SEMANTIC3D_CLOUDS, points: int = 150_000,
                         extent: float = 25.0, seed: int = 0) -> list[str]:
    """Raw Semantic3D clouds under ``raw_dir``: per (name, labeled) of
    ``clouds`` a ``<name>.txt`` of ``points`` lines ``x y z intensity r g
    b`` (coordinates in mm steps, as the dataset's), and for labeled clouds
    ``<name>.labels``, a tenth of the clutter at the scanning-artefact
    label 7, the rest at 0. Returns the cloud names."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    for name, labeled in clouds:
        xyz, part = _street(rng, points, extent)
        rgb = np.asarray(_SEM3D_COLORS, np.float64)[part] + rng.normal(0.0, 8.0, (points, 3))
        rgb = np.clip(np.round(rgb), 0, 255).astype(np.int64)
        intensity = rng.integers(-2048, 2048, points)
        cols = np.column_stack([xyz.astype(np.float64), intensity, rgb])
        np.savetxt(os.path.join(raw_dir, name + ".txt"), cols,
                   fmt=["%.3f", "%.3f", "%.3f", "%d", "%d", "%d", "%d"])
        if labeled:
            labels = np.asarray(_SEM3D_PART_LABELS)[part]
            labels[(part == 6) & (rng.random(points) < 0.1)] = 7
            np.savetxt(os.path.join(raw_dir, name + ".labels"), labels, fmt="%d")
    return [name for name, _ in clouds]


def write_raw_s3dis(rooms: list[str], raw_root: str) -> None:
    """Each collected room (``Area_<k>_<room>.npy``, Nx7 xyzrgbl) as a raw
    S3DIS ``Area_<k>/<room>/Annotations`` directory: one ``<class>_1.txt``
    (x y z r g b, millimetre coordinates) per class the room holds."""
    from pointsecguard_tpu_torch.data.s3dis import S3DIS_CLASSES

    for path in rooms:
        name = os.path.splitext(os.path.basename(path))[0]
        area, room = "_".join(name.split("_")[:2]), "_".join(name.split("_")[2:])
        anno = os.path.join(raw_root, area, room, "Annotations")
        os.makedirs(anno, exist_ok=True)
        data = np.load(path)
        for label in np.unique(data[:, 6]).astype(int):
            pts = data[data[:, 6] == label, :6]
            np.savetxt(os.path.join(anno, f"{S3DIS_CLASSES[label]}_1.txt"), pts,
                       fmt=["%.3f", "%.3f", "%.3f", "%d", "%d", "%d"])
