"""SemanticKITTI and Semantic3D preparation, numpy and scipy only (port of
``pointsecguard_tpu/data/other_datasets.py``).

Equivalents of `RandLA-Net/utils/data_prepare_semantickitti.py` (0.06 m
grid, label remap through the semantic-kitti.yaml learning_map) and
`data_prepare_semantic3d.py` (0.01 m then 0.06 m grids): the sub-sampled
cloud, its KD-tree pickle and the full→sub projection, in the layout the
RandLA presets of ``data.randla`` read. A copy, not an import, with two
deliberate differences that keep it off packages the port does not need:
the learning map is read by a small parser of its own, not PyYAML, and
Semantic3D text by ``np.loadtxt``, not pandas. The sub-sampler is the
port's numpy ``ops.subsample.grid_subsample``.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
from scipy.spatial import cKDTree

from pointsecguard_tpu_torch.data.ply import write_ply
from pointsecguard_tpu_torch.ops.subsample import grid_subsample


def load_kitti_scan(path: str) -> np.ndarray:
    """Velodyne .bin scan → [N, 3] xyz (`helper_tool.py:118-123`)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return scan[:, :3]


def load_kitti_labels(path: str, remap_lut: np.ndarray) -> np.ndarray:
    """.label file → remapped semantic labels (`helper_tool.py:125-133`):
    semantic id in the lower 16 bits, instance id above, then the
    learning_map lookup."""
    label = np.fromfile(path, dtype=np.uint32).reshape(-1)
    sem = label & 0xFFFF
    inst = label >> 16
    assert ((sem + (inst << 16)) == label).all()
    return remap_lut[sem].astype(np.int32)


def build_kitti_remap(learning_map: dict[int, int]) -> np.ndarray:
    """LUT from the semantic-kitti.yaml ``learning_map`` section
    (`data_prepare_semantickitti.py:13-17`)."""
    lut = np.zeros(max(learning_map.keys()) + 100, dtype=np.int32)
    for k, v in learning_map.items():
        lut[k] = v
    return lut


def parse_kitti_learning_map(yaml_path: str) -> dict[int, int]:
    """``learning_map`` section of the dataset's semantic-kitti.yaml
    (`data_prepare_semantickitti.py:13-17`), read without a YAML library:
    the block of ``int: int`` lines under the top-level ``learning_map:``
    key, ``#`` comments dropped, up to the next top-level key (so
    ``learning_map_inv:``, which follows it in the real file, is not read)."""
    mapping: dict[int, int] = {}
    inside = found = False
    with open(yaml_path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if not line[0].isspace():  # a top-level key
                if inside:
                    break
                key, _, rest = line.partition(":")
                if key.strip() == "learning_map":
                    if rest.strip():
                        raise ValueError(f"{yaml_path}: learning_map must be a block "
                                         "of 'id: id' lines")
                    inside = found = True
                continue
            if inside:
                key, sep, value = line.partition(":")
                if not sep:
                    raise ValueError(f"{yaml_path}: not an 'id: id' line: {raw.strip()!r}")
                mapping[int(key)] = int(value)
    if not found:
        raise ValueError(f"{yaml_path} has no top-level learning_map")
    return mapping


def prepare_scan(
    xyz: np.ndarray,
    labels: np.ndarray | None,
    out_dir: str,
    name: str,
    *,
    grid_size: float = 0.06,
    num_classes: int = 20,
    save_proj: bool = True,
) -> None:
    """Grid-subsample one scan/cloud and persist the RandLA input artifacts
    (same layout as the S3DIS prep: .npy points/labels + KDTree + proj;
    ``_proj.pkl`` pickles ``[proj_idx, raw_labels]`` — the 2-list format
    every other prep writes and `cli.eval`'s reprojection unpacks)."""
    os.makedirs(out_dir, exist_ok=True)
    if labels is not None:
        sub_xyz, sub_labels = grid_subsample(xyz, None, labels, grid_size, num_classes)
        np.save(os.path.join(out_dir, name + "_labels.npy"), sub_labels)
    else:
        sub_xyz = grid_subsample(xyz, sample_dl=grid_size)
    np.save(os.path.join(out_dir, name + "_xyz.npy"), sub_xyz)
    tree = cKDTree(sub_xyz)
    with open(os.path.join(out_dir, name + "_KDTree.pkl"), "wb") as f:
        pickle.dump(tree, f)
    if save_proj:
        _, proj = tree.query(xyz, k=1)
        proj_labels = (labels if labels is not None
                       else np.zeros(len(xyz), np.uint8))
        with open(os.path.join(out_dir, name + "_proj.pkl"), "wb") as f:
            pickle.dump([proj.astype(np.int32), np.asarray(proj_labels)], f)


def prepare_semantickitti_root(
    raw_sequences: str,
    out_sequences: str,
    learning_map: dict[int, int],
    *,
    grid_size: float = 0.06,
    num_classes: int = 20,
) -> list[str]:
    """Walk ``<raw_sequences>/<seq>/velodyne/*.bin`` and write the RandLA
    input artifacts in the reference layout
    (`data_prepare_semantickitti.py:24-77`): per scan
    ``velodyne/<id>.npy`` (grid-subsampled xyz), ``labels/<id>.npy``
    (majority-vote remapped labels, sequences 00-10 only),
    ``KDTree/<id>.pkl``, and ``proj/<id>_proj.pkl`` (pickled
    ``[proj_inds]``) for the validation sequence 08 and the unlabeled
    test sequences >= 11. Returns the list of prepared ``seq/scan`` ids.
    """
    remap_lut = build_kitti_remap(learning_map)
    done: list[str] = []
    for seq_id in sorted(os.listdir(raw_sequences)):
        pc_path = os.path.join(raw_sequences, seq_id, "velodyne")
        if not os.path.isdir(pc_path):
            continue
        seq_out = os.path.join(out_sequences, seq_id)
        pc_out = os.path.join(seq_out, "velodyne")
        tree_out = os.path.join(seq_out, "KDTree")
        os.makedirs(pc_out, exist_ok=True)
        os.makedirs(tree_out, exist_ok=True)
        labeled = int(seq_id) < 11
        needs_proj = seq_id == "08" or not labeled
        if labeled:
            label_out = os.path.join(seq_out, "labels")
            os.makedirs(label_out, exist_ok=True)
        if needs_proj:
            proj_out = os.path.join(seq_out, "proj")
            os.makedirs(proj_out, exist_ok=True)
        for scan in sorted(os.listdir(pc_path)):
            scan_id = os.path.splitext(scan)[0]
            points = load_kitti_scan(os.path.join(pc_path, scan))
            if labeled:
                labels = load_kitti_labels(
                    os.path.join(raw_sequences, seq_id, "labels", scan_id + ".label"),
                    remap_lut,
                )
                sub_points, sub_labels = grid_subsample(points, None, labels, grid_size,
                                                        num_classes)
                np.save(os.path.join(label_out, scan_id + ".npy"), sub_labels)
            else:
                sub_points = grid_subsample(points, sample_dl=grid_size)
            np.save(os.path.join(pc_out, scan_id + ".npy"), sub_points)
            tree = cKDTree(sub_points)
            with open(os.path.join(tree_out, scan_id + ".pkl"), "wb") as f:
                pickle.dump(tree, f)
            if needs_proj:
                _, proj = tree.query(points, k=1)
                with open(os.path.join(proj_out, scan_id + "_proj.pkl"), "wb") as f:
                    pickle.dump([proj.astype(np.int32)], f)
            done.append(f"{seq_id}/{scan_id}")
    return done


def load_semantic3d_cloud(path: str) -> np.ndarray:
    """Semantic3D ``.txt`` cloud → [N, 7] float32 (x y z intensity r g b).

    `helper_tool.py:105-108` reads via pandas at float16 (a memory
    tradeoff that quantizes coordinates); this reads float32 with
    ``np.loadtxt``: the values the JAX package's pandas route gives."""
    return np.loadtxt(path, dtype=np.float32).reshape(-1, 7)


def prepare_semantic3d_root(
    raw_dir: str,
    out_root: str,
    *,
    first_grid: float = 0.01,
    final_grid: float = 0.06,
    num_classes: int = 9,
) -> list[str]:
    """Walk ``<raw_dir>/*.txt`` (+ optional sibling ``.labels``) and write
    the reference artifact layout (`data_prepare_semantic3d.py:16-90`):
    ``original_ply/<name>.ply`` (labeled clouds: 0.01 m pre-reduction;
    test clouds: full resolution), ``input_<final_grid>/<name>.ply``
    (working grid, colors scaled to [0,1]), ``<name>_KDTree.pkl`` and
    ``<name>_proj.pkl`` (pickled ``[proj_idx, labels]``; zeros for
    unlabeled test clouds). Existing KD-tree artifacts are skipped like
    the reference (`:26-27`). Returns prepared cloud names."""
    original_dir = os.path.join(out_root, "original_ply")
    sub_dir = os.path.join(out_root, f"input_{final_grid:.3f}")
    os.makedirs(original_dir, exist_ok=True)
    os.makedirs(sub_dir, exist_ok=True)
    done: list[str] = []
    for pc_path in sorted(glob.glob(os.path.join(raw_dir, "*.txt"))):
        name = os.path.splitext(os.path.basename(pc_path))[0]
        if os.path.exists(os.path.join(sub_dir, name + "_KDTree.pkl")):
            continue
        pc = load_semantic3d_cloud(pc_path)
        xyz = pc[:, :3].astype(np.float32)
        colors = pc[:, 4:7].astype(np.uint8)
        label_path = pc_path[:-4] + ".labels"
        if os.path.exists(label_path):
            labels = np.loadtxt(label_path, dtype=np.uint8).reshape(-1)
            # 0.01 m pre-reduction "to save space"
            # (`data_prepare_semantic3d.py:35-40`)
            pre_xyz, pre_col, pre_lab = grid_subsample(xyz, colors, labels, first_grid,
                                                       num_classes)
            write_ply(
                os.path.join(original_dir, name + ".ply"),
                [pre_xyz, pre_col.astype(np.uint8), pre_lab.astype(np.int32)],
                ["x", "y", "z", "red", "green", "blue", "class"],
            )
            sub_xyz, sub_col, sub_lab = grid_subsample(pre_xyz, pre_col, pre_lab, final_grid,
                                                       num_classes)
            write_ply(
                os.path.join(sub_dir, name + ".ply"),
                [sub_xyz, (sub_col / 255.0).astype(np.float32), sub_lab.astype(np.int32)],
                ["x", "y", "z", "red", "green", "blue", "class"],
            )
            # the projection maps the ORIGINAL-ply (0.01-grid) points,
            # not the raw cloud (`data_prepare_semantic3d.py:56`). The
            # reference pickles the RAW labels next to it (`:59`), a
            # length mismatch that never bites there because its drivers
            # never read labeled-cloud proj files. Here cli.eval scores
            # labeled validation clouds through the projection, so the
            # pickle holds the ORIGINAL-ply labels that pair with the
            # projected points (a deliberate fix, kept from the JAX package)
            query_xyz, proj_labels = pre_xyz, pre_lab
        else:
            write_ply(
                os.path.join(original_dir, name + ".ply"),
                [xyz, colors],
                ["x", "y", "z", "red", "green", "blue"],
            )
            sub_xyz, sub_col = grid_subsample(xyz, colors, sample_dl=final_grid)
            write_ply(
                os.path.join(sub_dir, name + ".ply"),
                [sub_xyz, (sub_col / 255.0).astype(np.float32)],
                ["x", "y", "z", "red", "green", "blue"],
            )
            query_xyz = xyz
            proj_labels = np.zeros(pc.shape[0], dtype=np.uint8)
        tree = cKDTree(sub_xyz)
        with open(os.path.join(sub_dir, name + "_KDTree.pkl"), "wb") as f:
            pickle.dump(tree, f)
        _, proj = tree.query(query_xyz, k=1)
        with open(os.path.join(sub_dir, name + "_proj.pkl"), "wb") as f:
            pickle.dump([proj.astype(np.int32), proj_labels], f)
        done.append(name)
    return done


def prepare_semantic3d_cloud(
    points: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray | None,
    out_dir: str,
    name: str,
    *,
    first_grid: float = 0.01,
    final_grid: float = 0.06,
    num_classes: int = 9,
) -> None:
    """Semantic3D two-stage pipeline (`data_prepare_semantic3d.py`):
    0.01 m pre-reduction then the working 0.06 m grid; writes the
    sub-cloud PLY + KD-tree + projection."""
    os.makedirs(out_dir, exist_ok=True)
    if labels is not None:
        xyz1, col1, lab1 = grid_subsample(points, colors, labels, first_grid, num_classes)
        sub_xyz, sub_col, sub_lab = grid_subsample(xyz1, col1, lab1, final_grid, num_classes)
        write_ply(
            os.path.join(out_dir, name + ".ply"),
            [sub_xyz, sub_col.astype(np.uint8), sub_lab.astype(np.int32)],
            ["x", "y", "z", "red", "green", "blue", "class"],
        )
    else:
        xyz1, col1 = grid_subsample(points, colors, sample_dl=first_grid)
        sub_xyz, sub_col = grid_subsample(xyz1, col1, sample_dl=final_grid)
        write_ply(
            os.path.join(out_dir, name + ".ply"),
            [sub_xyz, sub_col.astype(np.uint8)],
            ["x", "y", "z", "red", "green", "blue"],
        )
    tree = cKDTree(sub_xyz)
    with open(os.path.join(out_dir, name + "_KDTree.pkl"), "wb") as f:
        pickle.dump(tree, f)
    # [proj_idx, labels]: the 2-list format the root prep writes and
    # cli.eval's reprojection unpacks (labels pair 1:1 with the queried
    # raw points; zeros for unlabeled clouds)
    _, proj = tree.query(points, k=1)
    proj_labels = (labels if labels is not None
                   else np.zeros(len(points), np.uint8))
    with open(os.path.join(out_dir, name + "_proj.pkl"), "wb") as f:
        pickle.dump([proj.astype(np.int32), np.asarray(proj_labels)], f)
