"""Legacy block utilities from the original PointNet S3DIS pipeline (a
copy of ``pointsecguard_tpu/data/blocks.py``, numpy only).

Equivalents of `PointNet/data_utils/indoor3d_util.py`'s block machinery
(`sample_data:120`, `room2blocks:142-212`, `room2samples:276`,
`room2blocks_plus_normalized:237`) and its OBJ export — the pre-DataLoader
preprocessing path some reference workflows used. The modern training path
uses `S3DISBlockSampler`; these exist for capability parity and for users
converting old pipelines.
"""

from __future__ import annotations

import numpy as np

from pointsecguard_tpu_torch.utils.logging import LABEL2COLOR


def sample_data(
    data: np.ndarray, num_sample: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Pad or subsample to exactly ``num_sample`` rows
    (`indoor3d_util.py:120-139`: both directions use ``np.random.choice``
    with its default replace=True — shrinking may repeat rows)."""
    n = data.shape[0]
    if n == num_sample:
        return data, np.arange(n)
    if n > num_sample:
        sel = rng.choice(n, num_sample, replace=True)
        return data[sel], sel
    extra = rng.choice(n, num_sample - n, replace=True)
    idx = np.concatenate([np.arange(n), extra])
    return data[idx], idx


def room2blocks(
    data: np.ndarray,
    labels: np.ndarray,
    num_point: int,
    *,
    block_size: float = 1.0,
    stride: float = 1.0,
    sample_num: int | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Cut a room into (possibly overlapping) xy blocks of fixed point
    count (`room2blocks:142-212`): blocks with <100 points are skipped,
    each kept block is padded/sampled to ``num_point``."""
    rng = rng or np.random.default_rng(0)
    limit = np.amax(data[:, :3], axis=0)
    num_block_x = int(np.ceil((limit[0] - block_size) / stride)) + 1
    num_block_y = int(np.ceil((limit[1] - block_size) / stride)) + 1
    blocks, block_labels = [], []
    for ix in range(max(num_block_x, 1)):
        for iy in range(max(num_block_y, 1)):
            xbeg, ybeg = ix * stride, iy * stride
            cond = (
                (data[:, 0] >= xbeg) & (data[:, 0] <= xbeg + block_size)
                & (data[:, 1] >= ybeg) & (data[:, 1] <= ybeg + block_size)
            )
            if cond.sum() < 100:  # discard near-empty blocks (`:188`)
                continue
            block_data = data[cond]
            block_lab = labels[cond]
            sampled, idx = sample_data(block_data, num_point, rng)
            blocks.append(sampled)
            block_labels.append(block_lab[idx])
    if not blocks:
        return np.zeros((0, num_point, data.shape[1])), np.zeros((0, num_point))
    return np.stack(blocks), np.stack(block_labels)


def room2blocks_normalized(
    data_label: np.ndarray,
    num_point: int,
    *,
    block_size: float = 1.0,
    stride: float = 1.0,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """`room2blocks_plus_normalized:237-274`: blocks with the 9-channel
    layout (centered-xy block coords | rgb/255 | room-normalized xyz)."""
    data = data_label[:, :6].copy()
    labels = data_label[:, 6].astype(np.int64)
    max_room = np.amax(data[:, :3], axis=0)
    blocks, block_labels = room2blocks(
        data, labels, num_point, block_size=block_size, stride=stride, rng=rng
    )
    out = np.zeros((blocks.shape[0], num_point, 9), np.float32)
    for b in range(blocks.shape[0]):
        out[b, :, 6] = blocks[b, :, 0] / max_room[0]
        out[b, :, 7] = blocks[b, :, 1] / max_room[1]
        out[b, :, 8] = blocks[b, :, 2] / max_room[2]
        minx = blocks[b, :, 0].min()
        miny = blocks[b, :, 1].min()
        blocks[b, :, 0] -= minx + block_size / 2
        blocks[b, :, 1] -= miny + block_size / 2
        blocks[b, :, 3:6] /= 255.0
        out[b, :, :6] = blocks[b]
    return out, block_labels


def room2samples(
    data: np.ndarray, labels: np.ndarray, num_point: int
) -> tuple[np.ndarray, np.ndarray]:
    """Split a whole (shuffled) room into ceil(N/num_point) equal samples,
    padding the tail by wrapping (`room2samples:276-296` semantics)."""
    n = data.shape[0]
    order = np.argsort(data[:, 0])  # the reference orders by x
    data, labels = data[order], labels[order]
    num_batches = int(np.ceil(n / num_point))
    total = num_batches * num_point
    pad_idx = np.arange(total) % n
    return (
        data[pad_idx].reshape(num_batches, num_point, -1),
        labels[pad_idx].reshape(num_batches, num_point),
    )


def export_obj(
    path: str, data_label: np.ndarray, *, label_color: bool = True
) -> None:
    """Write a colored OBJ point cloud (`indoor3d_util.py data_to_obj`):
    vertices with either semantic-label colors or raw RGB."""
    with open(path, "w") as f:
        for row in data_label:
            if label_color:
                c = LABEL2COLOR[int(row[6]) % len(LABEL2COLOR)]
            else:
                c = row[3:6]
            f.write(
                f"v {row[0]} {row[1]} {row[2]} {c[0]} {c[1]} {c[2]}\n"
            )


def bbox_label_to_obj(
    path: str, bboxes: np.ndarray, labels: np.ndarray
) -> None:
    """Export axis-aligned bounding boxes as OBJ wireframe cubes
    (`indoor3d_util.py bbox export` capability)."""
    with open(path, "w") as f:
        v = 0
        for (x0, y0, z0, x1, y1, z1), lab in zip(bboxes, labels):
            c = LABEL2COLOR[int(lab) % len(LABEL2COLOR)]
            for x in (x0, x1):
                for y in (y0, y1):
                    for z in (z0, z1):
                        f.write(f"v {x} {y} {z} {c[0]} {c[1]} {c[2]}\n")
            quads = [
                (1, 2, 4, 3), (5, 6, 8, 7), (1, 2, 6, 5),
                (3, 4, 8, 7), (1, 3, 7, 5), (2, 4, 8, 6),
            ]
            for q in quads:
                f.write("f " + " ".join(str(v + i) for i in q) + "\n")
            v += 8
