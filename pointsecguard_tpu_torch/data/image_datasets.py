"""Image benchmark datasets (ares parity: `RandLA-Net/ares/ares/dataset/`; a
copy of ``pointsecguard_tpu/data/image_datasets.py``, ``PIL`` imported
when an image loads).

The ares fork ships CIFAR-10 and ImageNet-val loaders
(`ares/dataset/cifar10.py:13-66`, `ares/dataset/imagenet.py:15-113`) used by
its stock image benchmarks; no point-cloud path touches them, but they are
part of the library surface. This module rebuilds the capability host-side
and framework-free: plain numpy/PIL generators instead of graph-mode
`tf.data` pipelines (on TPU the input pipeline is host work anyway — the
ares `dataset_to_iterator` session wrapper in `ares/dataset/utils.py:4-11`
collapses to ordinary Python iteration).

Deviations (documented): data roots are explicit arguments instead of the
ares hidden `~/.ares` resource dir, and nothing is downloaded — callers
point at an on-disk copy in the standard layouts (CIFAR-10 python-pickle
batches; ImageNet `val.txt` + image dir).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class ImageClassifierSpec:
    """Input contract of an image classifier (the attribute set every ares
    `Classifier` carries, `ares/model/base.py:4-113`): `load_for_classifier`
    scales raw uint8 images into this shape/dtype/range."""

    x_shape: tuple  # e.g. (32, 32, 3) or (3072,)
    x_dtype: np.dtype = np.dtype(np.float32)
    x_min: float = 0.0
    x_max: float = 1.0
    n_class: int = 10
    y_dtype: np.dtype = np.dtype(np.int32)


# ---------------------------------------------------------------------------
# CIFAR-10 (`ares/dataset/cifar10.py`)
# ---------------------------------------------------------------------------


def _cifar10_test_batch(root: str) -> tuple[np.ndarray, np.ndarray]:
    """Read the standard python-version `test_batch` pickle: a dict with
    b'data' [N,3072] uint8 (channel-major rows) and b'labels' — the same
    on-disk format keras' `cifar10.load_data` (cifar10.py:49) parses."""
    path = root
    if os.path.isdir(path):
        for cand in ("test_batch", os.path.join("cifar-10-batches-py", "test_batch")):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                path = p
                break
    if not os.path.isfile(path):
        # path may still be the directory itself when neither candidate
        # exists — a bare exists() check would pass and open() would
        # die with IsADirectoryError
        raise FileNotFoundError(
            f"no CIFAR-10 test_batch under '{root}' "
            "(expected the python-version pickle layout)"
        )
    with open(path, "rb") as f:
        batch = pickle.load(f, encoding="bytes")
    xs = np.asarray(batch[b"data"], dtype=np.uint8)
    xs = xs.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # → [N,32,32,3] HWC
    ys = np.asarray(batch[b"labels"], dtype=np.int64)
    return xs, ys


def load_cifar10(
    root: str,
    *,
    offset: int = 0,
    label_dtype=np.int32,
    load_target: bool = False,
    target_label: Optional[int] = None,
    targets: Optional[np.ndarray] = None,
) -> Iterator[tuple]:
    """Yield `(index, image uint8 [32,32,3], label[, target])` from the
    CIFAR-10 test split — semantics of `cifar10.load_dataset:37-66`:
    `offset` skips the first images but keeps absolute indices;
    `target_label` keeps only examples whose TRUE label equals it; targets
    come from a `target.npy` next to the data (ares' PATH_TARGET) unless
    passed explicitly."""
    xs, ys = _cifar10_test_batch(root)
    if load_target and targets is None:
        tpath = os.path.join(
            root if os.path.isdir(root) else os.path.dirname(root), "target.npy"
        )
        if not os.path.exists(tpath):
            raise FileNotFoundError(
                f"load_target=True but no targets given and '{tpath}' not found"
            )
        targets = np.load(tpath)
    for i in range(offset, len(ys)):
        if target_label is not None and ys[i] != target_label:
            continue
        row = (i, xs[i], label_dtype(ys[i]))
        if load_target:
            row = row + (label_dtype(targets[i]),)
        yield row


# ---------------------------------------------------------------------------
# ImageNet val (`ares/dataset/imagenet.py`)
# ---------------------------------------------------------------------------


def _load_label_txt(path: str, label_offset: int) -> tuple[list, list]:
    """`imagenet.py:_load_txt:105-113`: lines of `<filename> <label>`."""
    filenames, labels = [], []
    with open(path) as txt:
        for line in txt:
            line = line.strip("\n")
            if not line:
                continue
            filename, label = line.split(" ")
            filenames.append(filename)
            labels.append(int(label) + label_offset)
    return filenames, labels


def _load_image(path: str, to_height: int, to_width: int, clip: bool) -> np.ndarray:
    """`imagenet.py:_load_image:88-102` semantics: grayscale→RGB, optional
    0.875 center crop (shorter side), resize to (h, w), uint8."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    if clip:
        width, height = img.size  # PIL is (w, h)
        center = int(0.875 * min(height, width))
        top = (height - center + 1) // 2
        left = (width - center + 1) // 2
        img = img.crop((left, top, left + center, top + center))
    img = img.resize((to_width, to_height), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_imagenet_val(
    root: str,
    height: int,
    width: int,
    *,
    offset: int = 0,
    label_dtype=np.int32,
    load_target: bool = False,
    target_label: Optional[int] = None,
    clip: bool = True,
    label_offset: int = 0,
    val_txt: str = "val.txt",
    target_txt: str = "target.txt",
    image_dir: str = "ILSVRC2012_img_val",
) -> Iterator[tuple]:
    """Yield `(filename, image uint8 [h,w,3], label[, target])` —
    `imagenet.load_dataset:44-85` semantics: labels from `val.txt`, targets
    from `target.txt`, `label_offset` for 1001-class models with an empty
    class 0, `target_label` filters by TRUE label, images center-cropped
    (0.875) then resized."""
    filenames, labels = _load_label_txt(os.path.join(root, val_txt), label_offset)
    filenames, labels = filenames[offset:], labels[offset:]
    targets: Optional[Sequence[int]] = None
    if load_target:
        targets = _load_label_txt(os.path.join(root, target_txt), label_offset)[1]
        targets = targets[offset:]
    img_root = os.path.join(root, image_dir)
    if not os.path.isdir(img_root):
        img_root = root
    for i, (filename, label) in enumerate(zip(filenames, labels)):
        if target_label is not None and label != target_label:
            continue
        image = _load_image(os.path.join(img_root, filename), height, width, clip)
        row = (filename, image, label_dtype(label))
        if load_target:
            row = row + (label_dtype(targets[i]),)
        yield row


# ---------------------------------------------------------------------------
# Classifier scaling + batching (`load_dataset_for_classifier`, utils)
# ---------------------------------------------------------------------------


def load_for_classifier(rows: Iterable[tuple], spec: ImageClassifierSpec) -> Iterator[tuple]:
    """Map raw uint8 rows into the classifier's input contract —
    `cifar10.load_dataset_for_classifier:29-34` /
    `imagenet.load_dataset_for_classifier:36-41`: cast to `x_dtype`, scale
    [0,255] → [x_min, x_max], reshape to `x_shape` (flattened-input models)."""
    scale = (spec.x_max - spec.x_min) / 255.0
    for row in rows:
        row = list(row)
        x = row[1].astype(spec.x_dtype) * scale + spec.x_min
        row[1] = x.reshape(spec.x_shape)
        yield tuple(row)


def as_batches(rows: Iterable[tuple], batch_size: int, *, drop_remainder: bool = False):
    """Stack row tuples into numpy batches (the host-side analog of
    `.batch()` + `dataset_to_iterator`, `ares/dataset/utils.py:4-11`)."""
    buf: list[tuple] = []
    for row in rows:
        buf.append(row)
        if len(buf) == batch_size:
            yield tuple(np.stack([r[j] for r in buf]) for j in range(len(buf[0])))
            buf = []
    if buf and not drop_remainder:
        yield tuple(np.stack([r[j] for r in buf]) for j in range(len(buf[0])))
