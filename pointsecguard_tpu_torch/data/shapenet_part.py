"""ShapeNetPart part-segmentation dataset, numpy (a copy of
``pointsecguard_tpu/data/shapenet_part.py:28-231``: the category table,
the parse cache, the splits and ``class_choice`` filter, the
resample-with-replacement load, ``batches`` and the synthetic fixture,
with the same RNG calls, so that the same generator state gives the same
shapes and batches).

The on-disk format is the public
``shapenetcore_partanno_segmentation_benchmark_v0_normal``:

- ``synsetoffset2category.txt`` — ``<Category>\\t<synset>`` rows,
- ``train_test_split/shuffled_{train,val,test}_file_list.json`` —
  ``shape_data/<synset>/<token>`` entries,
- ``<synset>/<token>.txt`` — whitespace ``x y z nx ny nz seg`` rows with
  global part ids (0..49 over the 16 categories).

Every sample is exactly ``num_point`` points, drawn with replacement (the
upstream rule), xyz normalised into the unit sphere over the whole file;
batches are [B, N, 6 or 3] float32, [B] int32 categories and [B, N] int32
part labels.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pointsecguard_tpu_torch.data.modelnet import pc_normalize

# category → global part-label ids (the public 16 / 50 table the part-seg
# models' 50-way head assumes)
SEG_CLASSES: dict[str, list[int]] = {
    "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7],
    "Car": [8, 9, 10, 11], "Chair": [12, 13, 14, 15],
    "Earphone": [16, 17, 18], "Guitar": [19, 20, 21], "Knife": [22, 23],
    "Lamp": [24, 25, 26, 27], "Laptop": [28, 29],
    "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37],
    "Pistol": [38, 39, 40], "Rocket": [41, 42, 43],
    "Skateboard": [44, 45, 46], "Table": [47, 48, 49],
}
NUM_PART_CLASSES = 50
NUM_OBJECT_CLASSES = 16

# a category's index is its position in the sorted full table, so that a
# tree holding a subset of the categories one-hot-encodes as the models'
# 16-way conditioning input expects
CATEGORY_INDEX = {name: i for i, name in enumerate(sorted(SEG_CLASSES))}


class ShapeNetPartDataset:
    """Index-addressable ShapeNetPart shapes with epoch batch iteration."""

    def __init__(self, root: str, split: str = "train", *, num_point: int = 2048,
                 use_normals: bool = True, class_choice: list[str] | None = None,
                 cache: bool = True):
        if split not in ("train", "val", "test", "trainval"):
            raise ValueError(f"bad split {split!r}")
        self.root = root
        self.num_point = num_point
        self.use_normals = use_normals
        # parsed-file cache: text parsing dominates the host cost of an
        # epoch; the full dataset's normalised arrays are about 1.2 GB
        self._cache: dict[int, np.ndarray] | None = {} if cache else None
        cat_of_synset: dict[str, str] = {}
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            for ln in f:
                if ln.strip():
                    name, synset = ln.split()
                    cat_of_synset[synset] = name
        entries: list[str] = []
        for s in (("train", "val") if split == "trainval" else (split,)):
            with open(os.path.join(root, "train_test_split",
                                   f"shuffled_{s}_file_list.json")) as f:
                entries.extend(json.load(f))
        self.paths: list[str] = []
        self.categories: list[str] = []
        for e in entries:
            _, synset, token = e.split("/")
            cat = cat_of_synset[synset]
            if class_choice is not None and cat not in class_choice:
                continue
            self.paths.append(os.path.join(root, synset, f"{token}.txt"))
            self.categories.append(cat)
        self.cls_labels = np.array([CATEGORY_INDEX[c] for c in self.categories], np.int32)

    def __len__(self) -> int:
        return len(self.paths)

    def _parse(self, i: int) -> np.ndarray:
        """The whole file, xyz normalised into the unit sphere (cached;
        callers must not mutate it). The normalisation runs on the whole
        cloud before any sampling (the upstream order), so it does not
        depend on the subset drawn."""
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        raw = np.loadtxt(self.paths[i], dtype=np.float32)
        if raw.ndim == 1:
            raw = raw[None, :]
        raw[:, :3] = pc_normalize(raw[:, :3])
        if self._cache is not None:
            self._cache[i] = raw
        return raw

    def load(self, i: int, rng: np.random.Generator | None = None
             ) -> tuple[np.ndarray, int, np.ndarray]:
        """→ (points [num_point, 6 or 3], category id, part labels
        [num_point]): ``num_point`` rows drawn with replacement from
        ``rng``, or without one the rows in file order, repeated from the
        start to fill up (the evaluation's fixed subset)."""
        raw = self._parse(i)
        if rng is not None:
            choice = rng.integers(0, raw.shape[0], self.num_point)
        else:
            choice = np.arange(self.num_point) % raw.shape[0]
        raw = raw[choice]
        pts, seg = raw[:, :6], raw[:, 6].astype(np.int32)
        if not self.use_normals:
            pts = pts[:, :3]
        return pts, int(self.cls_labels[i]), seg

    def batches(self, rng: np.random.Generator, batch_size: int, *, shuffle: bool = True,
                drop_last: bool = True, resample: bool = True):
        """Yield (points [B, N, C], categories [B] int32, part labels
        [B, N] int32)."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, stop, batch_size):
            idx = order[s : s + batch_size]
            if len(idx) < batch_size and not drop_last:
                # tiled, so that batch_size > 2 · len(dataset) still fills up
                idx = np.concatenate([idx, np.resize(order, batch_size - len(idx))])
            loaded = [self.load(i, rng if resample else None) for i in idx]
            yield (np.stack([l[0] for l in loaded]),
                   np.array([l[1] for l in loaded], np.int32),
                   np.stack([l[2] for l in loaded]))


# the fixture's categories: real names, synsets and part ids (a subset of
# the public table), so that SEG_CLASSES and the 50-way head apply as they are
_SYNTH_CATS = {
    "Knife": "03624134",  # 2 parts [22, 23]
    "Earphone": "03261776",  # 3 parts [16, 17, 18]
    "Table": "04379243",  # 3 parts [47, 48, 49]
}


def _synth_part_shape(rng: np.random.Generator, cat: str, n: int) -> np.ndarray:
    """A jittered ellipsoid shell cut into its category's parts along z
    (so that the parts can be learnt from the geometry): rows ``x y z nx
    ny nz seg``."""
    parts = SEG_CLASSES[cat]
    xyz = rng.normal(size=(n, 3))
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True) + 1e-12
    xyz *= rng.uniform(0.8, 1.2, (1, 3))  # per-shape anisotropy
    nrm = xyz / (np.linalg.norm(xyz, axis=1, keepdims=True) + 1e-12)
    edges = np.quantile(xyz[:, 2], np.linspace(0, 1, len(parts) + 1)[1:-1])
    seg = np.array(parts, np.float32)[np.searchsorted(edges, xyz[:, 2])]
    return np.concatenate([xyz + rng.normal(0, 0.01, xyz.shape), nrm, seg[:, None]], axis=1)


def make_synthetic_shapenetpart(out_dir: str, *, points_per_shape: int = 600,
                                train_per_class: int = 6, val_per_class: int = 1,
                                test_per_class: int = 2, seed: int = 0) -> list[str]:
    """Write a part-separable fixture of three categories in the real
    v0_normal layout, so that the loader parses actual files. Returns the
    shape file paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "train_test_split"), exist_ok=True)
    with open(os.path.join(out_dir, "synsetoffset2category.txt"), "w") as f:
        for cat, synset in _SYNTH_CATS.items():
            f.write(f"{cat}\t{synset}\n")
    written = []
    lists = {"train": [], "val": [], "test": []}
    counts = {"train": train_per_class, "val": val_per_class, "test": test_per_class}
    for cat, synset in _SYNTH_CATS.items():
        os.makedirs(os.path.join(out_dir, synset), exist_ok=True)
        i = 0
        for split, cnt in counts.items():
            for _ in range(cnt):
                i += 1
                token = f"{cat.lower()}_{i:04d}"
                path = os.path.join(out_dir, synset, f"{token}.txt")
                np.savetxt(path, _synth_part_shape(rng, cat, points_per_shape), fmt="%.6f")
                lists[split].append(f"shape_data/{synset}/{token}")
                written.append(path)
    for split, entries in lists.items():
        with open(os.path.join(out_dir, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(entries, f)
    return written
