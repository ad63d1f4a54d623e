"""PartNet dataset loader (a copy of ``pointsecguard_tpu/data/partnet.py``;
``h5py`` is imported when a dataset loads, not with the module).

Numpy equivalent of the reference's `ResGCN/utils/data_util.py:79-215`
``PartNet(InMemoryDataset)``: fine-grained part-semantic point clouds
distributed as h5 bundles (application-gated download, so only the
on-disk layout is handled here, exactly as the reference's `download()`
raises for a missing archive).

Layout and keys follow the reference:

- ``sem_seg_h5`` (`data_util.py:191-214`): files
  ``<root>/raw/sem_seg_h5/<Category>-<level>/<phase>-*.h5`` with
  datasets ``data`` [B, N, 3] float and ``label_seg`` [B, N] int;
- ``ins_seg_h5`` (`data_util.py:165-190`): files under
  ``<root>/raw/ins_seg_h5_for_sgpn/ins_seg_h5/<Category>/<phase>-*.h5``
  with ``pts``/``label``/``nor``/``opacity``/``rgb``; per-cloud features
  are ``[opacity | rgb/255]`` appended after the normals, matching the
  reference's ``Data(pos, y, norm, x)`` assembly.

The torch_geometric ``.pt`` collate cache is storage plumbing, not
behavior — clouds load straight from h5 into numpy here (fast enough,
and keeps torch out of the data path).
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PartNetDataset:
    """Clouds of one PartNet category/level/phase.

    Attributes after load: ``pos`` list of [N, 3] float32, ``labels``
    list of [N] int32, and for ins_seg ``normals`` / ``feats``
    ([opacity | rgb/255], [N, 4]).
    """

    root: str
    dataset: str = "sem_seg_h5"
    obj_category: str = "Bed"
    level: int = 3
    phase: str = "train"
    pos: list = field(default_factory=list)
    labels: list = field(default_factory=list)
    normals: list = field(default_factory=list)
    feats: list = field(default_factory=list)

    def __post_init__(self):
        try:
            import h5py
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "PartNet loading needs h5py (the reference reads the "
                "same h5 bundles, `data_util.py:203`)"
            ) from e

        if self.dataset == "sem_seg_h5":
            obj = f"{self.obj_category}-{self.level}"
            folder = os.path.join(self.root, "raw", self.dataset, obj)
            paths = sorted(
                _glob.glob(os.path.join(folder, f"{self.phase}-*.h5"))
            )
        elif self.dataset == "ins_seg_h5":
            folder = os.path.join(
                self.root, "raw", "ins_seg_h5_for_sgpn", self.dataset,
                self.obj_category,
            )
            paths = sorted(
                _glob.glob(os.path.join(folder, f"{self.phase}-*.h5"))
            )
        else:
            raise ValueError(f"unknown PartNet variant {self.dataset!r}")
        if not paths:
            # mirrors `data_util.py:144-147`: the archive is
            # application-gated, never auto-downloaded
            raise FileNotFoundError(
                f"no PartNet h5 files under {folder} — PartNet can only "
                "be downloaded via application "
                "(https://cs.stanford.edu/~kaichun/partnet/)"
            )
        for path in paths:
            with h5py.File(path, "r") as f:
                if self.dataset == "sem_seg_h5":
                    pts = np.asarray(f["data"], np.float32)
                    labs = np.asarray(f["label_seg"], np.int32)
                    for p, l in zip(pts, labs):
                        self.pos.append(p[:, :3])
                        self.labels.append(l)
                else:
                    pts = np.asarray(f["pts"], np.float32)
                    labs = np.asarray(f["label"], np.int32)
                    nor = np.asarray(f["nor"], np.float32)
                    opa = np.asarray(f["opacity"], np.float32)
                    rgb = np.asarray(f["rgb"], np.float32)
                    for i in range(len(pts)):
                        self.pos.append(pts[i][:, :3])
                        self.labels.append(labs[i])
                        self.normals.append(nor[i][:, :3])
                        self.feats.append(
                            np.concatenate(
                                [opa[i][:, None], rgb[i] / 255.0], axis=1
                            ).astype(np.float32)
                        )

    def __len__(self) -> int:
        return len(self.pos)

    def __getitem__(self, i: int):
        if self.dataset == "ins_seg_h5":
            return self.pos[i], self.labels[i], self.normals[i], self.feats[i]
        return self.pos[i], self.labels[i]

    @property
    def num_classes(self) -> int:
        return int(max(int(l.max()) for l in self.labels)) + 1

    def batches(self, rng: np.random.Generator, batch_size: int):
        """Yield ([B, N, 3] pos, [B, N] labels) per epoch (shuffled;
        clouds in one PartNet bundle share N, as in the reference's
        DenseDataLoader usage)."""
        order = rng.permutation(len(self))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[s : s + batch_size]
            yield (
                np.stack([self.pos[i] for i in idx]),
                np.stack([self.labels[i] for i in idx]),
            )
