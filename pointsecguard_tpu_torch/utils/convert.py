"""Weights between the JAX package's flax variables and the port.

Weights cross as numpy arrays keyed by flax paths, flattened with "/":
``params/SetAbstraction_0/PointMLP_0/PointConv_0/Dense_0/kernel``,
``batch_stats/.../BatchNorm_0/mean`` … (134 leaves for PointNet++ SSG).
The module names follow the flax auto-names the JAX importer writes
(`pointsecguard_tpu/utils/importers.py:83-118`):

  SetAbstraction_i → sa.i        FeaturePropagation_i → fp.i
  PointMLP_0 (top) → head        PointMLP_0 (nested)  → mlp
  PointConv_j      → convs.j     BatchNorm_0          → bn
  Dense_0 (top)    → cls         Dense_0 (nested)     → dense

Dense kernels are [in, out] in flax and [out, in] in ``nn.Linear``.
"""

from __future__ import annotations

import numpy as np
import torch

from pointsecguard_tpu_torch.models.pointnet2 import PointNet2SemSegSSG

_INDEXED = {"SetAbstraction": "sa", "FeaturePropagation": "fp",
            "PointConv": "convs"}
_LEAF_COLLECTION = {"kernel": "params", "bias": "params", "scale": "params",
                    "mean": "batch_stats", "var": "batch_stats"}


def _port_key(path: str) -> str:
    collection, *mods, leaf = path.split("/")
    if _LEAF_COLLECTION.get(leaf) != collection:
        raise KeyError(f"unexpected leaf {path!r}")
    parts = []
    for depth, mod in enumerate(mods):
        name, _, idx = mod.rpartition("_")
        if name in _INDEXED:
            parts += [_INDEXED[name], idx]
        elif name == "PointMLP":
            parts.append("head" if depth == 0 else "mlp")
        elif name == "Dense":
            parts.append("cls" if depth == 0 else "dense")
        elif name == "BatchNorm":
            parts.append("bn")
        else:
            raise KeyError(f"unknown flax module {mod!r} in {path!r}")
    parts.append("weight" if leaf == "kernel" else leaf)
    return ".".join(parts)


_INDEXED_INV = {v: k for k, v in _INDEXED.items()}
_NAMED_INV = {"head": "PointMLP_0", "mlp": "PointMLP_0", "cls": "Dense_0",
              "dense": "Dense_0", "bn": "BatchNorm_0"}


def _flax_path(key: str) -> str:
    *mods, leaf = key.split(".")
    out, i = [], 0
    while i < len(mods):
        if mods[i] in _INDEXED_INV:
            out.append(f"{_INDEXED_INV[mods[i]]}_{mods[i + 1]}")
            i += 2
        else:
            out.append(_NAMED_INV[mods[i]])
            i += 1
    flax_leaf = "kernel" if leaf == "weight" else leaf
    return "/".join([_LEAF_COLLECTION[flax_leaf], *out, flax_leaf])


def from_jax_variables(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax variables → a ``PointNet2SemSegSSG`` state dict.

    Raises ValueError unless every leaf is consumed and every tensor of
    the port model is filled with the right shape."""
    sd: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        if path.endswith("/kernel"):
            arr = arr.T
        sd[_port_key(path)] = torch.from_numpy(np.array(arr, order="C"))
    num_classes = sd["cls.weight"].shape[0] if "cls.weight" in sd else 13
    template = PointNet2SemSegSSG(num_classes=num_classes).state_dict()
    missing = sorted(set(template) - set(sd))
    extra = sorted(set(sd) - set(template))
    if missing or extra:
        raise ValueError(f"flax leaves do not fill the port model: "
                         f"missing {missing}, unconsumed {extra}")
    bad = [k for k in template if template[k].shape != sd[k].shape]
    if bad:
        raise ValueError(f"shape mismatch for {bad}")
    return sd


def to_jax_variables(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``from_jax_variables``: state dict → flat flax leaves."""
    flat = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        flat[_flax_path(key)] = arr.T.copy() if key.endswith(".weight") else arr.copy()
    return flat
