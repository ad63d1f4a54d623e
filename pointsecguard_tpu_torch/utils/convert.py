"""Weights between the JAX package's flax variables and the port.

Weights cross as numpy arrays keyed by flax paths, flattened with "/":
``params/SetAbstraction_0/PointMLP_0/PointConv_0/Dense_0/kernel``,
``batch_stats/.../BatchNorm_0/mean`` … (134 leaves for PointNet++ SSG,
206 for MSG, 102 for PointNet, 276 for RandLA-Net, 188 for ResGCN-28).
The classifiers (``cls_from_jax_variables`` / ``cls_to_jax_variables``:
PointNet++ SSG and MSG, PointNet) map their levels as the segmentation
nets do and their head ``_ClsHead_0/Dense_j`` → ``head.fc.j`` (PointNet's
top-level ``Dense_j`` → ``fc.j``).
PointNet++ SSG
(``from_jax_variables``) follows the flax auto-names the JAX importer writes
(`pointsecguard_tpu/utils/importers.py:83-118`):

  SetAbstraction_i → sa.i        FeaturePropagation_i → fp.i
  PointMLP_0 (top) → head        PointMLP_0 (nested)  → mlp
  PointConv_j      → convs.j     BatchNorm_0          → bn
  Dense_0 (top)    → cls         Dense_0 (nested)     → dense

RandLA-Net (``randla_from_jax_variables``) maps module paths one to one
(``randla_module_map``), in the flax declaration order of
`pointsecguard_tpu/models/randlanet.py:252-254` and the schema of
`utils/importers.py:461-579 map_randla_vars`; ResGCN
(``resgcn_from_jax_variables``, 188 leaves at full width), PointNet++
MSG (``pointnet2_msg_from_jax_variables``: ``SetAbstractionMSG_i/
PointMLP_j`` → ``sa.i.mlps.j``) and PointNet (``pointnet_from_jax_variables``:
``PointNetEncoder_0/STN_0|STN_1`` → ``feat.stn|fstn``) likewise
(``resgcn_module_map``, ``pointnet2_msg_module_map``, ``pointnet_module_map``).

Dense kernels are [in, out] in flax and [out, in] in ``nn.Linear``.
"""

from __future__ import annotations

import numpy as np
import torch

from pointsecguard_tpu_torch.models.pointnet2 import PointNet2SemSegSSG
from pointsecguard_tpu_torch.models.randlanet import RandLANet

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


def _conv(m: dict, flax: str, port: str) -> None:
    """A flax ``PointConv`` is two entries: its ``Dense_0`` and ``BatchNorm_0``."""
    m[f"{flax}/Dense_0"] = f"{port}.dense"
    m[f"{flax}/BatchNorm_0"] = f"{port}.bn"


def randla_module_map(num_layers: int = 5) -> dict[str, str]:
    """flax module path → ``RandLANet`` module path."""
    m = {"Dense_0": "fc0", "BatchNorm_0": "bn0", "Dense_1": "fc"}
    for i in range(num_layers):
        blk, pblk = f"DilatedResBlock_{i}", f"blocks.{i}"
        lfa, plfa = f"{blk}/LocalFeatureAggregation_0", f"{pblk}.lfa"
        _conv(m, f"{blk}/PointConv_0", f"{pblk}.mlp1")
        _conv(m, f"{lfa}/PointConv_0", f"{plfa}.mlp1")
        _conv(m, f"{lfa}/PointConv_1", f"{plfa}.mlp2")
        for a in (0, 1):
            ap, pap = f"{lfa}/AttentivePooling_{a}", f"{plfa}.att_pooling_{a + 1}"
            m[f"{ap}/Dense_0"] = f"{pap}.fc"
            _conv(m, f"{ap}/PointConv_0", f"{pap}.mlp")
        _conv(m, f"{blk}/PointConv_1", f"{pblk}.mlp2")
        _conv(m, f"{blk}/PointConv_2", f"{pblk}.shortcut")
    _conv(m, "PointConv_0", "decoder_0")
    for j in range(num_layers):
        _conv(m, f"PointConv_{1 + j}", f"decoders.{j}")
    _conv(m, f"PointConv_{1 + num_layers}", "fc1")
    _conv(m, f"PointConv_{2 + num_layers}", "fc2")
    return m


def _randla_shape(flat: dict) -> dict:
    """RandLANet constructor arguments read off the flax leaves."""
    d_out, i = [], 0
    while f"params/DilatedResBlock_{i}/PointConv_1/Dense_0/kernel" in flat:
        d_out.append(flat[f"params/DilatedResBlock_{i}/PointConv_1/Dense_0/kernel"].shape[0])
        i += 1
    return {"num_classes": flat["params/Dense_1/kernel"].shape[1],
            "d_out": tuple(d_out), "d_in": flat["params/Dense_0/kernel"].shape[0]}


def randla_from_jax_variables(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax variables of ``RandLANet`` → the port's state dict.

    Raises ValueError unless every leaf is consumed and every tensor of
    the port model is filled with the right shape."""
    shape = _randla_shape(flat)
    return _filled(flat, randla_module_map(len(shape["d_out"])), RandLANet(**shape))


def randla_to_jax_variables(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``randla_from_jax_variables``: state dict → flat flax
    leaves."""
    num_layers = len({k.split(".")[1] for k in state_dict if k.startswith("blocks.")})
    return _inverse_mapped(state_dict, randla_module_map(num_layers))


def _mapped_state_dict(flat: dict, modules: dict[str, str]):
    """(state dict, unmapped flax paths) of flat flax leaves under a module
    map (flax module path → port module path)."""
    sd: dict[str, torch.Tensor] = {}
    unmapped = []
    for path, value in flat.items():
        collection, _, rest = path.partition("/")
        mod, _, leaf = rest.rpartition("/")
        if mod not in modules or _LEAF_COLLECTION.get(leaf) != collection:
            unmapped.append(path)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            arr = arr.T
        key = f"{modules[mod]}.{'weight' if leaf == 'kernel' else leaf}"
        sd[key] = torch.from_numpy(np.array(arr, order="C"))
    return sd, unmapped


def _filled(flat: dict, modules: dict[str, str], model) -> dict[str, torch.Tensor]:
    """The state dict of ``model`` from flat flax leaves under a module map.

    Raises ValueError unless every leaf is consumed and every tensor of
    the port model is filled with the right shape."""
    sd, unmapped = _mapped_state_dict(flat, modules)
    template = model.state_dict()
    missing = sorted(set(template) - set(sd))
    if unmapped or missing:
        raise ValueError(f"flax leaves do not fill the port model: "
                         f"missing {missing}, unconsumed {sorted(unmapped)}")
    bad = [k for k in template if template[k].shape != sd[k].shape]
    if bad:
        raise ValueError(f"shape mismatch for {bad}")
    return sd


def _inverse_mapped(state_dict: dict, modules: dict[str, str]) -> dict[str, np.ndarray]:
    """Flat flax leaves of a state dict under a module map."""
    inverse = {v: k for k, v in modules.items()}
    flat = {}
    for key, t in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        flax_leaf = "kernel" if leaf == "weight" else leaf
        arr = t.detach().cpu().numpy()
        flat[f"{_LEAF_COLLECTION[flax_leaf]}/{inverse[mod]}/{flax_leaf}"] = (
            arr.T.copy() if leaf == "weight" else arr.copy())
    return flat


def resgcn_module_map(n_blocks: int = 28, conv: str = "edge") -> dict[str, str]:
    """flax module path → ``DenseDeepGCN`` module path, over the flax
    auto-names of `pointsecguard_tpu/models/resgcn.py:210-307`: the head
    ``EdgeConv_0`` (``MRConv_0``), ``DynConv_{i}`` for the backbone, and
    ``BasicConv_0..3`` for the fusion, the two prediction convs and the
    classifier (which has no BatchNorm)."""
    g = {"edge": "EdgeConv", "mr": "MRConv"}[conv]
    m = {}

    def basic(flax: str, port: str, norm: bool = True) -> None:
        m[f"{flax}/Dense_0"] = f"{port}.dense"
        if norm:
            m[f"{flax}/BatchNorm_0"] = f"{port}.bn"

    basic(f"{g}_0/BasicConv_0", "head.nn")
    for i in range(n_blocks - 1):
        basic(f"DynConv_{i}/{g}_0/BasicConv_0", f"backbone.{i}.conv.nn")
    for j, port in enumerate(("fusion", "pred.0", "pred.1")):
        basic(f"BasicConv_{j}", port)
    basic("BasicConv_3", "cls", norm=False)
    return m


def _resgcn_shape(flat: dict) -> dict:
    """``DenseDeepGCN`` constructor arguments read off the flax leaves (res
    and plain have the same leaves: the template takes res)."""
    conv = "mr" if any(p.startswith("params/MRConv_0/") for p in flat) else "edge"
    g = {"edge": "EdgeConv", "mr": "MRConv"}[conv]
    head = flat[f"params/{g}_0/BasicConv_0/Dense_0/kernel"]
    n_blocks = 1
    while f"params/DynConv_{n_blocks - 1}/{g}_0/BasicConv_0/Dense_0/kernel" in flat:
        n_blocks += 1
    dense = (n_blocks > 2 and flat[f"params/DynConv_1/{g}_0/BasicConv_0/Dense_0/kernel"]
             .shape[0] > 2 * head.shape[1])
    return {"num_classes": flat["params/BasicConv_3/Dense_0/kernel"].shape[1],
            "in_channels": head.shape[0] // 2, "n_blocks": n_blocks,
            "n_filters": head.shape[1], "conv": conv, "block": "dense" if dense else "res"}


def resgcn_from_jax_variables(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax variables of ``DenseDeepGCN`` → the port's state dict
    (188 leaves at full width).

    Raises ValueError unless every leaf is consumed and every tensor of
    the port model is filled with the right shape."""
    from pointsecguard_tpu_torch.models.resgcn import DenseDeepGCN

    shape = _resgcn_shape(flat)
    return _filled(flat, resgcn_module_map(shape["n_blocks"], shape["conv"]),
                   DenseDeepGCN(**shape))


def resgcn_to_jax_variables(state_dict: dict[str, torch.Tensor],
                            conv: str = "edge") -> dict[str, np.ndarray]:
    """Inverse of ``resgcn_from_jax_variables``: state dict → flat flax
    leaves. ``conv`` names the graph conv, which the port's keys do not
    show (the flax names do)."""
    n_blocks = 1 + len({k.split(".")[1] for k in state_dict if k.startswith("backbone.")})
    return _inverse_mapped(state_dict, resgcn_module_map(n_blocks, conv))



def _num_classes(flat: dict) -> int:
    """The classifier's width (``Dense_0`` at the top), 13 without one."""
    kernel = flat.get("params/Dense_0/kernel")
    return 13 if kernel is None else kernel.shape[1]


def pointnet2_msg_module_map() -> dict[str, str]:
    """flax module path → ``PointNet2SemSegMSG`` module path
    (`pointsecguard_tpu/models/pointnet2.py:254-306`): one ``PointMLP`` per
    radius of each ``SetAbstractionMSG``, then SSG's FP stack and head."""
    from pointsecguard_tpu_torch.models.pointnet2 import MSG_SA_MLPS, SSG_FP_MLPS

    m = {"Dense_0": "cls"}
    for i, mlps in enumerate(MSG_SA_MLPS):
        for j, mlp in enumerate(mlps):
            for k in range(len(mlp)):
                _conv(m, f"SetAbstractionMSG_{i}/PointMLP_{j}/PointConv_{k}",
                      f"sa.{i}.mlps.{j}.convs.{k}")
    for i, mlp in enumerate(SSG_FP_MLPS):
        for k in range(len(mlp)):
            _conv(m, f"FeaturePropagation_{i}/PointMLP_0/PointConv_{k}",
                  f"fp.{i}.mlp.convs.{k}")
    _conv(m, "PointMLP_0/PointConv_0", "head.convs.0")
    return m


def pointnet2_msg_from_jax_variables(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax variables of ``PointNet2SemSegMSG`` → the port's state dict
    (206 leaves). Raises ValueError on a missing or unconsumed leaf."""
    from pointsecguard_tpu_torch.models.pointnet2 import PointNet2SemSegMSG

    num_classes = _num_classes(flat)
    return _filled(flat, pointnet2_msg_module_map(),
                   PointNet2SemSegMSG(num_classes=num_classes))


def pointnet2_msg_to_jax_variables(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``pointnet2_msg_from_jax_variables``."""
    return _inverse_mapped(state_dict, pointnet2_msg_module_map())


def _cls_head(m: dict, flax: str, port: str) -> None:
    """The classifiers' head: ``Dense_0`` / ``BatchNorm_0``, ``Dense_1`` /
    ``BatchNorm_1`` and ``Dense_2`` (flax) → ``fc.j`` / ``bns.j`` and ``cls``."""
    for k in range(2):
        m[f"{flax}Dense_{k}"] = f"{port}fc.{k}"
        m[f"{flax}BatchNorm_{k}"] = f"{port}bns.{k}"
    m[f"{flax}Dense_2"] = f"{port}cls"


def pointnet2_cls_module_map(msg: bool = False) -> dict[str, str]:
    """flax module path → ``PointNet2ClsSSG`` (``msg``: ``PointNet2ClsMSG``)
    module path (`pointsecguard_tpu/models/pointnet2_cls.py:30-104`): the
    two set-abstraction levels (SSG: ``SetAbstraction_0..1``; MSG:
    ``SetAbstractionMSG_0..1``, one ``PointMLP_j`` a radius), the group-all
    ``SetAbstraction`` (SSG ``_2``, MSG ``_0``) and ``_ClsHead_0``."""
    from pointsecguard_tpu_torch.models.pointnet2_cls import (
        CLS_MSG_MLPS,
        CLS_SSG_MLPS,
        GROUP_ALL_MLP,
    )

    m: dict[str, str] = {}
    if msg:
        for i, mlps in enumerate(CLS_MSG_MLPS):
            for j, mlp in enumerate(mlps):
                for k in range(len(mlp)):
                    _conv(m, f"SetAbstractionMSG_{i}/PointMLP_{j}/PointConv_{k}",
                          f"sa.{i}.mlps.{j}.convs.{k}")
        group_all = "SetAbstraction_0"
    else:
        for i, mlp in enumerate(CLS_SSG_MLPS):
            for k in range(len(mlp)):
                _conv(m, f"SetAbstraction_{i}/PointMLP_0/PointConv_{k}", f"sa.{i}.mlp.convs.{k}")
        group_all = "SetAbstraction_2"
    for k in range(len(GROUP_ALL_MLP)):
        _conv(m, f"{group_all}/PointMLP_0/PointConv_{k}", f"sa.2.mlp.convs.{k}")
    _cls_head(m, "_ClsHead_0/", "head.")
    return m


def pointnet_cls_module_map() -> dict[str, str]:
    """flax module path → ``PointNetCls`` module path
    (`pointsecguard_tpu/models/pointnet.py:106-125`): the encoder as in
    ``pointnet_module_map``, then the head's ``Dense_0..2`` and
    ``BatchNorm_0..1``."""
    m = {k: v for k, v in pointnet_module_map().items()
         if k.startswith("PointNetEncoder_0/")}
    _cls_head(m, "", "")
    return m


def _cls_model(name: str, flat: dict):
    """The port classifier that ``flat`` fills: its class count from the
    last Dense, its input width (normals or not) from the first layer."""
    from pointsecguard_tpu_torch.models import PointNet2ClsMSG, PointNet2ClsSSG, PointNetCls

    if name == "pointnet_cls":
        k = flat["params/Dense_2/kernel"].shape[1]
        first = "params/PointNetEncoder_0/STN_0/PointConv_0/Dense_0/kernel"
        return PointNetCls(num_classes=k, normal_channel=flat[first].shape[0] == 6)
    k = flat["params/_ClsHead_0/Dense_2/kernel"].shape[1]
    first = ("params/SetAbstractionMSG_0/PointMLP_0/PointConv_0/Dense_0/kernel"
             if name == "pointnet2_cls_msg"
             else "params/SetAbstraction_0/PointMLP_0/PointConv_0/Dense_0/kernel")
    cls = PointNet2ClsMSG if name == "pointnet2_cls_msg" else PointNet2ClsSSG
    return cls(num_classes=k, normal_channel=flat[first].shape[0] == 6)


def _cls_map(name: str) -> dict[str, str]:
    if name not in ("pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg"):
        raise ValueError(f"unknown classifier {name!r}")
    if name == "pointnet_cls":
        return pointnet_cls_module_map()
    return pointnet2_cls_module_map(msg=name == "pointnet2_cls_msg")


def cls_from_jax_variables(name: str, flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax variables of a classifier (``name``: pointnet_cls,
    pointnet2_cls or pointnet2_cls_msg) → the port's state dict, params and
    BatchNorm statistics. Raises ValueError on a missing or unconsumed
    leaf."""
    modules = _cls_map(name)
    return _filled(flat, modules, _cls_model(name, flat))


def cls_to_jax_variables(name: str, state_dict: dict[str, torch.Tensor]
                         ) -> dict[str, np.ndarray]:
    """Inverse of ``cls_from_jax_variables``."""
    return _inverse_mapped(state_dict, _cls_map(name))


def pointnet_module_map() -> dict[str, str]:
    """flax module path → ``PointNetSemSeg`` module path
    (`pointsecguard_tpu/models/pointnet.py:18-103`): the encoder's two
    ``STN``s (per point ``PointConv_0..2``, then ``Dense_0`` / ``BatchNorm_0``,
    ``Dense_1`` / ``BatchNorm_1`` and ``Dense_2``), its three ``PointConv``s,
    the head's three and its ``Dense_0``."""
    enc = "PointNetEncoder_0"
    m = {"Dense_0": "cls"}
    for flax, port in (("STN_0", "feat.stn"), ("STN_1", "feat.fstn")):
        for k in range(3):
            _conv(m, f"{enc}/{flax}/PointConv_{k}", f"{port}.convs.{k}")
        for k in range(2):
            m[f"{enc}/{flax}/Dense_{k}"] = f"{port}.fc.{k}"
            m[f"{enc}/{flax}/BatchNorm_{k}"] = f"{port}.bns.{k}"
        m[f"{enc}/{flax}/Dense_2"] = f"{port}.out"
    for k in range(3):
        _conv(m, f"{enc}/PointConv_{k}", f"feat.conv{k + 1}")
        _conv(m, f"PointConv_{k}", f"convs.{k}")
    return m


def pointnet_from_jax_variables(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax variables of ``PointNetSemSeg`` → the port's state dict
    (102 leaves). Raises ValueError on a missing or unconsumed leaf."""
    from pointsecguard_tpu_torch.models.pointnet import PointNetSemSeg

    num_classes = _num_classes(flat)
    return _filled(flat, pointnet_module_map(), PointNetSemSeg(num_classes=num_classes))


def pointnet_to_jax_variables(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``pointnet_from_jax_variables``."""
    return _inverse_mapped(state_dict, pointnet_module_map())
