"""The model table and weighted ensembles (port of
``pointsecguard_tpu/models/registry.py:17-67,99-162``).

``create(name, **kwargs)`` builds a model by the JAX table's name: the
segmentation victims, the classifiers and the part-segmentation nets.
The ensemble is the capability the ares fork ships as
`ares/model/ensemble.py:9-25` (EnsembleModel) and
`ares/loss/cross_entropy.py:22-38` (EnsembleCrossEntropyLoss): N model
closures combined into one ``outputs_fn`` that the attack engines attack
end to end. ``load_model_from_path`` is read by no ported path and is
left out.
"""

from __future__ import annotations

from typing import Callable

import torch


def _table() -> dict[str, Callable]:
    from pointsecguard_tpu_torch.models import (
        DenseDeepGCN,
        PointNet2ClsMSG,
        PointNet2ClsSSG,
        PointNet2PartSegMSG,
        PointNet2PartSegSSG,
        PointNet2SemSegMSG,
        PointNet2SemSegSSG,
        PointNetCls,
        PointNetPartSeg,
        PointNetSemSeg,
        RandLANet,
    )

    return {
        "pointnet_sem_seg": PointNetSemSeg,
        "pointnet_cls": PointNetCls,
        "pointnet_part_seg": PointNetPartSeg,
        "pointnet2_sem_seg": PointNet2SemSegSSG,
        "pointnet2_sem_seg_msg": PointNet2SemSegMSG,
        "pointnet2_cls_ssg": PointNet2ClsSSG,
        "pointnet2_cls_msg": PointNet2ClsMSG,
        "pointnet2_part_seg_ssg": PointNet2PartSegSSG,
        "pointnet2_part_seg_msg": PointNet2PartSegMSG,
        "randla": RandLANet,
        "resgcn": DenseDeepGCN,
    }


def create(name: str, **kwargs):
    """A model of the table by name."""
    table = _table()
    if name not in table:
        raise KeyError(f"unknown model '{name}'; known: {sorted(table)}")
    return table[name](**kwargs)


def ensemble_outputs(outputs: list[torch.Tensor], *, from_log_probs: bool = False
                     ) -> torch.Tensor:
    """The log of the members' mean softmax (or, ``from_log_probs``, of
    their mean ``exp``), plus 1e-12."""
    probs = [torch.exp(o) if from_log_probs else torch.softmax(o, dim=-1) for o in outputs]
    return torch.log(torch.mean(torch.stack(probs), dim=0) + 1e-12)


def ensemble_outputs_fn(
    fns: list[Callable[[torch.Tensor], torch.Tensor]],
    weights: list[float] | None = None,
    *,
    mode: str = "probs",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Combine N closures points [B, N, C] → per-point outputs [B, N, K]
    (logits or log-probs) into one differentiable closure. ``weights``
    default to uniform and are normalised to sum to 1.

    ``mode="probs"``: the log of the weighted softmax mixture plus 1e-12,
    the deployed EnsembleModel's decision distribution (`ensemble.py:23-24`).
    ``mode="log_probs"``: the weighted mean of the members' log-softmaxes;
    the engines' CE on top is EnsembleCrossEntropyLoss's Σᵢ wᵢ·CEᵢ plus the
    mixture's label-independent log-normaliser.
    """
    if weights is None:
        weights = [1.0] * len(fns)
    if len(weights) != len(fns):
        raise ValueError(f"{len(fns)} models but {len(weights)} weights")
    total = float(sum(weights))
    ws = [float(w) / total for w in weights]

    def combined(points: torch.Tensor) -> torch.Tensor:
        if mode == "probs":
            p = sum(w * torch.softmax(fn(points), dim=-1) for fn, w in zip(fns, ws))
            return torch.log(p + 1e-12)
        if mode == "log_probs":
            return sum(w * torch.log_softmax(fn(points), dim=-1) for fn, w in zip(fns, ws))
        raise ValueError(f"unknown ensemble mode '{mode}'")

    return combined
