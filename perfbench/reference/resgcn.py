"""ResGCN-28 semantic segmentation, plain (lightaime/deep_gcns_torch
``examples/sem_seg_dense/architecture.py`` ``DenseDeepGCN`` over
``gcn_lib/dense``, the settings of PointSecGuard's
``ResGCN/sem_seg_dense/config.py``).

Input [B, N, 9]; the head EdgeConv over the 16-NN graph of xyz; then
n_blocks − 1 residual dynamic EdgeConv blocks, block i over the graph of
every (1 + i)-th of the 16 · (1 + i) nearest points in the current
feature space (the point itself included); the fusion conv over all the
blocks' features, its maximum over the points, broadcast and
concatenated; two prediction convs and the classifier; output logits.
Every conv but the classifier is Linear → ReLU → BatchNorm, in that
order; EdgeConv's input is [x_i, x_j − x_i] and its output the maximum
over the neighbours. The state dict is keyed as the port keys it.
"""

from __future__ import annotations

import torch

from perfbench.reference import geometry as geo
from perfbench.reference.layers import batch_norm, linear


def _convs(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, fan_in, width) of every Linear, in the port's order."""
    f, n = cfg["n_filters"], cfg["n_blocks"]
    fused = f * n
    out = [("head.nn", 2 * cfg["in_channels"], f)]
    out += [(f"backbone.{i}.conv.nn", 2 * f, f) for i in range(n - 1)]
    out.append(("fusion", fused, cfg["fusion"]))
    width = cfg["fusion"] + fused
    for j, w in enumerate(cfg["pred"]):
        out.append((f"pred.{j}", width, w))
        width = w
    out.append(("cls", width, cfg["num_classes"]))
    return out


def param_spec(cfg: dict) -> list[tuple[str, tuple, int, str]]:
    """(name, shape, fan_in, role) of every state entry (see
    ``pointnet2_ssg.param_spec``)."""
    spec = []
    for name, fan_in, width in _convs(cfg):
        spec += [(f"{name}.dense.weight", (width, fan_in), fan_in, "weight"),
                 (f"{name}.dense.bias", (width,), fan_in, "bias")]
        if name != "cls":
            spec += [(f"{name}.bn.{leaf}", (width,), fan_in, f"bn_{leaf}")
                     for leaf in ("scale", "bias", "mean", "var")]
    return spec


def _basic(x, state, name, stats):
    return batch_norm(torch.relu(linear(x, state, name + ".dense")), state, name + ".bn", stats)


def _edge_conv(x, idx, state, name, stats):
    x_j = geo.gather_points(x, idx)
    x_i = x[:, :, None, :].expand_as(x_j)
    return torch.amax(_basic(torch.cat([x_i, x_j - x_i], dim=-1), state, name, stats), dim=2)


def plan(points: torch.Tensor, cfg: dict) -> None:
    """ResGCN builds its graphs inside every forward: no plan."""
    return None


def forward(state: dict, points: torch.Tensor, cfg: dict, geometry=None,
            stats: dict | None = None, graphs: list | None = None) -> torch.Tensor:
    """Logits [B, N, classes] (float32); ``stats`` as in
    ``layers.batch_norm``; ``graphs``, where given, receives the head's
    graph and then each block's, [B, N, k] each."""
    k = cfg["k"]
    graphs = [] if graphs is None else graphs
    graphs.append(geo.knn_graph(points[..., :3], k))
    feats = [_edge_conv(points, graphs[-1], state, "head.nn", stats)]
    for i in range(cfg["n_blocks"] - 1):
        x = feats[-1]
        idx = geo.dilated_knn_graph(x, k, 1 + i)
        graphs.append(idx)
        feats.append(_edge_conv(x, idx, state, f"backbone.{i}.conv.nn", stats) + x)
    h = torch.cat(feats, dim=-1)
    fusion = torch.amax(_basic(h, state, "fusion", stats), dim=1, keepdim=True)
    x = torch.cat([fusion.expand(-1, h.shape[1], -1), h], dim=-1)
    for j in range(len(cfg["pred"])):
        x = _basic(x, state, f"pred.{j}", stats)
    return linear(x, state, "cls.dense").float()


def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over every point of the batch."""
    lp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
    return -torch.mean(torch.gather(lp, 1, labels.reshape(-1, 1).long()))


def forward_flops(cfg: dict, points: int) -> int:
    """Multiply-adds × 2 of every Linear of one block's forward at
    ``points`` points: the head and block EdgeConvs on points × k edges,
    the fusion, prediction and classifier convs on the points."""
    total = 0
    for name, fan_in, width in _convs(cfg):
        rows = points * cfg["k"] if name.startswith(("head", "backbone")) else points
        total += 2 * rows * fan_in * width
    return total
