"""PointNet++ SSG semantic segmentation, plain (yanx27/Pointnet_Pointnet2_pytorch
``models/pointnet2_sem_seg.py`` over ``pointnet_util.py``).

Input [B, N, 9] (block-centred xy, z | rgb | room-normalised xyz); four
set-abstraction levels (FPS centres from index 0, the ball query, a
shared MLP of Linear → BatchNorm → ReLU on [centre-relative xyz | features],
the max over the group), four feature-propagation hops (3-NN inverse-distance
interpolation, the skip features first, a shared MLP), the head's
128-wide conv and the classifier; output log-probabilities [B, N, 13].
The sizes come from the configuration file; the state dict is keyed as
the port keys it.
"""

from __future__ import annotations

import torch

from perfbench.reference import geometry as geo
from perfbench.reference.layers import batch_norm, linear


def _mlps(cfg: dict):
    """(prefix, input width, widths) of every shared MLP, in order."""
    widths = [cfg["in_channels"]]
    out = []
    for level, mlp in enumerate(cfg["sa_mlps"]):
        out.append((f"sa.{level}.mlp", 3 + widths[-1], mlp))
        widths.append(mlp[-1])
    up = widths[-1]
    for j, mlp in enumerate(cfg["fp_mlps"]):
        skip = widths[len(cfg["sa_mlps"]) - 1 - j] if j < len(cfg["fp_mlps"]) - 1 else 0
        out.append((f"fp.{j}.mlp", skip + up, mlp))
        up = mlp[-1]
    out.append(("head", up, cfg["head"]))
    return out, cfg["head"][-1]


def param_spec(cfg: dict) -> list[tuple[str, tuple, int, str]]:
    """(name, shape, fan_in, role) of every state entry, in the port's
    order; role is weight, bias, or a BatchNorm entry (bn_scale, bn_bias,
    bn_mean, bn_var)."""
    spec = []
    mlps, last = _mlps(cfg)
    for prefix, width, mlp in mlps:
        for j, out in enumerate(mlp):
            conv = f"{prefix}.convs.{j}"
            spec += [(f"{conv}.dense.weight", (out, width), width, "weight"),
                     (f"{conv}.dense.bias", (out,), width, "bias")]
            spec += [(f"{conv}.bn.{leaf}", (out,), width, f"bn_{leaf}")
                     for leaf in ("scale", "bias", "mean", "var")]
            width = out
    spec += [("cls.weight", (cfg["num_classes"], last), last, "weight"),
             ("cls.bias", (cfg["num_classes"],), last, "bias")]
    return spec


def _mlp(x, state, prefix, depth, stats):
    for j in range(depth):
        conv = f"{prefix}.convs.{j}"
        x = torch.relu(batch_norm(linear(x, state, conv + ".dense"), state, conv + ".bn", stats))
    return x


@torch.no_grad()
def plan(points: torch.Tensor, cfg: dict) -> dict:
    """The geometry from the coordinates alone: per SA level (centres,
    group indices), per FP hop (3-NN indices, weights), l0←l1 first."""
    xyz = points[..., :3].float()
    levels, sa = [xyz], []
    for npoint, radius, nsample in zip(cfg["sa_npoints"], cfg["sa_radii"], cfg["sa_nsamples"]):
        cur = levels[-1]
        centers = geo.gather_points(cur, geo.farthest_point_sample(cur, npoint))
        sa.append((centers, geo.ball_query(radius, nsample, cur, centers)))
        levels.append(centers)
    fp = [geo.three_nn(levels[i], levels[i + 1]) for i in range(len(levels) - 1)]
    return {"sa": sa, "fp": fp}


def geometry_arrays(p: dict) -> list[torch.Tensor]:
    """The plan's centres, group indices and 3-NN indices, for comparison."""
    return ([c for c, _ in p["sa"]] + [i for _, i in p["sa"]] + [i for i, _ in p["fp"]])


def forward(state: dict, points: torch.Tensor, cfg: dict, geometry: dict | None = None,
            stats: dict | None = None) -> torch.Tensor:
    """Log-probabilities [B, N, classes]; ``stats`` (a dict) runs the
    BatchNorms on batch statistics and collects them (``layers.batch_norm``)."""
    if geometry is None:
        geometry = plan(points, cfg)
    mlps, _ = _mlps(cfg)
    n_sa = len(cfg["sa_mlps"])
    xyz, feats = [points[..., :3]], [points]
    for level, (centers, idx) in enumerate(geometry["sa"]):
        cur, f = xyz[-1], feats[-1]
        grouped = torch.cat([geo.gather_points(cur, idx) - centers[:, :, None, :],
                             geo.gather_points(f, idx)], dim=-1)
        prefix, _, mlp = mlps[level]
        feats.append(torch.amax(_mlp(grouped, state, prefix, len(mlp), stats), dim=2))
        xyz.append(centers)
    up = feats[-1]
    for j in range(len(cfg["fp_mlps"])):
        li = n_sa - 1 - j
        idx, weight = geometry["fp"][li]
        interpolated = torch.sum(geo.gather_points(up, idx) * weight[..., None], dim=2)
        x = interpolated if li == 0 else torch.cat([feats[li], interpolated], dim=-1)
        prefix, _, mlp = mlps[n_sa + j]
        up = _mlp(x, state, prefix, len(mlp), stats)
    x = _mlp(up, state, "head", len(cfg["head"]), stats)
    return torch.log_softmax(linear(x, state, "cls").float(), dim=-1)


def forward_flops(cfg: dict, points: int) -> int:
    """Multiply-adds × 2 of every Linear of one block's forward at
    ``points`` points: the SA MLPs on centres × group size rows, the FP
    MLPs on each level's points, the head and the classifier."""
    mlps, last = _mlps(cfg)
    rows = [n * k for n, k in zip(cfg["sa_npoints"], cfg["sa_nsamples"])]
    levels = [points] + list(cfg["sa_npoints"])
    rows += [levels[len(cfg["sa_npoints"]) - 1 - j] for j in range(len(cfg["fp_mlps"]))]
    rows.append(points)
    total = 0
    for r, (_, width, mlp) in zip(rows, mlps):
        for out in mlp:
            total += 2 * r * width * out
            width = out
    return total + 2 * points * last * cfg["num_classes"]
