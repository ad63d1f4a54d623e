"""Sparse (edge-list) graph convolution library (port of
``pointsecguard_tpu/models/gcn_sparse.py``).

The ResGCN subtree's `gcn_lib/sparse/` (`torch_vertex.py:11-339`
GENConv / MRConv / EdgeConv / GAT / SAGE / GIN / SemiGCN and the residual
and dense blocks; `torch_message.py:7-68` the softmax / power-mean
aggregations and MsgNorm) for graphs given as edge lists. The dense-batch
segmentation driver does not use them; they are here for graphs in
edge-list form, as in the JAX package.

Convention: ``edge_index`` is [2, E] integer with row 0 the source node j
and row 1 the target node i (a message flows j → i), as torch_geometric
has it. Aggregations are torch's scatter ops over the target ids:
``index_add`` for sums and ``scatter_reduce(..., "amax",
include_self=False)`` into zeros for the max, which leaves a node with no
incoming edge at 0 (JAX's zero fill) and splits the gradient evenly among
tied maxima, as ``jax.grad`` of ``segment_max`` does.

Each layer is an ``nn.Module`` whose input width is given at construction
(flax infers it at the first call) and which takes ``(x [N, C],
edge_index [2, E])``; ``train()`` / ``eval()`` replace the JAX call's
``train=``. Parameter names follow the flax leaves
(``utils/convert.py:gcn_sparse_from_jax_variables`` maps them): a flax
``Dense_i`` is ``lins.i``, ``BatchNorm_i`` ``norms.i``, ``SparseMLP_0``
``mlp``, ``MsgNorm_0`` ``msg_norm``, a block's ``body`` ``body``; GAT's
``a_src`` / ``a_dst``, GIN's ``eps`` and GENConv's ``t`` / ``p`` keep
their names. ``models.init_parameters`` draws the Linear weights as flax
does. BatchNorm is ``models/common.BatchNorm`` (ε 1e-5, keep 0.9).

``knn_edge_index`` builds a kNN graph through ``ops.dense_knn_graph``: on
a CUDA tensor with k ≤ 48 that launches the ``psg::knn`` kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointsecguard_tpu_torch.models.common import BatchNorm

Tensor = torch.Tensor


def _l2(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _segment_sum(values: Tensor, ids: Tensor, n: int) -> Tensor:
    return values.new_zeros((n, *values.shape[1:])).index_add(0, ids, values)


def _segment_max(values: Tensor, ids: Tensor, n: int) -> Tensor:
    """Per-segment max along axis 0; 0 for a segment with no entry."""
    index = ids.reshape(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return values.new_zeros((n, *values.shape[1:])).scatter_reduce(
        0, index, values, "amax", include_self=False)


def _count(values: Tensor, ids: Tensor, n: int) -> Tensor:
    """Entries per segment, [n, 1]."""
    return _segment_sum(values.new_ones((values.shape[0], 1)), ids, n)


def _segment_softmax(values: Tensor, ids: Tensor, n: int) -> Tensor:
    """Per-segment softmax weights along axis 0."""
    shifted = values - _segment_max(values, ids, n)[ids]
    e = torch.exp(shifted)
    return e / (_segment_sum(e, ids, n)[ids] + 1e-16)


def aggregate(messages: Tensor, targets: Tensor, num_nodes: int, *, aggr: str = "max",
              t=1.0, p=1.0) -> Tensor:
    """Message aggregation (`torch_message.py:7-52`): max / mean / add /
    softmax (temperature t) / power-mean (exponent p); a node that no edge
    reaches gets 0."""
    targets = targets.long()
    if aggr == "max":
        return _segment_max(messages, targets, num_nodes)
    if aggr in ("add", "sum"):
        return _segment_sum(messages, targets, num_nodes)
    if aggr == "mean":
        s = _segment_sum(messages, targets, num_nodes)
        return s / torch.clamp(_count(messages, targets, num_nodes), min=1.0)
    if aggr == "softmax":
        w = _segment_softmax(messages * t, targets, num_nodes)
        return _segment_sum(messages * w, targets, num_nodes)
    if aggr == "powermean":
        clipped = torch.clamp(messages, 1e-7, 1e1)
        s = _segment_sum(clipped ** p, targets, num_nodes)
        c = torch.clamp(_count(messages, targets, num_nodes), min=1.0)
        return (s / c) ** (1.0 / p)
    raise ValueError(f"unknown aggregation {aggr}")


class SparseMLP(nn.Module):
    """Linear → act → norm stacks (`gcn_lib/sparse/torch_nn.py` MLP)."""

    def __init__(self, in_channels: int, channels: Sequence[int], act: str = "relu",
                 norm: str | None = "batch", last_lin: bool = False):
        super().__init__()
        widths = [in_channels, *channels]
        self.act, self.last_lin = act, last_lin
        self.lins = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        normed = channels[:-1] if last_lin else channels
        self.norms = nn.ModuleList(BatchNorm(f) for f in normed) if norm == "batch" \
            else nn.ModuleList()

    def forward(self, x: Tensor) -> Tensor:
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if self.last_lin and i == len(self.lins) - 1:
                break
            if self.act == "relu":
                x = F.relu(x)
            elif self.act == "leakyrelu":
                x = F.leaky_relu(x, negative_slope=0.2)
            if len(self.norms):
                x = self.norms[i](x)
        return x


class MsgNorm(nn.Module):
    """Message normalisation (`torch_message.py:55-68`):
    m ← s·‖x‖₂·(m/‖m‖₂)."""

    def __init__(self, learn_scale: bool = True):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1)) if learn_scale else None

    def forward(self, x: Tensor, msg: Tensor) -> Tensor:
        msg = msg / (_l2(msg) + 1e-12)
        out = msg * _l2(x)
        return out if self.scale is None else out * self.scale


class GENConv(nn.Module):
    """GENeralized graph conv (`torch_vertex.py:11-88`): ReLU(x_j)+eps
    messages, softmax / power-mean aggregation with (learnable) t / p,
    optional MsgNorm, residual add, deep MLP."""

    def __init__(self, in_channels: int, emb_dim: int, aggr: str = "softmax",
                 t: float = 1.0, learn_t: bool = False, p: float = 1.0,
                 learn_p: bool = False, msg_norm: bool = False, mlp_layers: int = 2,
                 eps: float = 1e-7):
        super().__init__()
        self.aggr, self.eps = aggr, eps
        self.t = nn.Parameter(torch.full((1,), float(t))) if learn_t else float(t)
        self.p = nn.Parameter(torch.full((1,), float(p))) if learn_p else float(p)
        self.msg_norm = MsgNorm() if msg_norm else None
        channels = [in_channels * 2] * (mlp_layers - 1) + [emb_dim]
        self.mlp = SparseMLP(in_channels, channels, last_lin=True)

    def forward(self, x: Tensor, edge_index: Tensor, edge_attr: Tensor | None = None
                ) -> Tensor:
        src, dst = edge_index[0].long(), edge_index[1]
        msg = x[src]
        if edge_attr is not None:
            msg = msg + edge_attr
        msg = F.relu(msg) + self.eps
        t = self.t[0] if isinstance(self.t, nn.Parameter) else self.t
        p = self.p[0] if isinstance(self.p, nn.Parameter) else self.p
        m = aggregate(msg, dst, x.shape[0], aggr=self.aggr, t=t, p=p)
        if self.msg_norm is not None:
            m = self.msg_norm(x, m)
        return self.mlp(x + m)


class SparseEdgeConv(nn.Module):
    """EdgeConv on edge lists (`torch_vertex.py:105-115`)."""

    def __init__(self, in_channels: int, out_channels: int, aggr: str = "max"):
        super().__init__()
        self.aggr = aggr
        self.mlp = SparseMLP(2 * in_channels, (out_channels,))

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        src, dst = edge_index[0].long(), edge_index[1].long()
        h = self.mlp(torch.cat([x[dst], x[src] - x[dst]], dim=-1))
        return aggregate(h, dst, x.shape[0], aggr=self.aggr)


class SparseMRConv(nn.Module):
    """Max-relative conv (`torch_vertex.py:90-102`)."""

    def __init__(self, in_channels: int, out_channels: int, aggr: str = "max"):
        super().__init__()
        self.aggr = aggr
        self.mlp = SparseMLP(2 * in_channels, (out_channels,))

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        src, dst = edge_index[0].long(), edge_index[1].long()
        rel = aggregate(x[src] - x[dst], dst, x.shape[0], aggr=self.aggr)
        return self.mlp(torch.cat([x, rel], dim=-1))


class SparseGAT(nn.Module):
    """Multi-head graph attention (`torch_vertex.py:117-131` capability)."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 8):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.lins = nn.ModuleList([nn.Linear(in_channels, out_channels * heads, bias=False)])
        self.a_src = nn.Parameter(torch.empty(heads, out_channels))
        self.a_dst = nn.Parameter(torch.empty(heads, out_channels))
        nn.init.xavier_uniform_(self.a_src)  # flax's glorot_uniform
        nn.init.xavier_uniform_(self.a_dst)

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        n = x.shape[0]
        src, dst = edge_index[0].long(), edge_index[1].long()
        h = self.lins[0](x).reshape(n, self.heads, self.out_channels)
        logits = F.leaky_relu((h[src] * self.a_src).sum(-1) + (h[dst] * self.a_dst).sum(-1),
                              negative_slope=0.2)  # [E, heads]
        att = _segment_softmax(logits, dst, n)
        out = _segment_sum(h[src] * att[..., None], dst, n)
        return out.reshape(n, self.heads * self.out_channels)


class SparseSAGE(nn.Module):
    """GraphSAGE mean aggregator (`torch_vertex.py:158-198` capability)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.lins = nn.ModuleList([nn.Linear(in_channels, out_channels),
                                   nn.Linear(in_channels + out_channels, out_channels)])

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        neigh = aggregate(x[edge_index[0].long()], edge_index[1], x.shape[0], aggr="mean")
        out = self.lins[1](torch.cat([x, F.relu(self.lins[0](neigh))], dim=-1))
        return out / (_l2(out) + 1e-12)


class SparseGIN(nn.Module):
    """Graph isomorphism conv (`torch_vertex.py:219-236` capability)."""

    def __init__(self, in_channels: int, out_channels: int, eps0: float = 0.0):
        super().__init__()
        self.eps = nn.Parameter(torch.full((1,), float(eps0)))
        self.mlp = SparseMLP(in_channels, (out_channels,))

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        agg = aggregate(x[edge_index[0].long()], edge_index[1], x.shape[0], aggr="add")
        return self.mlp((1 + self.eps[0]) * x + agg)


class SemiGCN(nn.Module):
    """Kipf & Welling GCN layer (`torch_vertex.py:200-217` capability):
    symmetric-normalised mean aggregation."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.lins = nn.ModuleList([nn.Linear(in_channels, out_channels)])

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        n = x.shape[0]
        src, dst = edge_index[0].long(), edge_index[1].long()
        deg = _segment_sum(x.new_ones(edge_index.shape[1]), dst, n) + 1.0
        norm = 1.0 / torch.sqrt(deg)
        h = self.lins[0](x)
        msg = h[src] * (norm[src] * norm[dst])[:, None]
        return _segment_sum(msg, dst, n) + h * (norm ** 2)[:, None]


class ResGraphBlock(nn.Module):
    """Residual wrapper (`torch_vertex.py:286-300`)."""

    def __init__(self, body: nn.Module, res_scale: float = 1.0):
        super().__init__()
        self.body, self.res_scale = body, res_scale

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        return self.body(x, edge_index) + x * self.res_scale


class DenseGraphBlock(nn.Module):
    """Dense-concat wrapper (`torch_vertex.py:303-316`)."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body

    def forward(self, x: Tensor, edge_index: Tensor) -> Tensor:
        return torch.cat([x, self.body(x, edge_index)], dim=-1)


def knn_edge_index(x: Tensor, k: int) -> Tensor:
    """A [2, N·k] int32 kNN edge list from node positions or features
    [N, C] (`torch_edge.py:6-102` capability, one graph): row 0 the k
    neighbours of each node, nearest first and the node itself among them,
    row 1 the node. Through ``ops.dense_knn_graph``: the ``psg::knn`` kernel
    for a CUDA tensor at k ≤ 48, its plain version on the CPU."""
    from pointsecguard_tpu_torch import ops

    idx = ops.dense_knn_graph(x[None], k)[0]  # [N, k]
    dst = torch.arange(x.shape[0], dtype=torch.int32, device=x.device).repeat_interleave(k)
    return torch.stack([idx.reshape(-1).to(torch.int32), dst])
