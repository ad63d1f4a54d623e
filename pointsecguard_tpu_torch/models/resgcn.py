"""DeepGCN / ResGCN-28: the dense dynamic EdgeConv backbone (port of
``pointsecguard_tpu/models/resgcn.py:27-307``).

The reference is `ResGCN/sem_seg_dense/architecture.py:6-68`
(``DenseDeepGCN``) over `ResGCN/gcn_lib/dense/` (EdgeConv
`torch_vertex.py:23-35`, the dense dilated kNN `torch_edge.py:6-79`,
BasicConv `torch_nn.py:55-79`). Channels-last [B, N, C] as in the JAX
package. Every block rebuilds its kNN graph on its input features
(``ops.dense_knn_graph``): the head's over xyz and the first blocks'
(k·dilation ≤ 48) on the fused kNN kernel, the wider ones through the
distance product and a stable sort. 28 graphs a forward at full width.

Reproduced quirks: BasicConv applies Linear → activation → BatchNorm in
that order; BatchNorm keeps 0.9 of its running statistics whatever the
trainer's momentum; the kNN graph includes the point itself; dilation is
1 + i in block i for ``res`` and ``dense``, 1 for ``plain``; every maximum
is ``torch.amax``, which splits the gradient over tied maxima as
``jnp.max`` does.

``dilated_mode="subsample"`` (``--resgcn_fast``, with ``knn_strategy=
"approx"``; JAX `models/resgcn.py:131-141`) replaces a block's exact
dilation, every d-th of its k·d nearest, by the k nearest among the
stride-d candidates ``x[:, ::d]``: 26 more k = 16 searches on the kNN
kernel, 28 a forward, and no large-k sort. It is a documented deviation
from the reference (PARITY.md), adds no parameter and draws nothing.

``graphs=`` (the head's graph, then one per block) replaces the graphs
the forward would build, and ``collect_graphs=True`` returns them beside
the logits: two devices can then be held against each other on one
graph.

``remat=True`` (``cli.train --remat``, JAX's ``nn.remat`` around each
backbone ``DynConv``, `pointsecguard_tpu/models/resgcn.py:196-251`) keeps
only each block's input and graph for the backward, which recomputes the
block's edge features and EdgeConv. The graph (the kNN and the stochastic
dilation's draw) is built outside the recomputed function, so the
recompute draws nothing; the recompute's BatchNorm statistics update is
undone, so the running statistics move once, as without remat. The state
dict is the same with and without it.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models.common import BatchNorm, dropout, linear


class BasicConv(nn.Module):
    """Linear → ReLU → BatchNorm (`torch_nn.py:55-79` ordering; BatchNorm
    at ε 1e-5 and keep 0.9), or the Linear alone for the classifier."""

    def __init__(self, in_features: int, features: int, *, norm_act: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(in_features, features)
        self.bn = BatchNorm(features) if norm_act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.dense, self.dtype)
        return x if self.bn is None else self.bn(torch.relu(x))


class EdgeConv(nn.Module):
    """EdgeConv (`torch_vertex.py:23-35`): max over neighbours of
    BasicConv([x_i, x_j − x_i]); x_j − x_i in x's dtype (bf16 between
    blocks under a bf16 ``dtype``)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.nn = BasicConv(2 * in_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, edge_idx: torch.Tensor) -> torch.Tensor:
        x_j = ops.gather_points(x, edge_idx)  # [B, N, K, C]
        x_i = x[:, :, None, :].expand_as(x_j)
        return torch.amax(self.nn(torch.cat([x_i, x_j - x_i], dim=-1)), dim=2)


class MRConv(nn.Module):
    """Max-relative graph conv (`torch_vertex.py:8-20`)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.nn = BasicConv(2 * in_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, edge_idx: torch.Tensor) -> torch.Tensor:
        x_j = ops.gather_points(x, edge_idx)
        rel = torch.amax(x_j - x[:, :, None, :], dim=2)  # [B, N, C]
        return self.nn(torch.cat([x, rel], dim=-1))


_GRAPH_CONVS = {"edge": EdgeConv, "mr": MRConv}


class DynConv(nn.Module):
    """Dynamic graph conv (`torch_vertex.py:55-71`): the dilated kNN graph
    of the current features, then the graph conv over it."""

    def __init__(self, in_channels: int, out_channels: int, *, k: int, dilation: int,
                 conv: str, epsilon: float, knn_strategy: str = "auto",
                 dilated_mode: str = "exact", dtype: torch.dtype | None = None):
        super().__init__()
        self.k, self.dilation, self.epsilon = k, dilation, epsilon
        self.knn_strategy, self.dilated_mode = knn_strategy, dilated_mode
        self.conv = _GRAPH_CONVS[conv](in_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor, idx: torch.Tensor | None = None,
                generator: torch.Generator | None = None, remat: bool = False):
        """→ (output [B, N, out], the graph [B, N, k] it used). ``remat``
        recomputes the convolution over the graph in the backward."""
        if idx is None and self.dilated_mode == "subsample" and self.dilation > 1:
            idx = self._subsample_graph(x)
        elif idx is None:
            idx = ops.dense_knn_graph(x, self.k * self.dilation)
            # the random subset is drawn only where it can be taken
            idx = ops.dilate_neighbors(idx, self.dilation, generator=generator,
                                       stochastic=self.training and self.epsilon > 0,
                                       epsilon=self.epsilon)
        if remat and torch.is_grad_enabled():
            return self._recomputed_conv(x, idx), idx
        return self.conv(x, idx), idx

    def _subsample_graph(self, x: torch.Tensor) -> torch.Tensor:
        """The k nearest of each point among the stride-d candidates, as
        indices into the whole cloud; a cloud of fewer than k candidates
        repeats its list to width k. Built from ``x.detach()``, as
        ``ops.dense_knn_graph`` builds its graph."""
        x = x.detach()
        cand = x[:, :: self.dilation].contiguous()
        k_eff = min(self.k, cand.shape[1])
        _, idx = ops.knn(x, cand, k_eff, strategy=self.knn_strategy)
        return ops.repeat_pad_k(idx, self.k) * self.dilation

    def _recomputed_conv(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        calls = []
        stats = [b for b in self.conv.buffers()]

        def run(x, idx):
            if not calls:  # the forward: the statistics move here
                calls.append(1)
                return self.conv(x, idx)
            # the backward's recompute: same batch statistics, so the same
            # output; the running statistics are put back as they were
            # (also when the recompute stops early, past its last saved
            # tensor)
            kept = [b.clone() for b in stats]
            try:
                return self.conv(x, idx)
            finally:
                with torch.no_grad():
                    for b, k in zip(stats, kept):
                        b.copy_(k)

        return torch.utils.checkpoint.checkpoint(run, x, idx, use_reentrant=False,
                                                 preserve_rng_state=False)


class DenseDeepGCN(nn.Module):
    """ResGCN-28 semantic segmentation (`architecture.py:6-68`).

    Input [B, N, 9] (xyz | rgb | normalised xyz); output float32 logits
    [B, N, num_classes]. Training mode: batch statistics, the stochastic
    dilation when ``epsilon`` > 0 (the reference's ``stochastic`` flag is
    always on) and the head's dropout when ``dropout`` > 0, both drawn
    from ``generator`` (on the model's device), or the dropout mask given
    as ``dropout_mask``. The JAX module's ``act``, ``norm``, ``use_bias``
    and ``res_scale`` keep their defaults (ReLU, BatchNorm, biases, 1):
    no ported path sets them. ``dilated_mode`` ("exact" | "subsample")
    and ``knn_strategy`` (``ops.knn``'s, for the subsample graphs) as in
    the module docstring. ``remat`` recomputes each backbone block in
    the backward (module docstring). ``dtype`` as in ``models/common.py``:
    the graphs are built on float32 features either way
    (``ops.dense_knn_graph``).
    """

    def __init__(self, num_classes: int = 13, in_channels: int = 9, n_blocks: int = 28,
                 n_filters: int = 64, k: int = 16, block: str = "res", conv: str = "edge",
                 epsilon: float = 0.0, dropout: float = 0.0, knn_strategy: str = "auto",
                 dilated_mode: str = "exact", remat: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.remat = remat
        if block not in ("res", "dense", "plain") or conv not in _GRAPH_CONVS:
            raise NotImplementedError(f"block:{block} conv:{conv} is not supported")
        if dilated_mode not in ("exact", "subsample"):
            raise ValueError(f"dilated_mode {dilated_mode!r} (exact | subsample)")
        self.k, self.block, self.dropout = k, block, dropout
        self.head = _GRAPH_CONVS[conv](in_channels, n_filters, dtype)
        width, widths = n_filters, [n_filters]
        blocks = []
        for i in range(n_blocks - 1):
            dilation = 1 if block == "plain" else 1 + i
            blocks.append(DynConv(width, n_filters, k=k, dilation=dilation, conv=conv,
                                  epsilon=epsilon, knn_strategy=knn_strategy,
                                  dilated_mode=dilated_mode, dtype=dtype))
            if block == "dense":
                width += n_filters
            widths.append(width)
        self.backbone = nn.ModuleList(blocks)
        fused = sum(widths)  # the concatenation of every block's output
        self.fusion = BasicConv(fused, 1024, dtype=dtype)
        self.pred = nn.ModuleList([BasicConv(1024 + fused, 512, dtype=dtype),
                                   BasicConv(512, 256, dtype=dtype)])
        self.cls = BasicConv(256, num_classes, norm_act=False, dtype=dtype)

    def forward(self, points: torch.Tensor, *, graphs=None, collect_graphs: bool = False,
                generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        head_idx = (graphs[0] if graphs is not None
                    else ops.dense_knn_graph(points[..., :3], self.k))
        graphs_out = [head_idx]
        feats = [self.head(points, head_idx)]
        for i, blk in enumerate(self.backbone):
            body, idx = blk(feats[-1], None if graphs is None else graphs[1 + i], generator,
                            self.remat)
            graphs_out.append(idx)
            # res adds the skip; dense concatenates (growing widths, which
            # the fusion's concatenation below takes again, as the
            # reference does); plain stacks
            if self.block == "res":
                feats.append(body + feats[-1])
            elif self.block == "dense":
                feats.append(torch.cat([feats[-1], body], dim=-1))
            else:
                feats.append(body)
        h = torch.cat(feats, dim=-1)  # [B, N, 64 · 28]
        fusion = torch.amax(self.fusion(h), dim=1, keepdim=True)  # [B, 1, 1024]
        x = torch.cat([fusion.expand(-1, h.shape[1], -1), h], dim=-1)
        x = self.pred[1](self.pred[0](x))
        if self.training and self.dropout:
            x = dropout(x, self.dropout, dropout_mask, generator)
        logits = self.cls(x).float()  # always float32
        if collect_graphs:
            return logits, tuple(graphs_out)
        return logits


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, _weights=None) -> torch.Tensor:
    """ResGCN's plain mean cross-entropy (`sem_seg_dense/train.py:30`); the
    class weights the trainer passes are not read, as in the JAX loop."""
    lp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
    return -torch.mean(torch.gather(lp, 1, labels.reshape(-1, 1).long()))
