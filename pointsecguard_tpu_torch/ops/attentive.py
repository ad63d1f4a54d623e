"""RandLA-Net attentive pooling, plain versions (port of
``pointsecguard_tpu/ops/pallas/attentive.py:50-56, 182-183, 236-268``).

``attentive_pool_fused_plain`` computes what the fused kernel computes
(``ops/cuda/attentive.py``), in torch ops that autograd differentiates:
the score projection Dense(concat([fn, fx])) split into its four W
quadrants, a softmax over K per channel, and the two weighted sums;
``attentive_pool_fused_bwd_plain`` is what the backward kernel computes.
The CPU takes them (``psg::attentive_fwd`` / ``psg::attentive_bwd``), and
the tests and ``chip_smoke.py`` hold the kernels against them. It equals the unfused composition
(``attentive_pool_reference``) only up to float reassociation.
"""

from __future__ import annotations

import torch

MAX_FUSED_WIDTH = 128  # the JAX package fuses only channel widths below this


def fused_supported(k: int, c: int) -> bool:
    """Whether an attentive pooling of channel width c = 2·D takes the
    fused path (the JAX package's rule; K does not enter it)."""
    del k
    return c < MAX_FUSED_WIDTH


def quadrants(w: torch.Tensor, d: int):
    """(W_tt, W_bt, W_tb, W_bb) of the [2D, 2D] score projection in x·W
    layout: rows are the input channels (fn first), columns the output
    channels."""
    return w[:d, :d], w[d:, :d], w[:d, d:], w[d:, d:]


def attentive_pool_fused_plain(
    fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense(concat)→softmax(K)→weighted sum, factorised by halves.

    Args:
      fn: [K, M, D] k-major neighbour features.
      fx: [K, M, D] k-major position encodings.
      w: [2D, 2D] score projection (the pooling's Dense kernel, no bias).

    Returns:
      (agg_fn [M, D], agg_fx [M, D]), the two channel halves of the
      attention-weighted sum over K.
    """
    wtt, wbt, wtb, wbb = quadrants(w, fn.shape[-1])
    p1 = torch.softmax(fn @ wtt + fx @ wbt, dim=0)
    p2 = torch.softmax(fn @ wtb + fx @ wbb, dim=0)
    return torch.sum(fn * p1, dim=0), torch.sum(fx * p2, dim=0)


def attentive_pool_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unfused composition on x [M, K, C]: softmax over K of x·W, then
    the weighted sum → [M, C]."""
    scores = torch.softmax(x @ w, dim=1)
    return torch.sum(x * scores, dim=1)


def attentive_pool_fused_bwd_plain(
    fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor, g1: torch.Tensor,
    g2: torch.Tensor, want_dw: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The VJP of ``attentive_pool_fused_plain`` at (fn, fx, w) for the
    cotangents g1, g2 [M, D] of its two outputs: (dfn, dfx, dw), dw None
    unless ``want_dw``.

    Written out as autograd computes it through the plain forward (the
    same products, ``_softmax_backward_data`` and sum order), so that the
    CPU's gradients equal that backward bit for bit
    (``tests/test_torch_custom_ops.py`` holds them to it)."""
    K, M, D = fn.shape
    wtt, wbt, wtb, wbb = quadrants(w, D)
    p1 = torch.softmax(fn @ wtt + fx @ wbt, dim=0)
    p2 = torch.softmax(fn @ wtb + fx @ wbb, dim=0)
    g1, g2 = g1.expand(K, M, D), g2.expand(K, M, D)
    ds1 = torch._softmax_backward_data(g1 * fn, p1, 0, fn.dtype).reshape(K * M, D)
    ds2 = torch._softmax_backward_data(g2 * fx, p2, 0, fn.dtype).reshape(K * M, D)
    # each input's three uses, summed in the order autograd's engine adds them
    dfn = (g1 * p1 + ds2.mm(wtb.t()).view(K, M, D)) + ds1.mm(wtt.t()).view(K, M, D)
    dfx = (g2 * p2 + ds2.mm(wbb.t()).view(K, M, D)) + ds1.mm(wbt.t()).view(K, M, D)
    if not want_dw:
        return dfn, dfx, None
    fnf, fxf = fn.reshape(K * M, D), fx.reshape(K * M, D)
    dw = torch.cat([torch.cat([fnf.t().mm(ds1), fnf.t().mm(ds2)], dim=1),
                    torch.cat([fxf.t().mm(ds1), fxf.t().mm(ds2)], dim=1)], dim=0)
    return dfn, dfx, dw
