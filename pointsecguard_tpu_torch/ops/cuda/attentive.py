"""Fused attentive pooling: CUDA kernel 5 (forward and backward) and its
plain version.

Replaces ``pointsecguard_tpu/ops/pallas/attentive.py:attentive_pool_fused``
(``_fwd_kernel``, ``_bwd_kernel`` and the custom VJP around them). The
kernels (``csrc/attentive.cu``) give each thread one row and four score
columns at every K (a [K, 4] register tile of the score product), stream
row tiles through two ``cp.async`` stages, keep the K scores in registers
and never write a score or a [K, M, 2D] tensor to memory; the backward
sums dW per block and then over blocks in a fixed order (no float
atomics), and only when ``w`` needs a gradient. Bounds: float32,
1 ≤ D ≤ 63, K ∈ {4, 16}.

``attentive_pool_fused`` is a ``torch.autograd.Function`` for CUDA
tensors: its forward launches the forward kernel and its backward the
backward kernel. It raises when the kernels cannot take the input; only
CPU tensors go to ``attentive_pool_fused_plain`` (autograd differentiates
that one).
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.attentive import attentive_pool_fused_plain

MAX_D = 63
BUILT_K = (4, 16)  # the K instances csrc/attentive.cu compiles
fwd_launches = 0  # forward kernel launches; never counts the plain version
bwd_launches = 0  # backward kernel launches (with or without dW)


def _check(fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor) -> None:
    if fn.dim() != 3 or fx.shape != fn.shape or w.shape != (2 * fn.shape[2],) * 2:
        raise ValueError(f"attentive_pool_fused: want fn, fx [K, M, D] and w [2D, 2D], "
                         f"got {tuple(fn.shape)}, {tuple(fx.shape)}, {tuple(w.shape)}")


def check_kernel_args(fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernels do not take (shapes, dtype, K, D)."""
    _check(fn, fx, w)
    tensors = (fn, fx, w)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"attentive_pool_fused: want float32, got "
                         f"{[t.dtype for t in tensors]}")
    K, _, D = fn.shape
    if K not in BUILT_K or not 1 <= D <= MAX_D:
        raise ValueError(f"attentive_pool_fused: K={K}, D={D} outside the kernels' "
                         f"K in {BUILT_K}, 1 <= D <= {MAX_D}")


def _launch_fwd(fn, fx, w):
    from pointsecguard_tpu_torch.ops.cuda import build

    lib = build.load_library()
    K, M, D = fn.shape
    afn = torch.empty((M, D), dtype=torch.float32, device=fn.device)
    afx = torch.empty_like(afn)
    stream = torch.cuda.current_stream(fn.device).cuda_stream
    code = lib.psg_attentive_fwd(fn.data_ptr(), fx.data_ptr(), w.data_ptr(),
                                 afn.data_ptr(), afx.data_ptr(), K, M, D, stream)
    build.check(code, "psg_attentive_fwd")
    global fwd_launches
    fwd_launches += 1
    return afn, afx


def _launch_bwd(fn, fx, w, g1, g2, want_dw: bool):
    from pointsecguard_tpu_torch.ops.cuda import build

    lib = build.load_library()
    K, M, D = fn.shape
    dfn = torch.empty_like(fn)
    dfx = torch.empty_like(fx)
    part = dw = None
    if want_dw:
        blocks = lib.psg_attentive_dw_blocks(K, M, D)
        part = torch.empty((max(blocks, 1), 2 * D, 2 * D), dtype=torch.float32,
                           device=fn.device)
        dw = torch.zeros_like(w)  # M == 0 leaves it untouched
    stream = torch.cuda.current_stream(fn.device).cuda_stream
    code = lib.psg_attentive_bwd(
        fn.data_ptr(), fx.data_ptr(), w.data_ptr(), g1.data_ptr(), g2.data_ptr(),
        dfn.data_ptr(), dfx.data_ptr(), None if part is None else part.data_ptr(),
        None if dw is None else dw.data_ptr(), K, M, D, stream)
    build.check(code, "psg_attentive_bwd")
    global bwd_launches
    bwd_launches += 1
    return dfn, dfx, dw


class _FusedAttentivePool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, fx, w):
        ctx.save_for_backward(fn, fx, w)
        return _launch_fwd(fn, fx, w)

    @staticmethod
    def backward(ctx, g1, g2):
        fn, fx, w = ctx.saved_tensors
        M, D = fn.shape[1:]
        zero = torch.zeros((M, D), dtype=fn.dtype, device=fn.device)
        g1 = zero if g1 is None else g1.contiguous()
        g2 = zero if g2 is None else g2.contiguous()
        dfn, dfx, dw = _launch_bwd(fn, fx, w, g1, g2, ctx.needs_input_grad[2])
        return dfn, dfx, dw


def attentive_pool_fused(
    fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(agg_fn [M, D], agg_fx [M, D]) of fn, fx [K, M, D] under the
    [2D, 2D] score projection w (see ``attentive_pool_fused_plain``)."""
    _check(fn, fx, w)
    tensors = (fn, fx, w)
    if all(t.device.type == "cpu" for t in tensors):
        return attentive_pool_fused_plain(fn, fx, w)
    if fn.device.type != "cuda" or any(t.device != fn.device for t in tensors):
        raise ValueError(f"attentive_pool_fused: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")
    check_kernel_args(fn, fx, w)
    from pointsecguard_tpu_torch.ops.cuda import build

    build.require_sm90(fn.device)
    return _FusedAttentivePool.apply(fn.contiguous(), fx.contiguous(), w.contiguous())
