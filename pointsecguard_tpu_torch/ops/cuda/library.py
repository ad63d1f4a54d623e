"""The port's CUDA kernels as ``torch.library`` custom ops, namespace ``psg``.

    psg::fps(xyz, npoint, start) -> idx
    psg::bottom_k(vals, k) -> (values, idx)
    psg::bottom_k_chunked(vals, k) -> (values, idx)
    psg::knn(query, points, k) -> (sq_dists, idx)
    psg::attentive_fwd(fn, fx, w) -> (agg_fn, agg_fx)
    psg::attentive_bwd(fn, fx, w, g1, g2, want_dw) -> (dfn, dfx, dw)

Each op has three implementations, and the dispatcher picks one by the
tensors' device:

- CUDA: checks what the kernel takes (raising otherwise), allocates the
  outputs and scratch with ``torch.empty``, launches the kernel of
  ``build.load_library()`` on the current stream and adds one to its
  module's launch counter. Nothing else in the port calls ``lib.psg_*``.
- CPU: the plain PyTorch version beside each kernel.
- fake (``register_fake``): output shapes and dtypes only, so that
  ``torch.export`` and FakeTensor tracing pass through without launching
  or counting anything. Indices are int32.

No other device has an implementation, so nothing falls back. Gradients
are ``register_autograd`` rules: the bottom-k values scatter their
cotangent back into the row (the JAX package's ``_pallas_bottom_k_bwd``),
and the attentive pooling's backward is ``psg::attentive_bwd``. FPS and
kNN return indices and distances that carry no gradient (JAX stops it).
``attentive_bwd`` returns an empty ``dw`` when ``want_dw`` is false: a
custom op cannot return None.

Importing this module registers the ops; it builds nothing and imports no
CUDA.
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.attentive import (
    attentive_pool_fused_bwd_plain,
    attentive_pool_fused_plain,
)
from pointsecguard_tpu_torch.ops.cuda import attentive, bottomk, bottomk_chunked, build, fps, knn

Tensor = torch.Tensor


def _library(device: torch.device):
    """The built kernel library, after checking the card can run it."""
    lib = build.load_library()
    build.require_sm90(device)
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _int32_like(t: Tensor, shape) -> Tensor:
    return torch.empty(shape, dtype=torch.int32, device=t.device)


# --- FPS ---------------------------------------------------------------------

@torch.library.custom_op("psg::fps", mutates_args=(), device_types="cpu")
def fps_op(xyz: Tensor, npoint: int, start: Tensor) -> Tensor:
    return fps.fps_plain(xyz, npoint, start)


@fps_op.register_kernel("cuda")
def _fps_cuda(xyz: Tensor, npoint: int, start: Tensor) -> Tensor:
    fps.check_args(xyz, npoint, start)
    lib = _library(xyz.device)
    B, N, _ = xyz.shape
    xyz = xyz.contiguous()
    # a start outside [0, N) is not read: the kernel writes -1 for that
    # cloud (checking here would cost a device-to-host sync per call)
    start = start.to(torch.int32).contiguous()
    out = _int32_like(xyz, (B, npoint))
    # csrc/fps.cu says which of its kernels takes N; the streaming one packs
    # the cloud and keeps its min-distances in this working space
    route = lib.psg_fps_route(N)
    per_point = lib.psg_fps_workspace_floats(N)
    work = (torch.empty(B * N * per_point, dtype=torch.float32, device=xyz.device)
            if per_point else None)
    code = lib.psg_fps(xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                       work.data_ptr() if per_point else None, B, N, npoint,
                       _stream(xyz.device))
    build.check(code, "psg_fps")
    fps.launches += 1
    fps.cluster_launches += int(route == 1)
    fps.stream_launches += int(route == 2)
    return out


@fps_op.register_fake
def _fps_fake(xyz, npoint, start):
    return _int32_like(xyz, (xyz.shape[0], npoint))


# --- bottom-k ----------------------------------------------------------------

def _bottom_k_launch(entry: str, vals: Tensor, k: int, *extra) -> tuple[Tensor, Tensor]:
    """``extra``: the entry's arguments between the outputs and ``rows``
    (the wide-row kernel's counter of its exact branch)."""
    lib = _library(vals.device)
    N = vals.shape[-1]
    vals = vals.contiguous()
    lead = vals.shape[:-1]
    rows = vals.numel() // N
    out_v = torch.empty((*lead, k), dtype=torch.float32, device=vals.device)
    out_i = _int32_like(vals, (*lead, k))
    code = getattr(lib, entry)(vals.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), *extra,
                               rows, N, k, _stream(vals.device))
    build.check(code, entry)
    return out_v, out_i


def _bottom_k_cpu(vals: Tensor, k: int) -> tuple[Tensor, Tensor]:
    # the plain version's values are a slice of the sorted rows: made
    # contiguous, as the kernel's (and the fake) outputs are
    v, i = bottomk.bottom_k_plain(vals, k)
    return v.contiguous(), i


@torch.library.custom_op("psg::bottom_k", mutates_args=(), device_types="cpu")
def bottom_k_op(vals: Tensor, k: int) -> tuple[Tensor, Tensor]:
    return _bottom_k_cpu(vals, k)


@bottom_k_op.register_kernel("cuda")
def _bottom_k_cuda(vals: Tensor, k: int) -> tuple[Tensor, Tensor]:
    bottomk.check_kernel_args(vals, k)
    out = _bottom_k_launch("psg_bottom_k", vals, k)
    bottomk.launches += 1
    return out


@torch.library.custom_op("psg::bottom_k_chunked", mutates_args=(), device_types="cpu")
def bottom_k_chunked_op(vals: Tensor, k: int) -> tuple[Tensor, Tensor]:
    return _bottom_k_cpu(vals, k)


@bottom_k_chunked_op.register_kernel("cuda")
def _bottom_k_chunked_cuda(vals: Tensor, k: int) -> tuple[Tensor, Tensor]:
    bottomk_chunked.check_kernel_args(vals, k)
    out = _bottom_k_launch("psg_bottom_k_chunked", vals, k, None)  # no counter
    bottomk_chunked.launches += 1
    return out


def bottom_k_chunked_overflows(vals: Tensor, k: int) -> int:
    """One launch of the wide-row kernel on a CUDA tensor that also counts
    the rows taking its exact branch (``bottomk_chunked.overflow_rows``);
    synchronises to read the count. Not an op: checks call it, never a
    model."""
    bottomk_chunked.check_kernel_args(vals, k)
    counter = torch.zeros(1, dtype=torch.int32, device=vals.device)
    _bottom_k_launch("psg_bottom_k_chunked", vals, k, counter.data_ptr())
    bottomk_chunked.launches += 1
    return int(counter.item())


def _bottom_k_fake(vals, k):
    shape = (*vals.shape[:-1], k)
    return vals.new_empty(shape), _int32_like(vals, shape)


def _bottom_k_setup(ctx, inputs, output):
    ctx.width = inputs[0].shape[-1]
    ctx.save_for_backward(output[1])


def _bottom_k_backward(ctx, dv, _di):
    """The VJP of a gather at the indices: a row's indices are distinct,
    so the scatter's add is a set."""
    (i,) = ctx.saved_tensors
    dvals = dv.new_zeros((*dv.shape[:-1], ctx.width))
    return dvals.scatter_(-1, i.long(), dv), None


for _op in (bottom_k_op, bottom_k_chunked_op):
    _op.register_fake(_bottom_k_fake)
    _op.register_autograd(_bottom_k_backward, setup_context=_bottom_k_setup)


# --- kNN ---------------------------------------------------------------------

@torch.library.custom_op("psg::knn", mutates_args=(), device_types="cpu")
def knn_op(query: Tensor, points: Tensor, k: int) -> tuple[Tensor, Tensor]:
    return knn.knn_plain(query.float(), points.float(), k)


@knn_op.register_kernel("cuda")
def _knn_cuda(query: Tensor, points: Tensor, k: int) -> tuple[Tensor, Tensor]:
    knn.check_kernel_args(query, points, k)
    lib = _library(query.device)
    B, S, D = query.shape
    N = points.shape[1]
    # the pyramid's neighbour search passes one tensor twice: the kernel
    # then packs it once. The op's arguments need not be the caller's
    # objects, so the test is on the memory they view.
    same = (query.data_ptr() == points.data_ptr() and query.shape == points.shape
            and query.stride() == points.stride())
    points = points.contiguous()
    query = points if same else query.contiguous()
    out_v = torch.empty((B, S, k), dtype=torch.float32, device=query.device)
    out_i = _int32_like(query, (B, S, k))
    # working space: queries and points packed as (x, y, z, |x|²) for
    # D = 3, |q|² and |p|² for any other D; small kernels of csrc/knn.cu
    # fill it, rounding as ``_sum_sq`` does
    scratch = torch.empty((B * S + B * N) * (4 if D == 3 else 1), dtype=torch.float32,
                          device=query.device)
    code = lib.psg_knn(query.data_ptr(), points.data_ptr(), out_v.data_ptr(),
                       out_i.data_ptr(), scratch.data_ptr(), B, S, N, D, k,
                       _stream(query.device))
    build.check(code, "psg_knn")
    knn.launches += 1
    return out_v, out_i


@knn_op.register_fake
def _knn_fake(query, points, k):
    shape = (query.shape[0], query.shape[1], k)
    return query.new_empty(shape, dtype=torch.float32), _int32_like(query, shape)


# --- fused attentive pooling -------------------------------------------------

@torch.library.custom_op("psg::attentive_fwd", mutates_args=(), device_types="cpu")
def attentive_fwd_op(fn: Tensor, fx: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    return attentive_pool_fused_plain(fn, fx, w)


@attentive_fwd_op.register_kernel("cuda")
def _attentive_fwd_cuda(fn: Tensor, fx: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    attentive.check_kernel_args(fn, fx, w)
    lib = _library(fn.device)
    fn, fx, w = fn.contiguous(), fx.contiguous(), w.contiguous()
    K, M, D = fn.shape
    afn = torch.empty((M, D), dtype=torch.float32, device=fn.device)
    afx = torch.empty_like(afn)
    code = lib.psg_attentive_fwd(fn.data_ptr(), fx.data_ptr(), w.data_ptr(),
                                 afn.data_ptr(), afx.data_ptr(), K, M, D,
                                 _stream(fn.device))
    build.check(code, "psg_attentive_fwd")
    attentive.fwd_launches += 1
    return afn, afx


@attentive_fwd_op.register_fake
def _attentive_fwd_fake(fn, fx, w):
    shape = fn.shape[1:]
    return fn.new_empty(shape), fn.new_empty(shape)


@torch.library.custom_op("psg::attentive_bwd", mutates_args=(), device_types="cpu")
def attentive_bwd_op(fn: Tensor, fx: Tensor, w: Tensor, g1: Tensor, g2: Tensor,
                     want_dw: bool) -> tuple[Tensor, Tensor, Tensor]:
    dfn, dfx, dw = attentive_pool_fused_bwd_plain(fn, fx, w, g1, g2, want_dw)
    return dfn, dfx, w.new_empty(0) if dw is None else dw


@attentive_bwd_op.register_kernel("cuda")
def _attentive_bwd_cuda(fn: Tensor, fx: Tensor, w: Tensor, g1: Tensor, g2: Tensor,
                        want_dw: bool) -> tuple[Tensor, Tensor, Tensor]:
    attentive.check_kernel_args(fn, fx, w)
    lib = _library(fn.device)
    fn, fx, w = fn.contiguous(), fx.contiguous(), w.contiguous()
    g1, g2 = g1.contiguous(), g2.contiguous()
    K, M, D = fn.shape
    if g1.shape != (M, D) or g2.shape != (M, D) or g1.dtype != fn.dtype \
            or g2.dtype != fn.dtype:
        raise ValueError(f"attentive_bwd: want g1, g2 float32 [{M}, {D}], got "
                         f"{tuple(g1.shape)}, {tuple(g2.shape)}")
    dfn = torch.empty_like(fn)
    dfx = torch.empty_like(fx)
    part = None
    dw = w.new_empty(0)
    if want_dw:
        blocks = lib.psg_attentive_dw_blocks(K, M, D)
        part = torch.empty((max(blocks, 1), 2 * D, 2 * D), dtype=torch.float32,
                           device=fn.device)
        dw = torch.zeros_like(w)  # M == 0 leaves it untouched
    code = lib.psg_attentive_bwd(
        fn.data_ptr(), fx.data_ptr(), w.data_ptr(), g1.data_ptr(), g2.data_ptr(),
        dfn.data_ptr(), dfx.data_ptr(), None if part is None else part.data_ptr(),
        dw.data_ptr() if want_dw else None, K, M, D, _stream(fn.device))
    build.check(code, "psg_attentive_bwd")
    attentive.bwd_launches += 1
    return dfn, dfx, dw


@attentive_bwd_op.register_fake
def _attentive_bwd_fake(fn, fx, w, g1, g2, want_dw):
    return fn.new_empty(fn.shape), fx.new_empty(fx.shape), (
        w.new_empty(w.shape) if want_dw else w.new_empty(0))


def _attentive_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _attentive_backward(ctx, g1, g2):
    fn, fx, w = ctx.saved_tensors
    # an unused output's cotangent arrives as zeros (materialized grads)
    dfn, dfx, dw = torch.ops.psg.attentive_bwd(fn, fx, w, g1, g2, ctx.needs_input_grad[2])
    return dfn, dfx, dw if ctx.needs_input_grad[2] else None


attentive_fwd_op.register_autograd(_attentive_backward, setup_context=_attentive_setup)
