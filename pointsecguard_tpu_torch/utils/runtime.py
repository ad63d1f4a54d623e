"""Device selection for the port's entry points.

The port runs on an NVIDIA GPU. ``require_cuda`` is the one place that
decides so: it raises when there is no card and never picks the CPU
quietly. The CPU runs only where a caller names it (``--device cpu`` in
the CLI, the CPU tests), and then every kernel wrapper takes its plain
PyTorch version because its tensors lie on the CPU.

A rank of a data-parallel run (``parallel/mesh.py``) also records here
which slice of the global batch it holds (``set_data_slice``). The batch's
random draws (FPS starts, dropout masks, the attacks' random starts and
noise) go through ``batch_draw``, which then draws for the global batch and
keeps the rank's rows, so that N ranks draw what one process draws.
"""

from __future__ import annotations

import torch


PRECISIONS = {"float32": None, "bfloat16": torch.bfloat16}


def model_dtype(precision: str) -> torch.dtype | None:
    """``--precision`` → the models' ``dtype``: None (float32) or
    ``torch.bfloat16`` (the Linear products in bf16; ``models/common.py``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} ({' | '.join(PRECISIONS)})")
    return PRECISIONS[precision]


def set_float32_modes() -> None:
    """Full float32 matmuls and convolutions: TF32 keeps ~3 decimal
    digits and would move distances and logits away from the reference
    (the JAX package contracts at Precision.HIGHEST). The bf16 products of
    ``--precision bfloat16`` accumulate in float32, as JAX's do: cuBLAS
    may otherwise reduce them in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def require_cuda(index: int = 0) -> torch.device:
    """CUDA device ``index`` (the first by default), or RuntimeError when
    there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU "
            "(pass --device cpu to run the plain PyTorch path explicitly)"
        )
    set_float32_modes()
    return torch.device("cuda", index)


def resolve_device(name: str, index: int = 0) -> torch.device:
    """``"cuda"`` → ``require_cuda(index)``; ``"cpu"`` → the CPU, by request."""
    if name == "cuda":
        return require_cuda(index)
    if name == "cpu":
        set_float32_modes()
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (cuda | cpu)")


# (rank along the data axis, size of the data axis) of this process
_data_slice = (0, 1)


def set_data_slice(rank: int, size: int) -> None:
    """Record that this process holds rows ``rank`` of ``size`` equal
    slices of every global batch (``parallel.mesh.init_rank``)."""
    global _data_slice
    _data_slice = (rank, size)


def batch_draw(draw, shape) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose leading axis is this process's
    slice of the batch: the draw is made for the global batch (the leading
    axis times the data size) and the rank's rows are kept, so the values
    do not depend on how many ranks share the batch."""
    rank, size = _data_slice
    if size == 1:
        return draw(tuple(shape))
    b = shape[0]
    return draw((b * size, *shape[1:]))[rank * b : (rank + 1) * b]
