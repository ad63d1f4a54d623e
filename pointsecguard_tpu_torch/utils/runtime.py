"""Device selection for the port's entry points.

The port runs on an NVIDIA GPU. ``require_cuda`` is the one place that
decides so: it raises when there is no card and never picks the CPU
quietly. The CPU runs only where a caller names it (``--device cpu`` in
the CLI, the CPU tests), and then every kernel wrapper takes its plain
PyTorch version because its tensors lie on the CPU.
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


def require_cuda() -> torch.device:
    """The first CUDA device, or RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU "
            "(pass --device cpu to run the plain PyTorch path explicitly)"
        )
    set_float32_modes()
    return torch.device("cuda", 0)


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` → ``require_cuda()``; ``"cpu"`` → the CPU, by request."""
    if name == "cuda":
        return require_cuda()
    if name == "cpu":
        set_float32_modes()
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (cuda | cpu)")
