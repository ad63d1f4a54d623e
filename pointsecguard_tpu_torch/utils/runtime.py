"""Device selection for the port's entry points.

The port runs on an NVIDIA GPU. ``require_cuda`` is the one place that
decides so: it raises when there is no card and never picks the CPU
quietly. The CPU runs only where a caller names it (``--device cpu`` in
the CLI, the CPU tests), and then every kernel wrapper takes its plain
PyTorch version because its tensors lie on the CPU.
"""

from __future__ import annotations

import torch


def set_float32_modes() -> None:
    """Full float32 matmuls and convolutions: TF32 keeps ~3 decimal
    digits and would move distances and logits away from the reference
    (the JAX package contracts at Precision.HIGHEST)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
