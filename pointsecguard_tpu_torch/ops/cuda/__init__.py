"""The port's hand-written CUDA kernels, each beside its plain version.

``fps`` (kernel A), ``bottomk`` (kernel B), ``bottomk_chunked`` (wide
rows) and ``knn`` each hold a wrapper that launches the kernel for a CUDA
tensor, the plain PyTorch version a CPU tensor goes to, and a launch
counter; ``build`` compiles ``csrc/`` on first use. Importing this
package builds nothing and imports no CUDA.
"""

from __future__ import annotations

from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked, fps, knn

KERNELS = {"fps": fps, "bottom_k": bottomk, "bottom_k_chunked": bottomk_chunked,
           "knn": knn}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
