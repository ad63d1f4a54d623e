"""The port's hand-written CUDA kernels, each beside its plain version.

``fps`` (kernel A), ``bottomk`` (kernel B), ``bottomk_chunked`` (wide
rows), ``knn`` and ``attentive`` (fused attentive pooling, forward and
backward) each hold a wrapper with its argument checks, the plain PyTorch
version a CPU tensor goes to, and a launch counter; ``library`` binds the
kernels as the custom ops ``torch.ops.psg.*``, through which every
wrapper calls them, and ``build`` compiles ``csrc/`` on first use.
Importing this package registers the ops, builds nothing and imports no
CUDA.
"""

from __future__ import annotations

from pointsecguard_tpu_torch.ops.cuda import attentive, bottomk, bottomk_chunked, fps, knn
from pointsecguard_tpu_torch.ops.cuda import library  # noqa: F401  (registers psg::*)

# counter name → (module, attribute holding its count)
# (``fps_cluster`` / ``fps_stream``: the launches of ``fps`` that took its
# cluster kernel / its streaming kernel)
KERNELS = {"fps": (fps, "launches"), "fps_cluster": (fps, "cluster_launches"),
           "fps_stream": (fps, "stream_launches"),
           "bottom_k": (bottomk, "launches"),
           "bottom_k_chunked": (bottomk_chunked, "launches"), "knn": (knn, "launches"),
           "attentive_fwd": (attentive, "fwd_launches"),
           "attentive_bwd": (attentive, "bwd_launches")}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
