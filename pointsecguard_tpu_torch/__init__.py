"""pointsecguard_tpu_torch — the PyTorch + CUDA port of pointsecguard_tpu.

The JAX package ``pointsecguard_tpu`` stays the reference; this package
keeps its module names (``ops``, ``models``, ``attacks``, ``data``,
``cli``) so each counterpart is easy to find, and imports ``torch`` and
numpy only — never JAX.

Ported so far: the PointNet++ SSG semantic-segmentation NB / tar_NB
attack path (``python -m pointsecguard_tpu_torch.cli.attack``). Its two
TPU kernels, farthest point sampling and exact bottom-k, are CUDA C++
for sm_90a under ``csrc/``, built on first use by ``ops.cuda.build``.
"""

__version__ = "0.1.0"
