"""pointsecguard_tpu_torch — the PyTorch + CUDA port of pointsecguard_tpu.

The JAX package ``pointsecguard_tpu`` stays the reference; this package
keeps its module names (``ops``, ``models``, ``attacks``, ``data``,
``cli``) so each counterpart is easy to find, and imports ``torch``,
numpy and scipy only — never JAX.

Ported so far: the NB / tar_NB attack paths of PointNet++ SSG and of
RandLA-Net on S3DIS (``python -m pointsecguard_tpu_torch.cli.attack``).
Their four TPU kernels (farthest point sampling, exact bottom-k, wide-row
bottom-k and the fused exact kNN) are CUDA C++ for sm_90a under
``csrc/``, built on first use by ``ops.cuda.build``.
"""

__version__ = "0.1.0"
