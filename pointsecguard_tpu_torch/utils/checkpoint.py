"""Checkpoints of the port: a ``torch.save`` state dict per file under
``<log_dir>/checkpoints/``.

The JAX package keeps orbax checkpoints, which the port cannot read on a
machine without JAX; weights cross from it with ``utils.convert``.
"""

from __future__ import annotations

import os

import torch

BEST = "best.pt"


def checkpoint_dir(log_dir: str) -> str:
    return os.path.join(log_dir, "checkpoints")


def save_checkpoint(log_dir: str, state_dict: dict) -> str:
    """Write ``state_dict`` (tensors moved to the CPU) atomically."""
    d = checkpoint_dir(log_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, BEST)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(log_dir: str) -> dict:
    """The saved state dict; SystemExit if there is none."""
    path = os.path.join(checkpoint_dir(log_dir), BEST)
    if not os.path.exists(path):
        raise SystemExit(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
