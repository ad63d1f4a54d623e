"""Checkpoints of the port: ``torch.save`` of plain dicts under
``<log_dir>/checkpoints/`` (port of
``pointsecguard_tpu/utils/checkpoint.py:18-71``).

``best.pt`` is a plain model state dict, the weights of the epoch with
the highest mIoU so far: it is what the attack and eval CLIs read.
``latest.pt`` holds the newest epoch saved, with what a resumed run
needs: model, Adam moments and count, step, epoch and the best mIoU.
The JAX package keeps orbax checkpoints, which the port cannot read on a
machine without JAX; weights cross from it with ``utils.convert``. orbax
in best-mode keeps the five highest-mIoU epochs, so its "latest" can be
an older epoch than the last one trained; here a run resumes from the
newest epoch saved.
"""

from __future__ import annotations

import os

import torch

BEST = "best.pt"
LATEST = "latest.pt"


def checkpoint_dir(log_dir: str) -> str:
    return os.path.join(log_dir, "checkpoints")


def _cpu(tree):
    """Tensors of a (nested) dict as independent CPU copies."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _write(path: str, payload: dict) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_cpu(payload), tmp)
    os.replace(tmp, path)
    return path


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(log_dir: str, state_dict: dict) -> str:
    """Write ``state_dict`` as ``best.pt`` (tensors moved to the CPU),
    atomically."""
    return _write(os.path.join(checkpoint_dir(log_dir), BEST), state_dict)


def load_checkpoint(log_dir: str) -> dict:
    """The model state dict of the best checkpoint, else of the latest;
    SystemExit if there is neither."""
    d = checkpoint_dir(log_dir)
    if os.path.exists(os.path.join(d, BEST)):
        return _read(os.path.join(d, BEST))
    if os.path.exists(os.path.join(d, LATEST)):
        return _read(os.path.join(d, LATEST))["model"]
    raise SystemExit(f"no checkpoint under {d}")


class CheckpointManager:
    """Saves per evaluated epoch, the best-mIoU copy, and auto-resume.

    ``save(epoch, payload, miou=)`` writes ``payload`` (a dict with a
    ``"model"`` state dict, see ``train.trainer.TrainState.payload``) as
    ``latest.pt`` and, with ``keep="best"``, when ``miou`` is the highest
    so far, its model as ``best.pt``. ``keep="latest"`` writes no
    ``best.pt``, so that ``load_checkpoint`` reads the newest epoch: the
    JAX ResGCN loop's keep-latest manager, whose save metric is only
    −loss (`pointsecguard_tpu/train/loops.py:558-561`)."""

    def __init__(self, directory: str, *, keep: str = "best"):
        if keep not in ("best", "latest"):
            raise ValueError(f"keep must be 'best' or 'latest', got {keep!r}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, epoch: int, payload: dict, *, miou: float = 0.0) -> None:
        latest = self.restore_latest()
        best = latest["best_miou"] if latest else None
        is_best = best is None or float(miou) >= best
        _write(self._path(LATEST), dict(
            payload, epoch=int(epoch),
            best_miou=float(miou) if is_best else best))
        if self.keep == "best" and (is_best or not os.path.exists(self._path(BEST))):
            _write(self._path(BEST), payload["model"])

    def restore_latest(self) -> dict | None:
        """The newest payload saved (``payload["epoch"]`` says which), or
        None (best-effort auto-resume, `train_semseg.py:115-123`)."""
        path = self._path(LATEST)
        return _read(path) if os.path.exists(path) else None

    def restore_best(self) -> dict | None:
        """The model state dict with the highest mIoU, or None."""
        path = self._path(BEST)
        return _read(path) if os.path.exists(path) else None
