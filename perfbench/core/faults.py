"""Faults planted under a cell's timed path, for the tests and
``calibrate.py`` (a benchmark run plants none): each is a wrapper of the
port's function at one of the drivers' hooks (``core.run.Run.hooks``).

- ``unchanged_state``: the attack hands the clean points back; the
  training step leaves the parameters as they were.
- ``half_batch``: half of the batch left out: the attack's loss reaches
  the first half of the clouds only; the training step runs on the first
  half of the batch's clouds, its loss the mean over them.
- ``answer_altered``: one adversarial prediction changed where it is made.
- ``moments_reset``: the training step starts Adam's moments from nought
  every call (the first step is then sound; the later ones are not).
"""

from __future__ import annotations

import torch


def _attack_unchanged(fn):
    def attack(f, points, labels, cfg, **kw):
        return fn(f, points, labels, cfg, **kw)._replace(points_adv=points.detach())
    return attack


def _attack_half(fn):
    def attack(f, points, labels, cfg, **kw):
        h = points.shape[0] // 2

        def first_half(p):
            out = f(p)
            return torch.cat([out[:h], out[h:].detach()])

        return fn(first_half, points, labels, cfg, **kw)
    return attack


def _predict_altered(fn):
    def predict(out):
        pred = fn(out).clone()
        pred[0, 0] = (pred[0, 0] + 1) % out.shape[-1]
        return pred
    return predict


def _step_unchanged(fn):
    def step(state, *args, **kw):
        kept = state.params.clone()
        losses = fn(state, *args, **kw)
        state.params.copy_(kept)
        return losses
    return step


def _step_half(fn):
    def step(state, points, labels, *args, **kw):
        h = points.shape[1] // 2
        return fn(state, points[:, :h], labels[:, :h], *args, **kw)
    return step


def _step_moments_reset(fn):
    def step(state, *args, **kw):
        state.mu.zero_()
        state.nu.zero_()
        return fn(state, *args, **kw)
    return step


# driver kind → fault → (hook, wrapper)
FAULTS = {
    "attack": {"unchanged_state": ("attack", _attack_unchanged),
               "half_batch": ("attack", _attack_half),
               "answer_altered": ("predict", _predict_altered)},
    "train": {"unchanged_state": ("step", _step_unchanged),
              "half_batch": ("step", _step_half),
              "moments_reset": ("step", _step_moments_reset)},
}


def hooks(kind: str, fault: str | None) -> dict:
    """The ``Run.hooks`` that plant ``fault`` (none for None)."""
    if fault is None:
        return {}
    hook, wrap = FAULTS[kind][fault]
    return {hook: wrap}
