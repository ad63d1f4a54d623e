"""Model weights made on the device from the seed, in one draw.

A configuration's ``init`` names the rule: ``uniform_fan_in`` draws every
Linear weight and bias uniform in ±1/√fan_in (torch's default, as the
port's smoke run makes its PointNet++ checkpoints); ``kaiming_normal``
draws every weight from a normal of variance 2/fan_in truncated at two
standard deviations, with zero biases (the port trainer's init for
ResGCN, flax's ``kaiming_normal``). BatchNorm starts at scale 1, bias 0,
mean 0, variance 1. One ``torch.rand`` call on the device covers every
drawn entry; each entry is a slice of it.
"""

from __future__ import annotations

import math

import torch

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to ±2


def make_state(spec, init: str, seed: int, device) -> dict:
    """``spec``: (name, shape, fan_in, role) rows of a reference's
    ``param_spec`` → {name: float32 tensor on ``device``}."""
    drawn = [row for row in spec if row[3] == "weight"
             or (row[3] == "bias" and init == "uniform_fan_in")]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(math.prod(r[1]) for r in drawn), generator=gen, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    state, at = {}, 0
    fill = {"bias": 0.0, "bn_scale": 1.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    for name, shape, fan_in, role in spec:
        if role == "weight" or (role == "bias" and init == "uniform_fan_in"):
            n = math.prod(shape)
            x = u[at:at + n].reshape(shape)
            at += n
            if init == "uniform_fan_in":
                state[name] = (2.0 * x - 1.0) / math.sqrt(fan_in)
            elif init == "kaiming_normal":
                unit = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + x * (1.0 - 2.0 * lo)) - 1.0)
                state[name] = unit * (math.sqrt(2.0 / fan_in) / _TRUNC_STD)
            else:
                raise ValueError(f"unknown init {init!r}")
        else:
            state[name] = torch.full(shape, fill[role], dtype=torch.float32, device=device)
    return state


def state_floats(state: dict) -> int:
    return sum(t.numel() for t in state.values())
