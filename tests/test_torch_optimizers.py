"""Parity of the port's ``train/optimizers.py`` with the JAX package's
(``pointsecguard_tpu/train/optimizers.py``, optax underneath), on the CPU.

``radam`` and ``adamw`` take 20 steps from the same parameters on the same
gradients (numpy-seeded; several tensors, one of them a scalar) as the JAX
package's optax transformations: with β₂ = 0.999, RAdam's ρₜ crosses its
threshold of 5 between steps 5 and 6, so steps 1–5 are the momentum alone
and 6–20 the rectified update. float64 (``jax.enable_x64``) within 1e-12,
float32 within 1e-6, both relative to the largest parameter. The loss and
metric extras against JAX's on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointsecguard_tpu.train import optimizers as jopt
from pointsecguard_tpu_torch.train import optimizers as topt

SHAPES = {"w": (4, 3), "b": (3,), "s": ()}
STEPS = 20
TOL = {np.float64: 1e-12, np.float32: 1e-6}


def _draws(seed: int, dtype):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 1, s).astype(dtype) for k, s in SHAPES.items()}
    # gradients of mixed scale and sign, one set a step
    grads = [{k: (rng.normal(0, 1, s) * 10.0 ** rng.integers(-3, 1)).astype(dtype)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _jax_run(tx, params, grads):
    """The optax steps jitted, as a JAX train step runs them: eagerly, a
    concrete step count takes ``integer_pow`` for β₂ᵗ and rounds otherwise."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)

    @jax.jit
    def step(p, state, g):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    out = []
    for g in grads:
        p, state = step(p, state, {k: jnp.asarray(v) for k, v in g.items()})
        out.append({k: np.asarray(v) for k, v in p.items()})
    return out


def _torch_run(make, params, grads):
    p = {k: torch.nn.Parameter(torch.from_numpy(np.array(v))) for k, v in params.items()}
    opt = make(list(p.values()))
    out = []
    for g in grads:
        for k, v in g.items():
            p[k].grad = torch.from_numpy(np.array(v))
        opt.step()
        out.append({k: v.detach().numpy().copy() for k, v in p.items()})
    return out


def _assert_steps(got, want, dtype):
    scale = max(np.abs(v).max() for v in want[0].values())
    for step, (g, w) in enumerate(zip(got, want), 1):
        for k in SHAPES:
            assert g[k].dtype == dtype
            err = np.abs(g[k].astype(np.float64) - w[k]).max() / scale
            assert err <= TOL[dtype], f"step {step} {k}: {err:.3e}"


OPTIMIZERS = {
    "radam": (lambda: jopt.radam(3e-2), lambda ps: topt.radam(ps, 3e-2)),
    "adamw": (lambda: jopt.adamw(3e-2, weight_decay=0.1),
              lambda ps: topt.adamw(ps, 3e-2, weight_decay=0.1)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_equals_optax_step_for_step(name, dtype):
    make_jax, make_torch = OPTIMIZERS[name]
    params, grads = _draws(3, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = _jax_run(make_jax(), params, grads)
    assert all(v.dtype == dtype for v in want[-1].values())
    _assert_steps(_torch_run(make_torch, params, grads), want, dtype)


def test_radam_switches_at_rho_five_and_is_not_torch_radam():
    """Steps 1–5 move by the bias-corrected momentum alone (ρₜ < 5), from
    step 6 on by the rectified update; ``torch.optim.RAdam`` (which divides
    by √v + eps before the bias correction and rectifies only for ρₜ > 5)
    takes other steps, so the port does not borrow it."""
    params, grads = _draws(5, np.float64)
    lr = 3e-2
    got = _torch_run(lambda ps: topt.radam(ps, lr), params, grads)
    assert not isinstance(topt.radam([torch.nn.Parameter(torch.zeros(1))]), torch.optim.RAdam)
    b1, mu, p = 0.9, 0.0, params["s"]
    for t in range(1, 6):
        mu = b1 * mu + (1 - b1) * grads[t - 1]["s"]
        p = p - lr * mu / (1 - b1 ** t)
        np.testing.assert_allclose(got[t - 1]["s"], p, rtol=1e-13)
    stock = _torch_run(lambda ps: torch.optim.RAdam(ps, lr), params, grads)
    assert max(np.abs(stock[-1][k] - got[-1][k]).max() for k in SHAPES) > 1e-9


@pytest.mark.parametrize("smoothing", [0.0, 0.2, 0.5])
def test_smooth_cross_entropy_value_and_gradient(smoothing):
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, (6, 5, 13))
    labels = rng.integers(0, 13, (6, 5))
    with jax.enable_x64(True):
        f = lambda z: jopt.smooth_cross_entropy(z, jnp.asarray(labels), smoothing=smoothing)
        want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    z = torch.tensor(logits, requires_grad=True)
    got = topt.smooth_cross_entropy(z, torch.from_numpy(labels), smoothing=smoothing)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-13)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g), atol=1e-15)
    # float32 and an explicit class count
    got32 = topt.smooth_cross_entropy(torch.tensor(logits, dtype=torch.float32),
                                      torch.from_numpy(labels), smoothing=smoothing,
                                      num_classes=13)
    want32 = jopt.smooth_cross_entropy(jnp.asarray(logits, jnp.float32), jnp.asarray(labels),
                                       smoothing=smoothing, num_classes=13)
    np.testing.assert_allclose(got32.item(), float(want32), rtol=1e-6)


def test_psnr_and_average_meter():
    rng = np.random.default_rng(8)
    x, y = rng.random((3, 32, 32)), rng.random((3, 32, 32))
    with jax.enable_x64(True):
        for a, b in ((x, y), (x, x), (x, x + 1e-9)):  # the 1e-12 floor on the MSE
            np.testing.assert_allclose(topt.psnr(torch.from_numpy(a), torch.from_numpy(b),
                                                 max_val=2.0).item(),
                                       float(jopt.psnr(jnp.asarray(a), jnp.asarray(b),
                                                       max_val=2.0)), rtol=1e-13)
    got, want = topt.AverageMeter(), jopt.AverageMeter()
    assert vars(got) == vars(want)
    for val, n in ((1.5, 2), (0.25, 1), (3.0, 5)):
        got.update(val, n)
        want.update(val, n)
        assert vars(got) == vars(want)
    got.reset()
    want.reset()
    assert vars(got) == vars(want)
