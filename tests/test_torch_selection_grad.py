"""The value gradient of ``ops.selection.bottom_k_indices``: one
``autograd.Function`` serves every route (kernel B, the wide-row kernel,
the stable sort past k = 48), so a gradient through the selected values
is the same on the CPU and on the card. On the CPU every route takes its
plain version; the Function's backward must equal the gradient that
``torch.sort`` itself carries, and the 3-NN weights' gradient must equal
the JAX package's, whose ``_pallas_bottom_k_diff`` gives it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.ops import three_nn_plan as jax_three_nn_plan
from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.ops.cuda.bottomk import bottom_k_plain
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices


def _sort_cut(vals, k):
    """The plain versions' own autograd path: a stable sort cut to k."""
    v, i = torch.sort(vals, dim=-1, stable=True)
    return v[..., :k], i[..., :k]


@pytest.mark.parametrize("shape,k", [
    ((2, 5, 100), 3),      # kernel B's route
    ((3, 7, 8192), 48),    # kernel B at its width limit
    ((1, 3, 9000), 16),    # the wide-row kernel's route: N > 8192
    ((2, 4, 200), 60),     # k > 48: the stable sort
], ids=["narrow", "narrow N=8192", "wide N=9000", "sort k=60"])
def test_value_gradient_equals_the_sorts(shape, k):
    rng = np.random.default_rng(0)
    # rounded: many ties, whose first occurrence both must pick
    base = np.round(rng.standard_normal(shape) * 8) / 8
    cot = torch.from_numpy(rng.standard_normal((*shape[:-1], k)).astype(np.float32))
    grads = []
    for select in (bottom_k_indices, _sort_cut):
        vals = torch.tensor(base, dtype=torch.float32, requires_grad=True)
        v, i = select(vals, k)
        (v * cot).sum().backward()
        grads.append((v.detach(), i.int(), vals.grad))
    (v, i, g), (v_ref, i_ref, g_ref) = grads
    assert torch.equal(v, v_ref) and torch.equal(i, i_ref)
    assert torch.equal(g, g_ref)
    assert int((g != 0).sum()) == cot.numel()  # one entry a selected value
    want_v, want_i = bottom_k_plain(torch.tensor(base, dtype=torch.float32), k)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)


def test_value_gradient_keeps_the_input_dtype():
    vals = torch.randn((2, 3, 50), dtype=torch.float64, requires_grad=True)
    v, i = bottom_k_indices(vals, 4)
    assert v.dtype == torch.float64 and i.dtype == torch.int32 and v.requires_grad
    v.sum().backward()
    assert vals.grad.dtype == torch.float64
    want = torch.zeros_like(vals).scatter_(-1, i.long(), 1.0)
    assert torch.equal(vals.grad, want)


def test_indices_carry_no_gradient_and_plain_values_no_graph():
    v, i = bottom_k_indices(torch.randn(2, 30), 5)
    assert not v.requires_grad and not i.requires_grad
    x = torch.randn(2, 30, requires_grad=True)
    _, i = bottom_k_indices(x, 5)
    assert not i.requires_grad


@pytest.mark.parametrize("n_dst,n_src", [(256, 64), (1024, 9000)],
                         ids=["narrow", "wide rows"])
def test_three_nn_weight_gradient_matches_jax(n_dst, n_src):
    """d(Σ c · w)/d(xyz) of the 3-NN weights, w.r.t. both point sets, on
    the CPU, against ``jax.grad`` of the JAX package's ``three_nn_plan``.
    The weights go as 1 / d², and d² = |q|² − 2 q·p + |p|² rounds to
    ~1e-7 whatever its size, so near pairs (d² ~ 1e-4 among 9000 points)
    carry a relative error of ~1e-3 into the gradient on either side:
    each entry within 1e-3 of the largest, the whole within 1e-3 in
    relative L2. Without the value gradient the weights would carry no
    gradient at all."""
    rng = np.random.default_rng(1)
    dst = rng.random((2, n_dst, 3)).astype(np.float32)
    src = rng.random((2, n_src, 3)).astype(np.float32)
    cot = rng.standard_normal((2, n_dst, 3)).astype(np.float32)

    def jax_loss(d, s):
        _, w = jax_three_nn_plan(d, s)
        return jnp.sum(w * cot)

    want_d, want_s = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(dst), jnp.asarray(src))
    d = torch.from_numpy(dst).requires_grad_(True)
    s = torch.from_numpy(src).requires_grad_(True)
    idx, w = ops.three_nn_plan(d, s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_three_nn_plan(dst, src)[0]))
    (w * torch.from_numpy(cot)).sum().backward()
    for got, want in ((d.grad, want_d), (s.grad, want_s)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * scale)
        assert np.linalg.norm(got.numpy() - want) < 1e-3 * np.linalg.norm(want)
