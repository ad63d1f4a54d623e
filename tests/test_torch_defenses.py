"""The port's equal-norm noise control, colour defenses, defense wraps and
visual dumps against the JAX package, on the CPU.

``jax.random`` cannot be matched bit for bit, so each random function of
the port takes JAX's draw (``noise=``, ``choice=``, ``draw(shape, j)``) and
must then give the JAX function's output."""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu import attacks as jattacks
from pointsecguard_tpu import ops as jops
from pointsecguard_tpu.attacks import defenses as jdefenses
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.attacks import defenses as tdefenses
from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the port tests run on
    two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _points(B=3, N=256, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.random((B, N, 9)).astype(np.float32)
    pts[..., :3] *= np.array([1.0, 1.0, 3.0], np.float32)  # a room-like box
    return pts


# --- the equal-norm control -------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["all points", "masked"])
@pytest.mark.parametrize("centered", [False, True], ids=["positive", "centred"])
def test_equal_norm_noise_matches_jax(masked, centered):
    pts = _points()
    norms = np.array([0.5, 1.0, 17.0], np.float32)
    mask = (np.random.default_rng(1).random(pts.shape[:2]) < 0.3) if masked else None
    key = jax.random.PRNGKey(4)
    want = jattacks.equal_norm_color_noise(key, jnp.asarray(pts), jnp.asarray(norms), mask=None if mask is None else jnp.asarray(mask),
                                           centered=centered)
    # the JAX function's own draw, handed to the port
    draw = jax.random.uniform(key, pts[..., 3:6].shape, minval=-1.0 if centered else 0.0,
                              maxval=1.0)
    got = tattacks.equal_norm_color_noise(
        torch.from_numpy(pts), torch.from_numpy(norms),
        mask=None if mask is None else torch.from_numpy(mask),
        centered=centered, noise=torch.from_numpy(np.asarray(draw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # before the clip, each cloud moved by exactly its target norm
    raw = tattacks.equal_norm_color_noise(
        torch.from_numpy(pts), torch.from_numpy(norms),
        mask=None if mask is None else torch.from_numpy(mask), clip=None,
        noise=torch.from_numpy(np.asarray(draw)))
    moved = (raw[..., 3:6] - torch.from_numpy(pts[..., 3:6])).reshape(3, -1)
    np.testing.assert_allclose(torch.linalg.norm(moved, dim=1).numpy(), norms, rtol=1e-5)
    if masked:
        assert torch.equal(got[torch.from_numpy(~mask)], torch.from_numpy(pts[~mask]))
    assert torch.equal(got[..., :3], torch.from_numpy(pts[..., :3]))
    assert torch.equal(got[..., 6:], torch.from_numpy(pts[..., 6:]))


def test_equal_norm_noise_from_a_generator_is_positive_and_reproducible():
    pts = torch.from_numpy(_points())
    norms = torch.ones(3)
    a = tattacks.equal_norm_color_noise(pts, norms, clip=None,
                                        generator=torch.Generator().manual_seed(0))
    b = tattacks.equal_norm_color_noise(pts, norms, clip=None,
                                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert (a[..., 3:6] >= pts[..., 3:6]).all()  # U[0, 1): every channel moves up
    with pytest.raises(ValueError, match="noise= or generator="):
        tattacks.equal_norm_color_noise(pts, norms)


# --- bit depth and jitter ----------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bit_depth_matches_jax_with_identity_gradient(bits):
    pts = _points()
    want = jattacks.bit_depth_reduction(jnp.asarray(pts), bits)
    x = torch.from_numpy(pts).requires_grad_(True)
    got = tattacks.bit_depth_reduction(x, bits)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(pts.shape).astype(np.float32))
    (g,) = torch.autograd.grad(torch.sum(got * w), x)
    assert torch.equal(g, w)  # straight through on the colours, identity elsewhere


def test_jitter_matches_jax_given_its_normal_draw():
    pts = _points()
    key = jax.random.PRNGKey(7)
    want = jattacks.random_color_jitter(jnp.asarray(pts), key, sigma=0.05)
    draw = np.asarray(jax.random.normal(key, pts[..., 3:6].shape))
    got = tattacks.random_color_jitter(torch.from_numpy(pts), 0.05,
                                       noise=torch.from_numpy(draw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert torch.equal(got[..., :3], torch.from_numpy(pts[..., :3]))
    assert (got[..., 3:6] >= 0).all() and (got[..., 3:6] <= 1).all()


# --- JPEG ---------------------------------------------------------------------

def _near_half_boundary(pts, quality, block=64):
    """[B, N] bool: the points of every (block, channel) with a DCT
    coefficient whose ``coeffs / step`` lies within 1e-5 of a .5 boundary,
    computed in float64. There ``jnp.round`` and ``torch.round`` (both half
    to even) may round the two packages' float32 einsums, which reassociate,
    to different steps."""
    color = pts[..., 3:6].astype(np.float64)
    B, N, C = color.shape
    pad = (-N) % block
    x = np.pad(color, ((0, 0), (0, pad), (0, 0))).reshape(B, -1, block, C)
    k = np.arange(block)
    D = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * block)) * np.sqrt(2 / block)
    D[0] /= np.sqrt(2.0)
    q = float(quality)
    scale = (5000.0 / q if q < 50 else 200.0 - 2.0 * q) / 100.0
    step = np.maximum((16.0 + 4.0 * k) * scale / 255.0 * np.sqrt(block / 2.0), 1e-6)
    ratio = np.einsum("fk,bnkc->bnfc", D, x) / step[None, None, :, None]
    frac = ratio - np.floor(ratio)
    near = (np.abs(frac - 0.5) < 1e-5).any(axis=2)  # [B, blocks, C]
    return np.repeat(near, block, axis=1)[:, :N]  # [B, N, C]


@pytest.mark.parametrize("quality", [95, 10])
@pytest.mark.parametrize("N", [4096, 4000], ids=["N 4096", "ragged N 4000"])
def test_jpeg_matches_jax_outside_rounding_boundaries(quality, N):
    pts = _points(B=2, N=N, seed=3)
    want = np.asarray(jattacks.jpeg_color_compression(jnp.asarray(pts), quality))
    x = torch.from_numpy(pts).requires_grad_(True)
    got = tattacks.jpeg_color_compression(x, quality)
    near = _near_half_boundary(pts, quality)
    diff = np.abs(got.detach().numpy() - want)
    exempt = np.zeros(pts.shape, bool)
    exempt[..., 3:6] = near
    assert near.mean() < 0.05, near.mean()  # the rule excuses few points
    assert diff[~exempt].max() <= 1e-6, diff[~exempt].max()
    assert np.abs(got.detach().numpy()[..., 3:6] - pts[..., 3:6]).max() > 0  # it does quantize
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(pts.shape).astype(np.float32))
    (g,) = torch.autograd.grad(torch.sum(got * w), x)
    assert torch.equal(g, w)  # straight through


@pytest.mark.parametrize("quality", [0, 101])
def test_jpeg_refuses_quality_outside_libjpeg_range(quality):
    with pytest.raises(ValueError, match=r"\[1, 100\]"):
        tattacks.jpeg_color_compression(torch.from_numpy(_points()), quality)


def test_dct_matrix_matches_jax():
    np.testing.assert_allclose(tdefenses._dct_matrix(64).numpy(),
                               np.asarray(jdefenses._dct_matrix(64)), rtol=0, atol=1e-7)


# --- resample -----------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 64], ids=["k 8 (kernel route)", "k 64 (past MAX_K)"])
def test_resample_matches_jax_given_its_choice(k):
    """k past the kNN kernel's MAX_K takes ``dense_knn_graph``'s other
    route (square distances and the stable sort) and never raises."""
    assert (k > knn_kernel.MAX_K) == (k == 64)
    pts = _points(B=2, N=512, seed=5)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jattacks.random_color_resample(jnp.asarray(pts), key, k))
    _, jidx = jops.knn(jnp.asarray(pts[..., :3]), jnp.asarray(pts[..., :3]), k)
    tidx = tdefenses.resample_neighbors(torch.from_numpy(pts), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    choice = np.asarray(jax.random.randint(key, (2, 512, 1), 0, k))
    x = torch.from_numpy(pts).requires_grad_(True)
    got = tattacks.random_color_resample(x, k, choice=torch.from_numpy(choice))
    np.testing.assert_array_equal(got.detach().numpy(), want)  # an exact gather
    # the colour gradient is the scatter of the cotangent over the picks
    w = np.random.default_rng(6).standard_normal(pts.shape).astype(np.float32)
    (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)), x)
    picked = np.take_along_axis(np.asarray(jidx), choice, axis=2)[..., 0]
    expect = np.zeros_like(pts)
    expect[..., :3] = w[..., :3]
    expect[..., 6:] = w[..., 6:]
    for b in range(2):
        np.add.at(expect[b, :, 3:6], picked[b], w[b, :, 3:6])
    np.testing.assert_allclose(g.numpy(), expect, rtol=1e-6, atol=1e-6)


def test_resample_k_past_n_takes_every_point():
    pts = torch.from_numpy(_points(B=1, N=6))
    out = tattacks.random_color_resample(pts, 8, generator=torch.Generator().manual_seed(0))
    colors = {tuple(c) for c in pts[0, :, 3:6].tolist()}
    assert all(tuple(c) in colors for c in out[0, :, 3:6].tolist())


# --- the defense wraps --------------------------------------------------------

def _stand_in(p):
    return p[..., 3:6] * 2.0


def test_defense_wraps_match_jax_fixed_draws():
    """eval_wrap: the one deployed draw, the same on every call; attack_wrap
    at eot = 1: eval_wrap itself; at eot = 3: the mean over three fixed
    draws, the same three on every call (JAX `defenses.py:42-49`;
    tests/test_robustness.py's contract)."""
    pts = _points(B=2, N=16, seed=7)
    key = jax.random.PRNGKey(3)
    jtransform = lambda p, k: jattacks.random_color_jitter(p, k, 0.05)
    keys = [key] + list(jax.random.split(key, 3))
    draws = [np.asarray(jax.random.normal(k, (2, 16, 3))) for k in keys]
    calls = []

    def draw(shape, j):
        calls.append(j)
        return torch.from_numpy(draws[j])

    ttransform = lambda p, d: tattacks.random_color_jitter(p, 0.05, noise=d)
    x = torch.from_numpy(pts)
    ev1, atk1 = tattacks.randomized_defense_wraps(ttransform, draw, eot=1)
    assert ev1 is atk1
    first = ev1(_stand_in)(x)
    assert torch.equal(first, ev1(_stand_in)(x))
    jev, jatk = jattacks.randomized_defense_wraps(jtransform, key, eot=3)
    np.testing.assert_allclose(first.numpy(), np.asarray(jev(_stand_in)(jnp.asarray(pts))), atol=1e-7)

    calls.clear()
    ev, atk = tattacks.randomized_defense_wraps(ttransform, draw, eot=3)
    got = atk(_stand_in)(x)
    assert torch.equal(got, atk(_stand_in)(x))
    assert sorted(calls) == [0, 1, 2, 3]  # each draw made once, then reused
    assert torch.equal(ev(_stand_in)(x), first)
    np.testing.assert_allclose(got.numpy(), np.asarray(jatk(_stand_in)(jnp.asarray(pts))), rtol=1e-6,
                               atol=1e-7)
    assert not torch.allclose(got, first)


def test_seeded_draws_are_fixed_and_distinct():
    sample = lambda shape, g: torch.randn(shape, generator=g)
    draw = tattacks.seeded_draws(sample, 99)
    d = [draw((2, 3), j) for j in range(3)]
    assert torch.equal(d[0], draw((2, 3), 0)) and torch.equal(d[2], draw((2, 3), 2))
    assert not torch.equal(d[0], d[1]) and not torch.equal(d[1], d[2])


def _args(**kw):
    base = dict(defense="none", eot=1, seed=0, defense_bits=4, defense_sigma=0.02,
                defense_quality=95, defense_knn=8)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("defense", ["none", "bit_depth", "jpeg"])
def test_eot_needs_a_randomized_defense_with_the_jax_message(defense):
    from pointsecguard_tpu.cli._attack_common import defense_wrapper as jwrapper
    from pointsecguard_tpu_torch.cli._attack_common import defense_wrapper

    with pytest.raises(SystemExit) as want:
        jwrapper(_args(defense=defense, eot=2), jax)
    with pytest.raises(SystemExit) as got:
        defense_wrapper(_args(defense=defense, eot=2))
    assert str(got.value) == str(want.value)


def test_defense_wrapper_builds_each_defense():
    from pointsecguard_tpu_torch.cli._attack_common import defense_wrapper

    assert defense_wrapper(_args()) is None
    x = torch.from_numpy(_points(B=2, N=64))
    for name in ("bit_depth", "jpeg", "jitter", "resample"):
        ev, atk = defense_wrapper(_args(defense=name))
        assert ev is atk
        out = ev(_stand_in)(x)
        assert torch.equal(out, ev(_stand_in)(x))  # one deployed draw
    ev, atk = defense_wrapper(_args(defense="resample", eot=2))
    assert atk is not ev and atk(_stand_in)(x).shape == (2, 64, 3)
    # the deployed draw depends on --seed alone, not on earlier calls
    again, _ = defense_wrapper(_args(defense="resample", eot=2))
    assert torch.equal(again(_stand_in)(x), ev(_stand_in)(x))


# --- visual dumps ---------------------------------------------------------------

def test_visual_files_equal_jax(tmp_path):
    from pointsecguard_tpu.utils import logging as jlog
    from pointsecguard_tpu.utils import viz as jviz
    from pointsecguard_tpu_torch.utils import logging as tlog
    from pointsecguard_tpu_torch.utils import viz as tviz

    rng = np.random.default_rng(8)
    xyz = rng.random((300, 3)).astype(np.float32)
    rgb = rng.random((300, 3)).astype(np.float32)
    labels = rng.integers(0, 20, 300)
    for pal in (13, 20):
        np.testing.assert_array_equal(tlog.label_palette(pal), jlog.label_palette(pal))
    cases = [
        ("rgb.xyzrgb", lambda m, p: m.write_xyzrgb(p, xyz, rgb)),
        ("rgb255.xyzrgb", lambda m, p: m.write_xyzrgb(p, xyz, (rgb * 255).astype(np.uint8))),
        ("labels.xyzrgb", lambda m, p: m.write_label_cloud(p, xyz, labels)),
    ]
    for name, write in cases:
        write(jlog, tmp_path / ("j" + name))
        write(tlog, tmp_path / ("t" + name))
        assert (tmp_path / ("t" + name)).read_bytes() == (tmp_path / ("j" + name)).read_bytes()
    # the viewer: the same page and the same numbers at 4 decimals. The JAX
    # array2string (quadratic in the cloud's size) pads with spaces, and
    # switches to 5 significant digits when a value lies below 1e-4, so the
    # numbers agree to its last digit
    arrays = re.compile(r"new Float32Array\((\[[^\]]*\])\)")
    for kw in (dict(colors=rgb), dict(labels=labels), dict(colors=rgb * 255, max_points=100),
               dict(colors=rgb - 0.5)):
        jviz.export_html_viewer(str(tmp_path / "j.html"), xyz, title="a room", **kw)
        tviz.export_html_viewer(str(tmp_path / "t.html"), xyz, title="a room", **kw)
        got, want = (tmp_path / "t.html").read_text(), (tmp_path / "j.html").read_text()
        assert arrays.sub("[]", got) == arrays.sub("[]", want)
        g, w = arrays.findall(got), arrays.findall(want)
        assert len(g) == len(w) == 2
        for a, b in zip(g, w):
            np.testing.assert_allclose(np.array(a[1:-1].split(","), float),
                                       np.array(b[1:-1].split(","), float), rtol=0, atol=1e-4)
