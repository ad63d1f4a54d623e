"""Parity of the port's RandLA-Net slice with the JAX package, on the CPU.

The numpy host layer (grid sub-sampling, PLY, room preparation, the
spatially-regular sampler) must be array-equal to the JAX package's; the
pyramid's index lists equal; weights cross through ``utils/convert.py``;
the full-width forward matches the committed ``model_logits.npz`` fixture
to 1e-4; the NB / tar_NB attacks agree with the JAX engine (the CLI is
in ``test_torch_randla_cli.py``). The port runs its kernels' plain
versions (CPU tensors).
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import attacks as jattacks
from pointsecguard_tpu import configs as jconfigs
from pointsecguard_tpu.data import ply as jply
from pointsecguard_tpu.data import randla as jrandla
from pointsecguard_tpu.models import RandLANet as JaxRandLANet
from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
from pointsecguard_tpu.ops import subsample as jsubsample
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch import configs as tconfigs
from pointsecguard_tpu_torch.data import make_synthetic_rooms, ply, randla
from pointsecguard_tpu_torch.models import RandLANet, build_pyramid
from pointsecguard_tpu_torch.ops import subsample
from pointsecguard_tpu_torch.utils.convert import (
    randla_from_jax_variables,
    randla_to_jax_variables,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "model_logits.npz")
NARROW = {"d_out": (8, 16), "num_layers": 2, "sub_sampling_ratio": (4, 4)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(variables) -> dict:
    return {k: np.asarray(x) for k, x in flatten_dict(variables, sep="/").items()}


def _jax_pyramid(xyz, num_layers=5, sub_ratios=(4, 4, 4, 4, 2)):
    return jax.jit(lambda x: jax_build_pyramid(
        x, num_layers=num_layers, sub_ratios=sub_ratios, knn_tile=None))(xyz)


def _assert_pyramids_equal(jpyr, tpyr):
    for key in ("xyz", "neigh_idx", "sub_idx", "interp_idx"):
        assert len(jpyr[key]) == len(tpyr[key])
        for level, (j, t) in enumerate(zip(jpyr[key], tpyr[key])):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"{key}[{level}]")


# --- the numpy host layer ---


def test_grid_subsample_equals_jax_package():
    rng = np.random.default_rng(0)
    pts = (rng.random((3000, 3)) * 2).astype(np.float32)
    feats = rng.random((3000, 3)).astype(np.float32) * 255
    labels = rng.integers(0, 13, 3000)
    got = subsample.grid_subsample(pts, feats, labels, 0.1, 13)
    want = jsubsample.grid_subsample(pts, feats, labels, 0.1, 13)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_ply_round_trips_between_the_packages(tmp_path):
    rng = np.random.default_rng(1)
    cols = [rng.random((50, 3)).astype(np.float32), rng.integers(0, 13, 50).astype(np.uint8)]
    names = ["x", "y", "z", "class"]
    ply.write_ply(str(tmp_path / "a.ply"), cols, names)
    jply.write_ply(str(tmp_path / "b.ply"), cols, names)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    np.testing.assert_array_equal(ply.read_ply(str(tmp_path / "b.ply")),
                                  jply.read_ply(str(tmp_path / "a.ply")))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Synthetic rooms prepared by the port and by the JAX package (its
    numpy sub-sampler: the optional C++ route is not part of the port)."""
    root = tmp_path_factory.mktemp("randla_prep")
    make_synthetic_rooms(str(root / "rooms"), points_per_room=6000, seed=2)
    rooms = sorted(os.listdir(root / "rooms"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jrandla, "grid_subsample_native",
               lambda p, f, l, sample_dl, num_classes: jsubsample.grid_subsample(
                   p, f, l, sample_dl, num_classes or None))
    for name in rooms:
        randla.prepare_room(str(root / "rooms" / name), str(root / "port"), 0.1)
        jrandla.prepare_room(str(root / "rooms" / name), str(root / "jax"), 0.1)
    mp.undo()
    return root


def test_prepare_room_equals_jax_package(prepared):
    names = sorted(os.listdir(prepared / "port"))
    assert names == sorted(os.listdir(prepared / "jax")) and len(names) == 6
    for n in names:
        a, b = prepared / "port" / n, prepared / "jax" / n
        if n.endswith(".ply"):
            assert a.read_bytes() == b.read_bytes()
        elif n.endswith("_proj.pkl"):
            for x, y in zip(pickle.loads(a.read_bytes()), pickle.loads(b.read_bytes())):
                np.testing.assert_array_equal(x, y)
        else:  # the KD-tree answers the same queries
            q = np.random.default_rng(0).random((20, 3)) * 4
            for x, y in zip(pickle.loads(a.read_bytes()).query(q, k=5),
                            pickle.loads(b.read_bytes()).query(q, k=5)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("num_points", [512, 8192])  # 8192: up-sampled clouds
def test_sampler_batches_equal_jax_package(prepared, num_points):
    ours = randla.randla_dataset_preset("s3dis").make_sampler(
        str(prepared / "port"), "test", num_points, np.random.default_rng(3))
    theirs = jrandla.randla_dataset_preset("s3dis").make_sampler(
        str(prepared / "port"), "test", num_points, np.random.default_rng(3))
    assert len(ours.clouds[0].labels) < 8192  # the second case up-samples
    for got, want in zip(ours.batches(2, 3), theirs.batches(2, 3)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_label_lut_and_unported_datasets():
    """The three presets are ported: the outdoor ones ignore label 0 and
    equal the JAX presets' fields (tests/test_torch_randla_presets.py
    holds their loaders and label reduction); S3DIS's config equals the
    JAX one on every field the port keeps."""
    for name, classes, colors in (("semantickitti", 19, False), ("semantic3d", 8, True)):
        ours, theirs = randla.randla_dataset_preset(name), jrandla.randla_dataset_preset(name)
        assert (ours.num_classes, ours.ignored_labels, ours.has_colors) == (classes, (0,), colors)
        assert (ours.weights_key, ours.class_names) == (theirs.weights_key, theirs.class_names)
    preset = randla.randla_dataset_preset("s3dis")
    jpreset = jrandla.randla_dataset_preset("s3dis")
    assert preset.num_classes == jpreset.num_classes == 13
    ours = dataclasses.asdict(tconfigs.RandlaConfig())
    theirs = dataclasses.asdict(jconfigs.RandlaConfig())
    assert ours == {f: theirs[f] for f in ours}


# --- the pyramid and the model ---


@pytest.mark.parametrize("N", [512, 2048])
def test_build_pyramid_equals_jax(N):
    rng = np.random.default_rng(N)
    xyz = (rng.random((2, N, 3)) * 3).astype(np.float32)
    xyz[1, N // 2 :] = xyz[1, : N // 2]  # the sampler's repeated points
    jpyr = _jax_pyramid(xyz)
    _assert_pyramids_equal(jpyr, build_pyramid(torch.from_numpy(xyz)))


@pytest.fixture(scope="module")
def fix():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def full_width(fix):
    """JAX-initialised full-width RandLANet at PRNGKey(7), as in
    tests/test_fixtures.py, and the port model holding the same weights."""
    pyr = _jax_pyramid(jnp.asarray(fix["randla_xyz"]))
    variables = jax.jit(JaxRandLANet().init)(
        jax.random.PRNGKey(7), jnp.asarray(fix["randla_feats"]), pyr)
    flat = _flat(variables)
    model = RandLANet()
    model.load_state_dict(randla_from_jax_variables(flat))
    return flat, model.eval()


def test_full_width_logits_match_fixture(fix, full_width):
    flat, model = full_width
    assert len(flat) == 276
    assert sum(t.numel() for t in model.state_dict().values()) == 5_010_981
    pyr = build_pyramid(torch.from_numpy(fix["randla_xyz"]))
    with torch.no_grad():
        logits = model(torch.from_numpy(fix["randla_feats"]), pyr)
    assert logits.shape == (1, 512, 13)
    np.testing.assert_allclose(logits.numpy(), fix["randla_logits"], atol=1e-4)


def test_position_plan_equals_the_full_forward(fix, full_width):
    _, model = full_width
    feats = torch.from_numpy(fix["randla_feats"])
    pyr = build_pyramid(feats[..., :3])
    with torch.no_grad():
        plain = model(feats, pyr)
        collected, pos = model(feats, pyr, collect_pos=True)
        planned = model(feats, pyr, pos_plan=pos)
    assert len(pos) == 5
    assert torch.equal(collected, plain) and torch.equal(planned, plain)


def test_convert_round_trip_consumes_every_leaf(full_width):
    flat, model = full_width
    back = randla_to_jax_variables(model.state_dict())
    assert set(back) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    short = dict(flat)
    short.pop("params/DilatedResBlock_3/LocalFeatureAggregation_0/AttentivePooling_1/Dense_0/kernel")
    with pytest.raises(ValueError, match="missing"):
        randla_from_jax_variables(short)
    with pytest.raises(ValueError, match="unconsumed"):
        randla_from_jax_variables({**flat, "params/Extra_0/kernel": np.zeros((2, 2))})


def test_unported_attentive_pooling_is_refused():
    """"reference" and "fused" are the port's; the JAX package's Pallas
    interpreter mode ("fused_interpret") and any other name raise."""
    for ap_impl in ("fused_interpret", "pallas"):
        with pytest.raises(ValueError, match="unknown ap_impl"):
            RandLANet(ap_impl=ap_impl)


# --- the attacks on a narrow model ---


@pytest.fixture(scope="module")
def narrow(prepared):
    """A narrow two-layer RandLANet (JAX-initialised, weights carried
    into the port) and a batch of two 512-point clouds."""
    sampler = randla.randla_dataset_preset("s3dis").make_sampler(
        str(prepared / "port"), "test", 512, np.random.default_rng(5))
    _, feats, labels, _, _ = next(sampler.batches(2, 1))
    jmodel = JaxRandLANet(d_out=NARROW["d_out"])
    jpyr = _jax_pyramid(feats[..., :3], 2, NARROW["sub_sampling_ratio"])
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(feats), jpyr)
    model = RandLANet(d_out=NARROW["d_out"])
    model.load_state_dict(randla_from_jax_variables(_flat(variables)))
    model.eval().requires_grad_(False)
    tpyr = build_pyramid(torch.from_numpy(feats[..., :3]), num_layers=2,
                         sub_ratios=NARROW["sub_sampling_ratio"])
    return jmodel, variables, jpyr, model, tpyr, feats, labels.astype(np.int32)


@pytest.mark.parametrize("attack", ["nb", "tar_nb"])
def test_attack_matches_jax_on_a_narrow_model(narrow, attack):
    jmodel, variables, jpyr, model, tpyr, feats, labels = narrow
    # no random start: torch's generator cannot give jax.random's draw
    overrides = {"rand_init_eps": 0.0}
    mask = None
    if attack == "tar_nb":
        origin = int(np.bincount(labels.reshape(-1)).argmax())
        overrides.update(target=7, early_exit_sr=0.5)
        mask = labels == origin
    jcfg = jattacks.attack_preset("randla", attack, **overrides)
    tcfg = tattacks.attack_preset("randla", attack, **overrides)
    want = jax.jit(lambda f, y, m: jattacks.pgd_color_attack(
        lambda g: jmodel.apply(variables, g, jpyr), f, y, jcfg, mask=m))(
        feats, labels, mask)
    with torch.no_grad():
        _, pos = model(torch.from_numpy(feats), tpyr, collect_pos=True)
    got = tattacks.pgd_color_attack(
        lambda g: model(g, tpyr, pos_plan=pos), torch.from_numpy(feats),
        torch.from_numpy(labels).long(), tcfg,
        mask=None if mask is None else torch.from_numpy(mask))
    moved = np.abs(np.asarray(want.points_adv) - feats).max()
    assert moved > 0.01  # the attack really moved the colours
    np.testing.assert_allclose(got.points_adv.numpy(), np.asarray(want.points_adv),
                               atol=1e-4)
    np.testing.assert_array_equal(got.adv_pred.numpy(), np.asarray(want.adv_pred))
    np.testing.assert_array_equal(got.steps_b.numpy(), np.asarray(want.steps_b))
