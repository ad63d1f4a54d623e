"""The port's RandLA-Net dataset presets on the CPU against the JAX
package: the presets' fields and configs, the raw-label reduction, the
SemanticKITTI and Semantic3D loaders and their sampler draws (xyz-only
SemanticKITTI features too), the ignored-label loss and its gradient, and
the SemanticKITTI (4 layers, 3 input channels, 19 classes) and Semantic3D
(5 layers, 8 classes) models at full width on JAX-initialised weights
crossed through ``utils/convert.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import configs as jconfigs
from pointsecguard_tpu.data import randla as jrandla
from pointsecguard_tpu.models import RandLANet as JaxRandLANet
from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
from pointsecguard_tpu.models.randlanet import weighted_softmax_ce_loss as jax_loss
from pointsecguard_tpu_torch import configs as tconfigs
from pointsecguard_tpu_torch.cli import prepare
from pointsecguard_tpu_torch.data import randla
from pointsecguard_tpu_torch.data import synthetic_outdoor as synth
from pointsecguard_tpu_torch.data.class_weights import get_class_weights
from pointsecguard_tpu_torch.models import RandLANet, build_pyramid, weighted_softmax_ce_loss
from pointsecguard_tpu_torch.utils.convert import (
    randla_from_jax_variables,
    randla_to_jax_variables,
)

DATASETS = ["s3dis", "semantickitti", "semantic3d"]
# the fields of the outdoor configs a ported path reads
KEPT = {"k_n", "num_layers", "num_points", "num_classes", "sub_grid_size", "batch_size",
        "val_batch_size", "train_steps", "val_steps", "sub_sampling_ratio", "d_out",
        "noise_init", "learning_rate", "lr_decay"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dataset", DATASETS)
def test_preset_fields_equal_jax_package(dataset):
    ours, theirs = randla.randla_dataset_preset(dataset), jrandla.randla_dataset_preset(dataset)
    for field in ("name", "num_classes", "class_names", "ignored_labels", "weights_key",
                  "has_colors"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert len(ours.class_names) == ours.num_classes
    cfg, jcfg = dataclasses.asdict(ours.cfg), dataclasses.asdict(theirs.cfg)
    assert cfg == {f: jcfg[f] for f in cfg}
    if dataset != "s3dis":
        assert set(cfg) == KEPT and cfg["num_classes"] == ours.num_classes
    assert len(get_class_weights(ours.weights_key)) == ours.num_classes


def test_outdoor_configs_match_the_jax_classes():
    assert (dataclasses.asdict(tconfigs.RandlaSemanticKITTIConfig()).items()
            <= dataclasses.asdict(jconfigs.RandlaSemanticKITTIConfig()).items())
    assert (dataclasses.asdict(tconfigs.RandlaSemantic3DConfig()).items()
            <= dataclasses.asdict(jconfigs.RandlaSemantic3DConfig()).items())
    with pytest.raises(ValueError, match="unknown randla dataset"):
        randla.randla_dataset_preset("scannet")


@pytest.mark.parametrize("num_classes,ignored", [(19, (0,)), (8, (0,)), (13, ()), (5, (2, 4))])
def test_label_reduce_lut_equals_jax_package(num_classes, ignored):
    got = randla.label_reduce_lut(num_classes, ignored)
    want = jrandla.label_reduce_lut(num_classes, ignored)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dataset", DATASETS)
def test_preset_reduce_equals_jax_reduction(dataset):
    """``preset.reduce`` gives the JAX drivers' valid mask and reduced
    labels (``~isin(raw, ignored)``, ``label_reduce_lut[raw]``), on numpy
    arrays and on torch tensors through the same table."""
    ours = randla.randla_dataset_preset(dataset)
    theirs = jrandla.randla_dataset_preset(dataset)
    raw = np.random.default_rng(4).integers(0, ours.num_classes + len(ours.ignored_labels),
                                            (3, 200))
    valid, reduced = ours.reduce(raw)
    want_valid = ~np.isin(raw, list(theirs.ignored_labels))
    lut = jrandla.label_reduce_lut(theirs.num_classes, theirs.ignored_labels)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(reduced[valid], lut[raw[want_valid]])
    assert not reduced[~valid].any() and reduced.dtype == np.int64
    tvalid, treduced = randla.reduce_labels(torch.from_numpy(ours.label_table()),
                                            torch.from_numpy(raw))
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    np.testing.assert_array_equal(treduced.numpy(), reduced)


# --- the loaders ---------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """SemanticKITTI and Semantic3D trees prepared by the port's cli.prepare."""
    root = tmp_path_factory.mktemp("presets")
    seq, yaml_path = synth.write_raw_semantickitti(str(root / "kitti"), points=3000, seed=1)
    synth.write_raw_semantic3d(str(root / "sem3d"), points=6000, extent=6.0, seed=2)
    prepare.main(["--dataset", "semantickitti", "--raw_root", seq, "--out_root",
                  str(root / "kitti_prep"), "--kitti_yaml", yaml_path])
    prepare.main(["--dataset", "semantic3d", "--raw_root", str(root / "sem3d"),
                  "--out_root", str(root / "sem3d_prep")])
    return {"semantickitti": str(root / "kitti_prep"),
            "semantic3d": str(root / "sem3d_prep" / "input_0.060")}


@pytest.mark.parametrize("dataset,split,names", [
    ("semantickitti", "train", ["00_000000", "00_000001"]),
    ("semantickitti", "test", ["08_000000"]),
    ("semantickitti", "test_scans", ["11_000000"]),
    ("semantic3d", "train", ["untermaederbrunnen_station1_xyz_intensity_rgb"]),
    ("semantic3d", "test", ["bildstein_station3_xyz_intensity_rgb"]),
])
def test_loaders_and_sampler_draws_equal_jax_package(trees, dataset, split, names):
    """The same clouds in the same order, and the same batches over three
    draws of 2 × 1024 points (the xyz-only SemanticKITTI features are
    [B, P, 3])."""
    ours = randla.randla_dataset_preset(dataset).make_sampler(
        trees[dataset], split, 1024, np.random.default_rng(3))
    theirs = jrandla.randla_dataset_preset(dataset).make_sampler(
        trees[dataset], split, 1024, np.random.default_rng(3))
    assert [c.name for c in ours.clouds] == [c.name for c in theirs.clouds] == names
    for a, b in zip(ours.clouds, theirs.clouds):
        np.testing.assert_array_equal(a.xyz, b.xyz)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert (a.colors is None) == (b.colors is None) == (dataset == "semantickitti")
        if a.colors is not None:
            np.testing.assert_array_equal(a.colors, b.colors)
    width = 3 if dataset == "semantickitti" else 6
    for got, want in zip(ours.batches(2, 3), theirs.batches(2, 3)):
        assert got[1].shape == (2, 1024, width)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# --- the ignored-label loss ------------------------------------------------------


def _loss_case(seed, all_ignored=False):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((2, 300, 8))).astype(np.float32)
    labels = rng.integers(1, 9, (2, 300))
    labels[rng.random((2, 300)) < 1 / 3] = 0
    if all_ignored:
        labels[:] = 0
    return logits, labels, get_class_weights("Semantic3D")


def _both(logits, labels, w):
    def jloss(x):
        return jax_loss(x, jnp.asarray(labels), jnp.asarray(w), ignored_labels=(0,))

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    table = torch.from_numpy(randla.randla_dataset_preset("semantic3d").label_table())
    got = weighted_softmax_ce_loss(x, torch.from_numpy(labels), torch.from_numpy(w),
                                   label_table=table)
    got.backward()
    return got.item(), float(want), x.grad.numpy(), np.asarray(jgrad)


def test_ignored_label_loss_and_gradient_equal_jax_package():
    logits, labels, w = _loss_case(0)
    assert 0.25 < (labels == 0).mean() < 0.4
    got, want, grad, jgrad = _both(logits, labels, w)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-8)
    assert not grad[labels == 0].any()  # ignored points contribute nothing
    # the masked mean over the valid points, with reduced labels 0..7
    valid = labels.reshape(-1) > 0
    lp = torch.log_softmax(torch.from_numpy(logits).reshape(-1, 8).double(), -1).numpy()
    y = labels.reshape(-1)[valid] - 1
    ref = np.mean(-lp[valid, y] * w[y])
    assert got == pytest.approx(ref, rel=1e-6)


def test_ignored_label_loss_of_only_ignored_points_is_zero():
    got, want, grad, jgrad = _both(*_loss_case(1, all_ignored=True))
    assert got == want == 0.0 and not grad.any() and not jgrad.any()


# --- the models at full width on JAX-initialised weights ---------------------------


@pytest.mark.parametrize("dataset,points", [("semantickitti", 1024), ("semantic3d", 2048)])
def test_full_width_preset_model_logits_equal_jax_model(dataset, points):
    """The 4-layer 3-channel SemanticKITTI model and the 5-layer 8-class
    Semantic3D model: the JAX model's initial weights through
    ``randla_from_jax_variables`` give its logits to 1e-4, and map back
    leaf for leaf."""
    preset = randla.randla_dataset_preset(dataset)
    cfg = preset.cfg
    d_in = 6 if preset.has_colors else 3
    rng = np.random.default_rng(8)
    xyz = (rng.random((1, points, 3)) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.random((1, points, d_in - 3)).astype(np.float32)], -1)
    pyr = jax.jit(lambda x: jax_build_pyramid(
        x, num_layers=cfg.num_layers, k=cfg.k_n, sub_ratios=cfg.sub_sampling_ratio,
        knn_tile=None))(jnp.asarray(xyz))
    jmodel = JaxRandLANet(num_classes=preset.num_classes, d_out=cfg.d_out)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(7), jnp.asarray(feats), pyr)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(feats), pyr))
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables, sep="/").items()}
    model = RandLANet(num_classes=preset.num_classes, d_out=cfg.d_out, d_in=d_in)
    sd = randla_from_jax_variables(flat)
    model.load_state_dict(sd)
    assert model.fc0.in_features == d_in and len(model.blocks) == cfg.num_layers
    back = randla_to_jax_variables(sd)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    tpyr = build_pyramid(torch.from_numpy(xyz), num_layers=cfg.num_layers, k=cfg.k_n,
                         sub_ratios=cfg.sub_sampling_ratio)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(feats), tpyr).numpy()
    assert got.shape == want.shape == (1, points, preset.num_classes)
    np.testing.assert_allclose(got, want, atol=1e-4)
