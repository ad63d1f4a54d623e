"""The port's ModelNet host code and coordinate defenses against the JAX
package, on the CPU: the copy of ``data/modelnet.py`` (synthetic fixture,
loads, votes' random subsets, batches) and the classification
augmentations array-equal from the same generator state;
``evaluate_cls`` on an oracle and on a padded tail, equal to JAX's; SOR
and SRS (JAX's permutation read back through an index channel) with
exactly JAX's donors."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.attacks import defenses as jdefenses
from pointsecguard_tpu.data import augment as jaugment
from pointsecguard_tpu.data import modelnet as jmodelnet
from pointsecguard_tpu.train.object_eval import evaluate_cls as jax_evaluate_cls
from pointsecguard_tpu_torch.attacks import (
    simple_random_subsample,
    srs_donors,
    statistical_outlier_removal,
)
from pointsecguard_tpu_torch.data import augment, modelnet
from pointsecguard_tpu_torch.train.object_eval import evaluate_cls


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The 4-class synthetic ModelNet written by each package."""
    out = {}
    for name, mod in (("jax", jmodelnet), ("port", modelnet)):
        root = str(tmp_path_factory.mktemp(name))
        mod.make_synthetic_modelnet(root, points_per_shape=256, seed=3)
        out[name] = root
    return out


def test_synthetic_modelnet_files_equal(roots):
    names = sorted(os.path.relpath(os.path.join(d, f), roots["jax"])
                   for d, _, fs in os.walk(roots["jax"]) for f in fs)
    assert len(names) == 4 * 10 + 3
    for rel in names:
        assert filecmp.cmp(os.path.join(roots["jax"], rel),
                           os.path.join(roots["port"], rel), shallow=False), rel


@pytest.mark.parametrize("normals", [True, False])
@pytest.mark.parametrize("split,num_point", [("train", 128), ("test", 256), ("test", 300)])
def test_modelnet_loads_and_batches_equal(roots, split, num_point, normals):
    """First-N loads, random-subset loads (votes), tile padding past the
    file's 256 rows, ``pc_normalize`` and shuffled batches, array-equal
    from the same generator state."""
    kw = dict(num_point=num_point, num_category=40, use_normals=normals)
    want = jmodelnet.ModelNetDataset(roots["port"], split, **kw)
    got = modelnet.ModelNetDataset(roots["port"], split, **kw)
    assert got.class_names == want.class_names and got.num_classes == 4
    np.testing.assert_array_equal(got.labels, want.labels)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(len(want)):
        for rng_w, rng_g in ((None, None), (r1, r2)):
            (pw, lw), (pg, lg) = want.load(i, rng_w), got.load(i, rng_g)
            np.testing.assert_array_equal(pg, pw)
            assert lg == lw
    bw = list(want.batches(np.random.default_rng(7), 3, drop_last=False))
    bg = list(got.batches(np.random.default_rng(7), 3, drop_last=False))
    assert len(bw) == len(bg)
    for (pw, lw), (pg, lg) in zip(bw, bg):
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_array_equal(lg, lw)


@pytest.mark.parametrize("name", ["random_point_dropout", "random_scale_point_cloud",
                                  "shift_point_cloud"])
def test_augmentations_equal(name):
    batch = np.random.default_rng(0).normal(size=(5, 64, 3)).astype(np.float32)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    want = getattr(jaugment, name)(batch, r1)
    got = getattr(augment, name)(batch, r2)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert r1.random() == r2.random()  # the same draws were spent


@pytest.mark.parametrize("num_votes", [1, 3])
@pytest.mark.parametrize("batch_size", [3, 8, 16])
def test_evaluate_cls_matches_jax(roots, batch_size, num_votes):
    """An oracle (the labels, read off each shape's first point) and a
    confused model, with tails of 2, 0 and 8 padded shapes: the same
    accuracies and predictions as JAX's; the oracle scores 1."""
    ds = modelnet.ModelNetDataset(roots["port"], "test", num_point=64)
    key = {tuple(ds.load(i)[0][0, :3].round(4)): int(ds.labels[i]) for i in range(len(ds))}

    def oracle(pts):
        lab = [key.get(tuple(p[0, :3].round(4)), 0) for p in pts]
        return np.log(np.eye(4)[lab] * 0.97 + 0.01)

    def confused(pts):
        return np.log(np.full((len(pts), 4), 0.1) + np.eye(4)[
            (np.abs(pts[:, :, 0]).sum(1) * 10).astype(int) % 4])

    for fn, perfect in ((oracle, True), (confused, False)):
        want = jax_evaluate_cls(fn, ds, batch_size=batch_size, num_votes=num_votes,
                                rng=np.random.default_rng(2))
        got = evaluate_cls(fn, ds, batch_size=batch_size, num_votes=num_votes,
                           rng=np.random.default_rng(2))
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        if perfect and num_votes == 1:
            assert got[:2] == (1.0, 1.0)


def _cloud(seed, b=3, n=256):
    """xyz with a few far outliers and exact duplicates (distance-0 ties),
    then a 4th channel holding the point's index, so that a defense's
    output names its donors."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 0.3, (b, n, 3))
    xyz[:, :5] *= 6.0  # outliers
    xyz[:, 10:20] = xyz[:, 30:40]  # duplicates
    idx = np.broadcast_to(np.arange(n, dtype=np.float64), (b, n))[..., None]
    return np.concatenate([xyz, idx], -1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k,alpha", [(10, 1.1), (4, 0.5), (60, 1.1)])
def test_sor_donors_equal_jax(k, alpha, dtype):
    """The same donors (k + 1 = 61 takes the sort route), so the same rows;
    some points replaced, the outliers among them."""
    pts = _cloud(1).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jdefenses.statistical_outlier_removal(jnp.asarray(pts), k, alpha))
    got = statistical_outlier_removal(torch.from_numpy(pts), k, alpha).numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_array_equal(got, want)
    moved = got[..., 3] != np.arange(pts.shape[1])
    assert moved.any() and moved[:, :5].any()


def test_srs_with_jax_draw_equals_jax():
    """SRS on JAX's draw (its donors read back through the index channel)
    gives JAX's output; the port's own draws keep round(0.875·N) points,
    each slot filled from a kept one."""
    pts = _cloud(2)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jdefenses.simple_random_subsample(jnp.asarray(pts, jnp.float32), key))
    donor = torch.from_numpy(want[..., 3].astype(np.int64))
    got = simple_random_subsample(torch.from_numpy(pts.astype(np.float32)), donor=donor)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = srs_donors(pts.shape, 0.875, torch.Generator().manual_seed(0))
    for row in drawn:
        kept = row == torch.arange(len(row))
        assert int(kept.sum()) == round(0.875 * len(row))
        assert kept[row].all()
