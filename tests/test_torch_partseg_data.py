"""The port's ShapeNetPart host code against the JAX package, on the CPU:
the copy of ``data/shapenet_part.py`` (synthetic writer, splits, the
``class_choice`` filter, the parse cache, loads with and without a
generator, batches) array-equal from the same generator state, and
``shape_part_ious`` / ``evaluate_partseg`` equal to JAX's on random and
oracle predictions and on a padded tail."""

import filecmp
import os

import numpy as np
import pytest

from pointsecguard_tpu.data import shapenet_part as jshapenet
from pointsecguard_tpu.train import object_eval as jobject_eval
from pointsecguard_tpu_torch.data import shapenet_part
from pointsecguard_tpu_torch.train import object_eval


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The 3-category synthetic ShapeNetPart written by each package."""
    out = {}
    for name, mod in (("jax", jshapenet), ("port", shapenet_part)):
        root = str(tmp_path_factory.mktemp(name))
        mod.make_synthetic_shapenetpart(root, points_per_shape=150, train_per_class=3,
                                        val_per_class=1, test_per_class=2, seed=5)
        out[name] = root
    return out


def test_tables_equal():
    assert shapenet_part.SEG_CLASSES == jshapenet.SEG_CLASSES
    assert shapenet_part.CATEGORY_INDEX == jshapenet.CATEGORY_INDEX
    assert (shapenet_part.NUM_PART_CLASSES, shapenet_part.NUM_OBJECT_CLASSES) == (
        jshapenet.NUM_PART_CLASSES, jshapenet.NUM_OBJECT_CLASSES) == (50, 16)


def test_synthetic_files_equal(roots):
    names = sorted(os.path.relpath(os.path.join(d, f), roots["jax"])
                   for d, _, fs in os.walk(roots["jax"]) for f in fs)
    assert len(names) == 3 * 6 + 1 + 3
    for rel in names:
        assert filecmp.cmp(os.path.join(roots["jax"], rel),
                           os.path.join(roots["port"], rel), shallow=False), rel


def _pair(roots, split, **kw):
    return (jshapenet.ShapeNetPartDataset(roots["jax"], split, **kw),
            shapenet_part.ShapeNetPartDataset(roots["jax"], split, **kw))


@pytest.mark.parametrize("split,kw", [
    ("trainval", {"num_point": 200}),
    ("test", {"num_point": 64, "use_normals": False}),
    ("train", {"num_point": 100, "class_choice": ["Knife", "Table"]}),
    ("val", {"num_point": 150, "cache": False}),
], ids=["trainval", "test-xyz", "class_choice", "val-nocache"])
def test_dataset_loads_equal(roots, split, kw):
    """Paths, categories, one-hot ids and every load, deterministic and
    from a generator (twice each: the cache must hand back the same rows)."""
    want, got = _pair(roots, split, **kw)
    assert got.paths == want.paths and got.categories == want.categories
    np.testing.assert_array_equal(got.cls_labels, want.cls_labels)
    assert got.cls_labels.dtype == np.int32
    for _ in range(2):
        rj, rp = np.random.default_rng(3), np.random.default_rng(3)
        for i in range(len(got)):
            for a, b in ((want.load(i), got.load(i)), (want.load(i, rj), got.load(i, rp))):
                np.testing.assert_array_equal(b[0], a[0])
                assert b[1] == a[1]
                np.testing.assert_array_equal(b[2], a[2])
                assert b[0].dtype == np.float32 and b[2].dtype == np.int32
    assert got.load(0)[0].shape == (kw["num_point"], 3 if kw.get("use_normals") is False else 6)


@pytest.mark.parametrize("flags", [
    {}, {"shuffle": False, "drop_last": False}, {"resample": False, "drop_last": False}],
    ids=["default", "tail", "no-resample"])
def test_batches_equal(roots, flags):
    """Every batch of an epoch, the generator read the same way; the tail
    tiled to the batch size (batch 10 > the 2 × 9 / 2 split's shapes)."""
    want, got = _pair(roots, "trainval", num_point=80)
    rj, rp = np.random.default_rng(7), np.random.default_rng(7)
    for bs in (4, 10):
        a = list(want.batches(rj, bs, **flags))
        b = list(got.batches(rp, bs, **flags))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(v, u)
                assert v.dtype == u.dtype
    assert rj.random() == rp.random()


def test_bad_split_refused(roots):
    with pytest.raises(ValueError, match="bad split"):
        shapenet_part.ShapeNetPartDataset(roots["port"], "all")


def _random_logp(rng, b, n):
    x = rng.normal(size=(b, n, 50)).astype(np.float32)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("cat", ["Knife", "Earphone", "Table", "Motorbike"])
def test_shape_part_ious_equal(cat):
    """Random predictions, and labels that leave a part out (a part absent
    from both scores 1)."""
    rng = np.random.default_rng(1)
    parts = shapenet_part.SEG_CLASSES[cat]
    logp = _random_logp(rng, 1, 90)[0]
    for seg in (rng.choice(parts, 90), np.full(90, parts[0])):
        seg = seg.astype(np.int32)
        got = object_eval.shape_part_ious(logp, seg, cat)
        assert got == jobject_eval.shape_part_ious(logp, seg, cat)
        assert len(got) == len(parts)
    # an oracle: the logits of another category's parts are never read
    lp = np.full((90, 50), -5.0, np.float32)
    lp[np.arange(90), seg] = 0.0
    lp[:, next(p for p in range(50) if p not in parts)] = 10.0
    assert object_eval.shape_part_ious(lp, seg, cat) == [1.0] * len(parts)


@pytest.mark.parametrize("batch_size", [2, 4, 5])
def test_evaluate_partseg_equal(roots, batch_size):
    """The same metrics as JAX's from a predictor that answers from the
    points it is given (so each shape's rows must reach it), on the test
    split's 6 shapes, tails padded."""
    ds_j, ds_p = _pair(roots, "test", num_point=70)
    w = np.random.default_rng(2).normal(size=(6 + 16, 50)).astype(np.float32)

    def predict(pts, onehot):
        x = np.concatenate([pts, np.broadcast_to(onehot[:, None], (*pts.shape[:2], 16))], -1)
        h = x @ w
        return h - np.log(np.exp(h).sum(-1, keepdims=True))

    got = object_eval.evaluate_partseg(predict, ds_p, batch_size=batch_size)
    want = jobject_eval.evaluate_partseg(predict, ds_j, batch_size=batch_size)
    assert got == want
    assert set(got["category_miou"]) == {"Knife", "Earphone", "Table"}


def test_evaluate_partseg_oracle(roots):
    """Predictions equal to the labels score 1 everywhere."""
    ds = shapenet_part.ShapeNetPartDataset(roots["port"], "test", num_point=70)
    truth = {}

    def predict(pts, onehot):
        out = np.full((*pts.shape[:2], 50), -9.0, np.float32)
        for b in range(len(pts)):
            seg = truth[pts[b].tobytes()]
            out[b, np.arange(len(seg)), seg] = 0.0
        return out

    for i in range(len(ds)):
        p, _, s = ds.load(i)
        truth[p.tobytes()] = s
    m = object_eval.evaluate_partseg(predict, ds, batch_size=4)
    assert m["instance_miou"] == m["class_avg_miou"] == m["accuracy"] == 1.0
