"""The port's whole-scene voting evaluation and ``cli.eval`` against the
JAX package's, on the CPU; and the trained fixture's ``.npz`` (the form
that a machine without flax can read) against the flax msgpack.

    python tests/test_torch_eval.py --write-fixture

writes ``tests/fixtures/trained_pointnet2.npz`` from the msgpack anew.
"""

import os
import re
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu.data import s3dis as jax_s3dis
from pointsecguard_tpu.train.evaluator import evaluate_whole_scenes as jax_evaluate
from pointsecguard_tpu.utils.metrics import confusion_matrix as jax_confusion_matrix
from pointsecguard_tpu_torch.data import RoomSet, make_synthetic_rooms
from pointsecguard_tpu_torch.train.evaluator import evaluate_whole_scenes
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import from_jax_variables
from pointsecguard_tpu_torch.utils.metrics import confusion_matrix

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
MSGPACK = os.path.join(FIXDIR, "trained_pointnet2.msgpack")
NPZ = os.path.join(FIXDIR, "trained_pointnet2.npz")


def msgpack_leaves() -> dict:
    """The committed flax fixture as flat leaves keyed by "/"-joined paths."""
    with open(MSGPACK, "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    return {k: np.asarray(v) for k, v in flatten_dict(raw, sep="/").items()}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_fixture_npz_equals_the_msgpack_leaf_for_leaf():
    want = msgpack_leaves()
    with np.load(NPZ) as got:
        assert set(got.files) == set(want) and len(want) == 134
        for path, leaf in want.items():
            assert got[path].dtype == leaf.dtype == np.float32
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
        from_jax_variables({k: got[k] for k in got.files})  # fills the port model


@pytest.mark.parametrize("with_valid", [False, True])
def test_confusion_matrix_matches_jax(with_valid):
    rng = np.random.default_rng(0)
    labels, preds = rng.integers(0, 13, (2, 4, 500))
    valid = rng.random((4, 500)) < 0.7 if with_valid else None
    want = np.asarray(jax_confusion_matrix(
        jnp.asarray(labels), jnp.asarray(preds), 13,
        valid=None if valid is None else jnp.asarray(valid)))
    got = confusion_matrix(labels, preds, 13, valid=valid)
    assert got.dtype == want.dtype == np.float32 and got.shape == (13, 13)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (valid.sum() if with_valid else labels.size)


# --- evaluate_whole_scenes with a stub predictor ------------------------------

@pytest.fixture(scope="module")
def rooms_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rooms")
    make_synthetic_rooms(str(root), points_per_room=(2500, 5000), seed=1,
                         rooms_per_area=2)
    return str(root)


def _stub(seen):
    """A predictor that depends on every channel of a block, and records
    what it was given."""
    def predict(chunk):
        seen.append(np.array(chunk))
        return (np.floor(chunk.sum(-1) * 7.0).astype(np.int64) % 13).astype(np.int32)
    return predict


@pytest.mark.parametrize("batch_size,num_votes", [(8, 1), (5, 2), (64, 1)])
def test_evaluate_whole_scenes_equals_jax(rooms_dir, batch_size, num_votes):
    """The same chunks go to the predictor (so the confusion matrices are
    identical), among them the zero-padded last chunk of every room, and
    the same metrics come out."""
    ours, theirs = [], []
    got_total, got_rooms = evaluate_whole_scenes(
        _stub(ours), RoomSet.load(rooms_dir, "test", 5), batch_size=batch_size,
        num_votes=num_votes, block_points=128, rng=np.random.default_rng(2))
    want_total, want_rooms = jax_evaluate(
        _stub(theirs), jax_s3dis.RoomSet.load(rooms_dir, "test", 5),
        batch_size=batch_size, num_votes=num_votes, block_points=128,
        rng=np.random.default_rng(2))
    assert len(ours) == len(theirs) > 2 * num_votes
    for g, w in zip(ours, theirs):
        assert g.shape == (batch_size, 128, 9) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    padded = [c for c in ours if not c[-1].any()]
    assert len(padded) >= 1  # all-zero blocks fill a room's last chunk
    assert len(got_rooms) == len(want_rooms) == 2
    for g, w in zip([got_total, *got_rooms], [want_total, *want_rooms]):
        # the JAX metrics divide in float32, the port's in float64
        assert g.accuracy == pytest.approx(float(w.accuracy), rel=1e-6)
        assert g.miou == pytest.approx(float(w.miou), rel=1e-6)
        np.testing.assert_allclose(g.class_iou, np.asarray(w.class_iou), rtol=1e-6)
        np.testing.assert_array_equal(g.class_seen, np.asarray(w.class_seen))


def test_votes_pool_over_passes(rooms_dir):
    """Two votes are not one vote twice: the second pass draws new blocks."""
    rooms = RoomSet.load(rooms_dir, "test", 5)
    one, two = [], []
    evaluate_whole_scenes(_stub(one), rooms, batch_size=8, num_votes=1,
                          block_points=128, rng=np.random.default_rng(2))
    evaluate_whole_scenes(_stub(two), rooms, batch_size=8, num_votes=2,
                          block_points=128, rng=np.random.default_rng(2))
    assert len(two) == 2 * len(one)
    n_first = len(one) // 2  # the first room's chunks of one pass
    np.testing.assert_array_equal(two[0], one[0])
    assert not np.array_equal(two[n_first], one[0])


def test_visual_dir_is_refused(rooms_dir, tmp_path):
    """``visual_dir`` was refused before the port's visual dumps landed; it
    now writes the JAX evaluator's files on the same predictions: the label
    clouds byte for byte, the viewer with the same numbers at its 4
    decimals (``utils/viz.py`` formats them without numpy's alignment)."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    evaluate_whole_scenes(_stub([]), RoomSet.load(rooms_dir, "test", 5), batch_size=8,
                          block_points=128, rng=np.random.default_rng(2), visual_dir=str(ours))
    jax_evaluate(_stub([]), jax_s3dis.RoomSet.load(rooms_dir, "test", 5), batch_size=8,
                 block_points=128, rng=np.random.default_rng(2), visual_dir=str(theirs))
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and len(names) == 2 * 3  # two rooms
    arrays = re.compile(r"new Float32Array\((\[[^\]]*\])\)")
    for n in names:
        got, want = (ours / n).read_text(), (theirs / n).read_text()
        if n.endswith(".xyzrgb"):
            assert got == want, n
            continue
        assert arrays.sub("[]", got) == arrays.sub("[]", want)
        for a, b in zip(arrays.findall(got), arrays.findall(want), strict=True):
            np.testing.assert_allclose(np.array(a[1:-1].split(","), float),
                                       np.array(b[1:-1].split(","), float), rtol=0, atol=1e-4)


# --- cli.eval on the trained fixture against the JAX CLI ---------------------

@pytest.fixture(scope="module")
def fixture_eval(tmp_path_factory):
    """Both eval CLIs on the trained fixture and the recipe's synthetic
    rooms (6000 points, seed 0), 128-point blocks, batch 8, one vote."""
    from pointsecguard_tpu.cli import eval as jax_cli
    from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
    from pointsecguard_tpu.train import create_train_state
    from pointsecguard_tpu.utils.checkpoint import CheckpointManager
    from pointsecguard_tpu_torch.cli import eval as cli

    root = tmp_path_factory.mktemp("fixture_eval")
    data = str(root / "data")
    make_synthetic_rooms(data, points_per_room=6000, seed=0)
    with np.load(NPZ) as f:
        flat = {k: f[k] for k in f.files}
    # the JAX CLI reads an orbax checkpoint of a whole train state
    state, _ = create_train_state(
        JaxSSG(), (jnp.zeros((8, 128, 9), jnp.float32), None), rng=jax.random.PRNGKey(0))
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"])
    CheckpointManager(str(root / "jax" / "checkpoints")).save(32, state, miou=0.5)
    save_checkpoint(str(root / "port"), from_jax_variables(flat))
    common = ["--model", "pointnet2", "--data_root", data, "--batch_size", "8",
              "--num_votes", "1", "--seed", "3"]
    want = jax_cli.main(common + ["--log_dir", str(root / "jax"), "--num_point", "128"])
    got = cli.main(common + ["--log_dir", str(root / "port"), "--num_point", "128",
                             "--device", "cpu"])
    return got, want


def test_cli_eval_reports_the_jax_clis_accuracy(fixture_eval):
    """The same blocks, votes and weights: the pooled predictions may
    differ at the few points whose two best classes tie within float32
    noise, 1e-3 of the 6000 points at the most."""
    got, want = fixture_eval
    assert got.accuracy == pytest.approx(float(want.accuracy), abs=1e-3)
    assert got.miou == pytest.approx(float(want.miou), abs=1e-3)
    assert got.accuracy > 0.6  # a trained model: well above 1/13


def test_cli_eval_reports_the_jax_clis_class_iou(fixture_eval):
    got, want = fixture_eval
    np.testing.assert_allclose(got.class_iou, np.asarray(want.class_iou), atol=2e-3)
    np.testing.assert_array_equal(got.class_seen, np.asarray(want.class_seen))
    assert got.class_seen.sum() == 7  # the synthetic rooms' classes


def test_padded_batches_cover_every_block_once():
    from pointsecguard_tpu.train.object_eval import _padded_batches as jax_padded
    from pointsecguard_tpu_torch.train.object_eval import _padded_batches

    for n, b in ((10, 4), (8, 4), (3, 8), (1, 1)):
        got, want = list(_padded_batches(n, b)), list(jax_padded(n, b))
        assert len(got) == len(want)
        for (gi, gv), (wi, wv) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert gv == wv and len(gi) == b
        assert sorted(i for idx, v in got for i in idx[:v]) == list(range(n))


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit(__doc__)
    np.savez_compressed(NPZ, **msgpack_leaves())
    print(f"wrote {NPZ} ({os.path.getsize(NPZ) / 1e6:.2f} MB)")
