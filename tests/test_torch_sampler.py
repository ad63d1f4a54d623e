"""The port's host input pipeline against the JAX package's, on the CPU:
the block sampler, the z-rotation and the epoch loop's batches array-equal
from the same seed; ``prefetch``'s order, RNG discipline and exception
pass-through; the exact optimizer-step count of an epoch.
"""

import json
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.data import augment as jax_augment
from pointsecguard_tpu.data import s3dis as jax_s3dis
from pointsecguard_tpu_torch.data import augment, s3dis
from pointsecguard_tpu_torch.data.loader import make_batch_put, prefetch, wait_batch
from pointsecguard_tpu_torch.data.synthetic import make_synthetic_rooms


@pytest.fixture(scope="module")
def rooms_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rooms")
    # two train rooms of different sizes and one test room
    make_synthetic_rooms(str(root), points_per_room=(3000, 9000), seed=2,
                         train_areas=(1, 2))
    return str(root)


def _samplers(rooms_dir, **kw):
    ours = s3dis.S3DISBlockSampler(s3dis.RoomSet.load(rooms_dir, "train", 5), **kw)
    theirs = jax_s3dis.S3DISBlockSampler(jax_s3dis.RoomSet.load(rooms_dir, "train", 5), **kw)
    return ours, theirs


@pytest.mark.parametrize("batch_size,keep_tail", [(8, True), (8, False), (5, True), (64, True)])
def test_sampler_batches_equal_jax(rooms_dir, batch_size, keep_tail):
    ours, theirs = _samplers(rooms_dir, num_point=128, min_points=64)
    assert len(ours) == len(theirs) > 0
    np.testing.assert_array_equal(ours.room_idxs, theirs.room_idxs)
    got = list(ours.batches(np.random.default_rng(3), batch_size, keep_tail=keep_tail))
    want = list(theirs.batches(np.random.default_rng(3), batch_size, keep_tail=keep_tail))
    # the wrap-around tail fixes the step count of an epoch
    steps = -(-len(ours) // batch_size) if keep_tail else len(ours) // batch_size
    assert len(got) == len(want) == steps
    for (gp, gl), (wp, wl) in zip(got, want):
        assert gp.shape == (batch_size, 128, 9) and gp.dtype == wp.dtype == np.float32
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)


def test_sampler_sparse_room_falls_back_to_the_densest_block(rooms_dir):
    # min_points above any block's count: max_tries draws, then the best one
    ours, theirs = _samplers(rooms_dir, num_point=256, min_points=10**6, max_tries=3)
    g = ours.sample(np.random.default_rng(0), 1)
    w = theirs.sample(np.random.default_rng(0), 1)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("cell", [0.5, 0.3])
def test_block_index_equals_brute_force_and_jax(cell):
    rng = np.random.default_rng(5)
    xy = np.round(rng.random((4000, 2)) * 4.0, 2)  # many points on cell borders
    ours, theirs = s3dis._BlockIndex(xy, cell), jax_s3dis._BlockIndex(xy, cell)
    for _ in range(50):
        centre = xy[rng.integers(len(xy))]
        lo, hi = centre - 0.5, centre + 0.5
        brute = np.where((xy[:, 0] >= lo[0]) & (xy[:, 0] <= hi[0])
                         & (xy[:, 1] >= lo[1]) & (xy[:, 1] <= hi[1]))[0]
        np.testing.assert_array_equal(ours.query(lo, hi), brute)
        np.testing.assert_array_equal(theirs.query(lo, hi), brute)
    assert ours.query(np.array([9.0, 9.0]), np.array([9.5, 9.5])).size == 0


def test_nine_channel_equals_jax():
    rng = np.random.default_rng(6)
    sel = rng.random((50, 6)) * [4, 4, 3, 255, 255, 255]
    args = (sel, np.array([1.5, 2.5]), np.array([4.0, 4.0, 3.0]))
    got, want = s3dis._nine_channel(*args), jax_s3dis._nine_channel(*args)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_rotate_point_cloud_z_equals_jax():
    batch = np.random.default_rng(7).random((6, 40, 3)).astype(np.float32)
    got = augment.rotate_point_cloud_z(batch, np.random.default_rng(8))
    want = jax_augment.rotate_point_cloud_z(batch, np.random.default_rng(8))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 2], batch[..., 2])  # z stays
    np.testing.assert_allclose(np.linalg.norm(got[..., :2], axis=-1),
                               np.linalg.norm(batch[..., :2], axis=-1), rtol=1e-5)


# --- prefetch ----------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_prefetch_keeps_order_and_the_rng_sequence(depth):
    def source(rng):
        for i in range(20):
            yield i, rng.integers(1 << 30)

    sequential = [(i, r, r + 1) for i, r in source(np.random.default_rng(1))]
    threads = set()

    def transform(item):
        threads.add(threading.current_thread().name)
        return (*item, item[1] + 1)

    got = list(prefetch(source(np.random.default_rng(1)), transform, depth=depth))
    assert got == sequential
    # source and transform both run on the worker thread (inline at depth 0)
    assert threads == ({"psg-prefetch"} if depth > 0 else {threading.current_thread().name})


@pytest.mark.parametrize("where", ["source", "transform"])
@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_reraises_a_worker_failure_in_the_consumer(where, depth):
    """A failed worker must not look like the end of the epoch: the staged
    items come out, then the exception, also when the consumer is slower
    than the worker and the queue is full."""
    def source():
        for i in range(10):
            if where == "source" and i == 4:
                raise KeyError("sampler failed")
            yield i

    def transform(i):
        if where == "transform" and i == 4:
            raise KeyError("copy failed")
        return i

    seen = []
    with pytest.raises(KeyError, match="failed"):
        for item in prefetch(source(), transform, depth=depth):
            seen.append(item)
            time.sleep(0.02)
    assert seen == [0, 1, 2, 3]


def test_prefetch_stops_its_worker_when_the_consumer_leaves():
    before = {t for t in threading.enumerate() if t.name == "psg-prefetch"}
    gen = prefetch(iter(range(10**9)), depth=2)
    assert next(gen) == 0 and next(gen) == 1
    gen.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = {t for t in threading.enumerate()
                 if t.name == "psg-prefetch" and t.is_alive()} - before
        if not alive:
            break
        time.sleep(0.05)
    assert not alive


def test_batch_put_on_the_cpu_hands_tensors_through():
    put = make_batch_put(torch.device("cpu"))
    pts = np.random.default_rng(0).random((2, 8, 9))  # float64 from a sampler
    labels = np.arange(16, dtype=np.int32).reshape(2, 8)
    t_pts, t_labels = wait_batch(put((pts, labels)))
    assert t_pts.dtype == torch.float32 and t_labels.dtype == torch.int64
    np.testing.assert_array_equal(t_pts.numpy(), pts.astype(np.float32))
    np.testing.assert_array_equal(t_labels.numpy(), labels)


# --- the epoch loop's batches and step count against the JAX loop's ----------

def _args(data, log, **kw):
    base = dict(data_root=data, log_dir=log, test_area=5, model="pointnet2",
                npoint=128, batch_size=8, learning_rate=1e-3, epochs=2,
                eval_every=99, seed=4, prefetch=2, min_block_points=1024)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.fixture(scope="module")
def loop_batches(tmp_path_factory):
    """Both epoch loops on the same rooms and seed with the train step
    and the evaluator replaced by recorders: what each loop feeds its
    step, and its ``events.jsonl``."""
    import pointsecguard_tpu.train as jax_train
    from pointsecguard_tpu.train.loops import train_pointnet_family as jax_loop
    from pointsecguard_tpu_torch.train import evaluator, trainer
    from pointsecguard_tpu_torch.train.loops import train_pointnet_family

    root = tmp_path_factory.mktemp("loops")
    data = str(root / "data")
    # 6000 points, npoint 128, batch 8: len(sampler) = 46, 6 steps an
    # epoch, the last one wrapped around (46 % 8 = 6)
    make_synthetic_rooms(data, points_per_room=6000, seed=0)
    nothing = types.SimpleNamespace(miou=0.25, accuracy=0.5)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        fed = []

        def jax_recorder(model, tx, loss_fn, **kw):
            def step(state, pts_k, lab_k, weights, lr, bn_m, keys):
                fed.append((np.asarray(pts_k)[0], np.asarray(lab_k)[0]))
                return state, jnp.zeros((pts_k.shape[0],)), None
            return step

        mp.setattr(jax_train, "make_multi_train_step", jax_recorder)
        mp.setattr(jax_train, "evaluate_whole_scenes", lambda *a, **k: (nothing, []))
        jax_loop(_args(data, str(root / "jax"), steps_per_call=1, devices=1,
                       profile=None, precision="float32", device_sampler=False))
        out["jax"] = fed

        fed = []

        def recorder(model, loss_fn, **kw):
            def step(state, pts, labels, weights, lr, bn_m, generator=None):
                fed.append((pts.numpy().copy(), labels.numpy().copy()))
                return torch.zeros(())
            return step

        mp.setattr(trainer, "make_train_step", recorder)
        mp.setattr(evaluator, "evaluate_whole_scenes", lambda *a, **k: (nothing, []))
        train_pointnet_family(_args(data, str(root / "port")), torch.device("cpu"))
        out["port"] = fed
    finally:
        mp.undo()
    for side in ("jax", "port"):
        with open(root / side / "events.jsonl") as f:
            out[side + "_events"] = [json.loads(line) for line in f]
    return out


def test_loop_feeds_the_batches_of_the_jax_loop(loop_batches):
    """Array-equal augmented batches over two epochs: the draw spent on
    shaping the state, the sampler, the rotation and their order on the
    worker thread are the JAX loop's."""
    got, want = loop_batches["port"], loop_batches["jax"]
    assert len(got) == len(want) == 12
    for (gp, gl), (wp, wl) in zip(got, want):
        assert gp.shape == (8, 128, 9) and gp.dtype == np.float32
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)
    assert not np.array_equal(got[0][0], got[6][0])  # the second epoch draws on


def test_epoch_takes_exactly_the_jax_loops_optimizer_steps(loop_batches):
    def epochs(events):
        return [e for e in events if e["event"] == "epoch"]

    ours, theirs = epochs(loop_batches["port_events"]), epochs(loop_batches["jax_events"])
    assert [e["batches"] for e in ours] == [e["batches"] for e in theirs] == [6, 6]
    assert [e["epoch"] for e in ours] == [0, 1]
    for o, t in zip(ours, theirs):  # the same fields, the same schedule
        assert set(o) == set(t)
        assert o["lr"] == t["lr"] and o["bn_momentum"] == t["bn_momentum"]
        assert o["nan_batches"] == t["nan_batches"] == 0
    evals = [e for e in loop_batches["port_events"] if e["event"] == "eval"]
    assert [set(e) for e in evals] == [
        set(e) for e in loop_batches["jax_events"] if e["event"] == "eval"]
    assert [e["epoch"] for e in evals] == [1]  # the last epoch always evaluates
