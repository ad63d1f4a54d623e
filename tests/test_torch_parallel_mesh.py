"""The port's mesh helpers, batch slicing and global-batch draws against
the JAX package's ``parallel/mesh.py``, and the CLIs' refusals around
``--devices`` / ``--shard_points``. Nothing here starts a rank: a
``RankContext`` without groups is enough for the host-side helpers, which
run no collective."""

import re

import jax
import numpy as np
import pytest
import torch

from pointsecguard_tpu.parallel import data_parallel_mesh as jax_data_parallel_mesh
from pointsecguard_tpu.parallel import make_batch_put as jax_make_batch_put
from pointsecguard_tpu.parallel import make_mesh as jax_make_mesh
from pointsecguard_tpu.parallel import make_stacked_batch_put as jax_make_stacked_batch_put
from pointsecguard_tpu.parallel import shard_batch as jax_shard_batch
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.parallel import (
    RankContext,
    data_parallel_mesh,
    is_main,
    knn_points_sharded,
    make_batch_put,
    make_mesh,
    make_stacked_batch_put,
    shard_batch,
    sp_shapes_ok,
)
from pointsecguard_tpu_torch.utils import runtime


def _ctx(rank: int, n: int, points: int = 1) -> RankContext:
    """Rank ``rank`` of an n-rank CPU mesh, without process groups."""
    return RankContext(rank, make_mesh(["cpu"] * n, points_axis=points), torch.device("cpu"))


def _message(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def _shape(msg: str) -> str:
    """A message with its numbers and platform name blanked."""
    return re.sub(r"\((cpu|gpu|tpu)\)", "(…)", re.sub(r"\d+", "#", msg))


# --- the mesh factory: JAX's messages ------------------------------------------

@pytest.mark.parametrize("n,sp", [(1, 2), (None, 4), (4, 3), (6, 4)])
def test_mesh_refusals_are_jax_messages(n, sp):
    assert _message(data_parallel_mesh, n, sp, device="cpu") \
        == _message(jax_data_parallel_mesh, n, sp)


def test_more_cards_than_exist_is_refused_as_in_jax():
    """JAX refuses more devices than ``jax.devices()``; the port more cards
    than ``torch.cuda.device_count()`` (CPU ranks are processes)."""
    jax_msg = _message(jax_data_parallel_mesh, len(jax.devices()) + 1)
    n = torch.cuda.device_count() + 2
    gpu = _message(data_parallel_mesh, n, device="cuda")
    assert _shape(gpu) == _shape(jax_msg)
    assert gpu == f"--devices {n} > {n - 2} available (gpu)"


def test_make_mesh_layout_and_refusal():
    assert _message(make_mesh, ["cpu"] * 6, points_axis=4) \
        == _message(jax_make_mesh, jax.devices()[:6], points_axis=4)
    mesh = data_parallel_mesh(4, 2, device="cpu")
    assert mesh.shape == {"data": 2, "points": 2} and mesh.backend == "gloo"
    assert data_parallel_mesh(1, 1, device="cpu") is None
    # JAX's row-major (data, points) layout: points innermost
    jax_mesh = jax_make_mesh(jax.devices()[:4], points_axis=2)
    for rank in range(4):
        ctx = _ctx(rank, 4, 2)
        dev = jax_mesh.devices[ctx.data_rank, ctx.points_rank]
        assert dev == jax.devices()[rank]
    assert is_main(None) and is_main(_ctx(0, 2)) and not is_main(_ctx(1, 2))
    # distinct cards take NCCL, a shared card or the CPU gloo
    assert make_mesh(["cuda:0", "cuda:1"]).backend == "nccl"
    assert make_mesh(["cuda:0", "cuda:0"]).backend == "gloo"


# --- batch slicing -------------------------------------------------------------

def test_put_refusals_are_jax_messages():
    jax_mesh = jax_make_mesh(jax.devices()[:4], points_axis=2)
    ctx = _ctx(0, 4, 2)
    put = make_batch_put(ctx, batch_size=2, shard_points=True)
    jput = jax_make_batch_put(jax_mesh, batch_size=2, shard_points=True)
    bad = np.zeros((2, 63, 6), np.float32)
    assert _message(put, bad) == _message(jput, bad)
    sput = make_stacked_batch_put(ctx, batch_size=2, shard_points=True)
    jsput = jax_make_stacked_batch_put(jax_mesh, batch_size=2, shard_points=True)
    bad = np.zeros((3, 2, 63, 6), np.float32)
    assert _message(sput, bad) == _message(jsput, bad)
    mesh8 = jax_make_mesh(jax.devices()[:8], points_axis=2)  # data = 4
    assert _message(make_batch_put, _ctx(0, 8, 2), batch_size=6, shard_points=True) \
        == _message(jax_make_batch_put, mesh8, batch_size=6, shard_points=True)
    assert _message(make_stacked_batch_put, _ctx(0, 8, 2), batch_size=6) \
        == _message(jax_make_stacked_batch_put, mesh8, batch_size=6)


@pytest.mark.parametrize("n,points", [(2, 1), (4, 2), (4, 4)])
def test_rank_parts_tile_the_batch_as_jax_shards_it(n, points):
    """Every rank's part is JAX's shard of the same device: rows over the
    data axis, the points axis over the points axis; 1-D leaves (class
    weights, cloud indices) whole on every rank."""
    rng = np.random.default_rng(0)
    x = rng.random((4, 16, 9), dtype=np.float32)
    stack = rng.random((3, 4, 16, 9), dtype=np.float32)
    weights = np.arange(13.0)
    jax_mesh = jax_make_mesh(jax.devices()[:n], points_axis=points)
    jx = jax_make_batch_put(jax_mesh, batch_size=4, shard_points=points > 1)(x)
    jstack = jax_make_stacked_batch_put(jax_mesh, batch_size=4,
                                        shard_points=points > 1)(stack)
    for rank in range(n):
        ctx = _ctx(rank, n, points)
        dev = jax.devices()[rank]
        put = make_batch_put(ctx, batch_size=4, shard_points=points > 1)
        want = [s.data for s in jx.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(put(x), np.asarray(want))
        sput = make_stacked_batch_put(ctx, batch_size=4, shard_points=points > 1)
        want = [s.data for s in jstack.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(sput(stack), np.asarray(want))
        np.testing.assert_array_equal(put(weights), weights)
        on_dev = make_batch_put(ctx, batch_size=4, device=torch.device("cpu"))(x)
        assert isinstance(on_dev, torch.Tensor) and on_dev.is_contiguous()
    assert make_batch_put(None)(x) is x


def test_shard_batch_takes_jax_leaf_rule():
    """JAX's ``shard_batch`` leaf rule: [B, N, ...] leaves sharded, 1-D ones
    (class weights, cloud indices) whole on every device."""
    tree = {"points": np.arange(8 * 64 * 9, dtype=np.float32).reshape(8, 64, 9),
            "class_weights": np.ones(13, np.float32), "cloud_idx": np.arange(8)}
    jax_mesh = jax_make_mesh(jax.devices()[:8], points_axis=2)
    want = jax_shard_batch(jax_mesh, tree, shard_points=True)
    for rank in range(8):
        got = shard_batch(_ctx(rank, 8, 2), tree, shard_points=True)
        shard = [s.data for s in want["points"].addressable_shards
                 if s.device == jax.devices()[rank]][0]
        np.testing.assert_array_equal(got["points"], np.asarray(shard))
        np.testing.assert_array_equal(got["class_weights"], tree["class_weights"])
        np.testing.assert_array_equal(got["cloud_idx"], tree["cloud_idx"])


# --- the draws of the global batch ----------------------------------------------

@pytest.fixture
def data_slice():
    """Set this process's data slice for a test, and restore it after."""
    yield runtime.set_data_slice
    runtime.set_data_slice(0, 1)


def test_batch_draw_keeps_the_ranks_rows_of_the_global_draw(data_slice):
    def draw(shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(3))

    whole = draw((4, 5, 2))
    parts = []
    for rank in range(2):
        data_slice(rank, 2)
        parts.append(runtime.batch_draw(draw, (2, 5, 2)))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole.numpy())


def test_fps_starts_and_dropout_masks_are_the_global_batch_rows(data_slice):
    from pointsecguard_tpu_torch.models.common import dropout
    from pointsecguard_tpu_torch.ops import farthest_point_sample

    xyz = torch.from_numpy(np.random.default_rng(1).random((4, 64, 3), dtype=np.float32))
    x = torch.ones(4, 8, 6)
    fps_whole = farthest_point_sample(xyz, 8, generator=torch.Generator().manual_seed(5))
    drop_whole = dropout(x, 0.5, None, torch.Generator().manual_seed(6))
    for rank in range(2):
        data_slice(rank, 2)
        rows = slice(2 * rank, 2 * rank + 2)
        got = farthest_point_sample(xyz[rows], 8, generator=torch.Generator().manual_seed(5))
        np.testing.assert_array_equal(got.numpy(), fps_whole[rows].numpy())
        got = dropout(x[rows], 0.5, None, torch.Generator().manual_seed(6))
        np.testing.assert_array_equal(got.numpy(), drop_whole[rows].numpy())


def test_device_sampler_ranks_keep_their_rows_of_the_global_draw(data_slice):
    """``--device_sampler --devices 2``: each rank draws the global batch
    from the same generator state and steps on its rows, so the two ranks'
    batches make up the one-process batch."""
    from pointsecguard_tpu_torch.data import RoomSet
    from pointsecguard_tpu_torch.data.device_sampler import (
        make_device_block_sampler,
        make_sampled_multi_train_step,
        stage_rooms,
    )
    from pointsecguard_tpu_torch.data.synthetic import make_room

    rooms_np = [make_room(2000, rng=np.random.default_rng(s)) for s in (0, 1)]
    rooms = RoomSet(["a", "b"], [r[:, :6] for r in rooms_np],
                    [r[:, 6].astype(np.int64) for r in rooms_np],
                    [r[:, :3].min(0) for r in rooms_np], [r[:, :3].max(0) for r in rooms_np])
    staged, num_max = stage_rooms(rooms, torch.device("cpu"))
    sample = make_device_block_sampler(batch_size=4, num_point=64, num_max=num_max,
                                       min_points=16)

    def batches(ctx):
        seen = []

        def step(state, pts, labels, *args):
            seen.append((pts.clone(), labels.clone()))
            return torch.zeros(())

        make_sampled_multi_train_step(step, sample, ctx)(
            None, staged, None, 1e-3, 0.1, 2, torch.Generator().manual_seed(9))
        return seen

    whole = batches(None)
    parts = []
    for rank in range(2):
        data_slice(rank, 2)
        parts.append(batches(_ctx(rank, 2)))
    for k, (pts, labels) in enumerate(whole):
        assert parts[0][k][0].shape[0] == 2
        np.testing.assert_array_equal(
            torch.cat([parts[0][k][0], parts[1][k][0]]).numpy(), pts.numpy())
        np.testing.assert_array_equal(
            torch.cat([parts[0][k][1], parts[1][k][1]]).numpy(), labels.numpy())


# --- the sharded kNN's preconditions -----------------------------------------------

def test_knn_points_sharded_refusals_come_before_any_collective():
    ctx = _ctx(0, 4, 4)
    with pytest.raises(ValueError, match="divide"):
        knn_points_sharded(torch.zeros(1, 30, 3), torch.zeros(1, 64, 3), 4, ctx)
    with pytest.raises(ValueError, match="k="):
        knn_points_sharded(torch.zeros(1, 64, 3), torch.zeros(1, 64, 3), 128, ctx)
    assert sp_shapes_ok(ctx, torch.zeros(1, 64, 3), torch.zeros(1, 16, 3))
    assert not sp_shapes_ok(ctx, torch.zeros(1, 64, 3), torch.zeros(1, 6, 3))
    assert not sp_shapes_ok(None, torch.zeros(1, 64, 3))


# --- the CLIs: what is refused by name ------------------------------------------

_SEMSEG_ONLY = "--shard_points covers the semseg families"


@pytest.mark.parametrize("cli,flags,match", [
    (train_cli, ["--model", "pointnet2_cls", "--devices", "2", "--shard_points", "2"],
     _SEMSEG_ONLY),
    (train_cli, ["--model", "pointnet_part_seg", "--devices", "2", "--shard_points", "2"],
     _SEMSEG_ONLY),
    (eval_cli, ["--model", "pointnet2_cls_msg", "--devices", "2", "--shard_points", "2"],
     _SEMSEG_ONLY),
    (train_cli, ["--device_sampler", "--devices", "2", "--shard_points", "2"],
     "--device_sampler composes with --devices"),
    (attack_cli, ["--model", "randla", "--fused_ap", "--devices", "2", "--shard_points", "2"],
     "not ported yet: --fused_ap with --shard_points 2"),
], ids=["train cls", "train part_seg", "eval cls", "train device_sampler",
        "attack fused_ap"])
def test_refused_by_name(cli, flags, match, tmp_path):
    with pytest.raises(SystemExit, match=re.escape(match)):
        cli.main(["--device", "cpu", "--log_dir", str(tmp_path), *flags])


@pytest.mark.parametrize("cli", [train_cli, eval_cli, attack_cli], ids=["train", "eval", "attack"])
def test_mesh_errors_reach_the_caller(cli, tmp_path):
    """More cards than there are, and --shard_points without --devices:
    the JAX package's ValueErrors, before any rank starts."""
    log = ["--log_dir", str(tmp_path)]
    n = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match=rf"--devices {n} > {n - 2} available \(gpu\)"):
        cli.main([*log, "--devices", str(n)])
    with pytest.raises(ValueError, match="requires --devices >= 2"):
        cli.main(["--device", "cpu", *log, "--shard_points", "2"])


@pytest.mark.parametrize("cli,flags", [
    (train_cli, ["--devices", "2", "--shard_points", "2"]),
    (train_cli, ["--model", "pointnet2_cls", "-d", "4"]),
    (eval_cli, ["--model", "randla", "--devices", "4", "--shard_points", "2"]),
    (attack_cli, ["--model", "randla", "--devices", "2", "--shard_points", "2"]),
    # once refused: tests/test_torch_parallel_benchmark.py runs it
    (attack_cli, ["--log_steps", "--devices", "2"]),
], ids=["train sp", "train cls", "eval randla", "attack randla", "attack log_steps"])
def test_devices_and_shard_points_are_taken(cli, flags):
    args = cli._parser().parse_args(flags)
    cli._refuse_unported(args)
    assert args.devices in (2, 4)
