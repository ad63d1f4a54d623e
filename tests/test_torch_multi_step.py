"""``--steps_per_call`` and ``--profile`` in the port, on the CPU:
``data.loader.stack_batches`` against the JAX package's, a K-step call of
``train.trainer.make_multi_train_step`` bit for bit against K single
steps (losses, parameters, Adam moments, count and BatchNorm statistics,
the generator's FPS starts and dropout masks drawn in the same order),
``cli.train --steps_per_call 3`` against 1 on a small fixture (the same
final checkpoint) on two of the five loops, and the Chrome trace that
``--profile`` writes."""

import json
import os

import numpy as np
import pytest
import torch

from pointsecguard_tpu.data.loader import stack_batches as jax_stack_batches
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.data.loader import stack_batches
from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, init_parameters, weighted_nll_loss
from pointsecguard_tpu_torch.train.trainer import (
    POINTNET2,
    TrainState,
    make_multi_train_step,
    make_train_step,
)
from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n,k", [(7, 1), (7, 3), (6, 3), (2, 4), (0, 3)])
def test_stack_batches_equals_jax(n, k):
    rng = np.random.default_rng(n)
    items = [(rng.random((2, 5, 9), dtype=np.float32), rng.integers(0, 13, (2, 5)))
             for _ in range(n)]
    got, want = list(stack_batches(iter(items), k)), list(jax_stack_batches(iter(items), k))
    assert len(got) == len(want) == (n // k + n % k if k > 1 else n)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 2
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _ssg_state(seed=0):
    model = PointNet2SemSegSSG()
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model, TrainState(model)


def test_k_steps_a_call_equal_k_single_calls():
    """PointNet++ SSG at 2 × 128: one call of K = 3 and three single calls
    from the same state and generator seed give the same losses, parameters,
    Adam moments and count, and BatchNorm statistics, bit for bit; a
    non-finite batch in the middle is skipped by the guard in both."""
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.random((3, 2, 128, 9), dtype=np.float32))
    pts[1, 0, 0, 3] = float("nan")  # the second step's loss is NaN: skipped
    labels = torch.from_numpy(rng.integers(0, 13, (3, 2, 128)))
    weights = torch.from_numpy((0.5 + rng.random(13)).astype(np.float32))
    runs = []
    for multi in (True, False):
        model, state = _ssg_state()
        gen = torch.Generator().manual_seed(5)
        if multi:
            losses = make_multi_train_step(model, weighted_nll_loss, family=POINTNET2)(
                state, pts, labels, weights, 0.003, 0.1, gen)
        else:
            step = make_train_step(model, weighted_nll_loss, family=POINTNET2)
            losses = torch.stack([step(state, pts[i], labels[i], weights, 0.003, 0.1, gen)
                                  for i in range(3)])
        runs.append((losses, state))
    (l_multi, s_multi), (l_single, s_single) = runs
    assert l_multi.shape == (3,) and torch.isnan(l_multi[1]) and torch.isfinite(l_multi[0])
    assert torch.equal(l_multi, l_single) or torch.equal(torch.nan_to_num(l_multi),
                                                         torch.nan_to_num(l_single))
    for name in ("params", "mu", "nu", "count", "stats"):
        assert torch.equal(getattr(s_multi, name), getattr(s_single, name)), name
    assert s_multi.step == s_single.step == 3 and s_multi.count.item() == 2.0


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("rooms"))
    make_synthetic_rooms(data, points_per_room=3000, seed=0)
    return data


_CLI_CASES = {
    # 6 steps an epoch at batch 4: two calls of 3
    "pointnet": ["--model", "pointnet", "--npoint", "128", "--batch_size", "4",
                 "--epochs", "2", "--eval_every", "2"],
    # ResGCN with ε > 0: the dilation's draws ride on the generator too
    "resgcn": ["--model", "resgcn", "--npoint", "128", "--batch_size", "4", "--epochs", "1",
               "--resgcn_blocks", "3", "--resgcn_filters", "8", "--resgcn_k", "4",
               "--resgcn_epsilon", "0.2"],
}


@pytest.mark.parametrize("case", sorted(_CLI_CASES))
def test_cli_steps_per_call_3_gives_the_checkpoint_of_1(rooms, tmp_path, case):
    latest, batches = {}, {}
    for spc in (1, 3):
        log = str(tmp_path / f"spc{spc}")
        train_cli.main(["--device", "cpu", "--data_root", rooms, "--log_dir", log,
                        "--steps_per_call", str(spc), *_CLI_CASES[case]])
        latest[spc] = CheckpointManager(os.path.join(log, "checkpoints")).restore_latest()
        with open(os.path.join(log, "events.jsonl")) as f:
            batches[spc] = [json.loads(line)["batches"] for line in f
                            if json.loads(line)["event"] == "epoch"]
    assert batches[1] == batches[3] and batches[1][0] == 6
    a, b = latest[1], latest[3]
    assert a["step"] == b["step"] == sum(batches[1]) and torch.equal(a["count"], b["count"])
    assert set(a["model"]) == set(b["model"])
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["nu"], b["nu"])


def test_profile_writes_a_trace_of_the_first_epoch(rooms, tmp_path):
    trace = tmp_path / "trace"
    train_cli.main(["--device", "cpu", "--model", "pointnet", "--data_root", rooms,
                    "--log_dir", str(tmp_path / "log"), "--npoint", "128", "--batch_size", "8",
                    "--epochs", "2", "--eval_every", "99", "--profile", str(trace)])
    assert sorted(os.listdir(trace)) == ["epoch_0.json"]  # the first epoch only
    with open(trace / "epoch_0.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the step's operators: the PointNet forward's matmuls and Adam's sqrt
    assert any(n.startswith("aten::") for n in names) and "aten::sqrt" in names
