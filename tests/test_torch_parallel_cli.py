"""``cli.train`` and ``cli.attack`` of RandLA-Net with ``--devices 2``
and ``--devices 2 --shard_points 2`` through the CLI bodies on two gloo
ranks of the CPU, against the one-process run of the same arguments
(tests/test_torch_parallel_attack.py does the block models' attack and
eval).

A rank of ``cli.main`` is ``parallel.dryrun.cli_program``: the CLI's parser
and refusals, then its body with the rank's context, as ``--devices N``
starts it one card each. Each layout starts its ranks once, for every run
it holds. A CPU rank takes the spawning process's torch threads divided by the
ranks (here 2 // 2), and the one-process run here takes as many: the
CPU's matmuls round by their thread count.

The training runs take lr 1e-12: Adam turns the gradients' rounding (the
ranks sum in another order, and the random-initialised network amplifies
it) into ±lr steps on every parameter, which at a training lr part two
runs within a few steps whatever the code (at 1e-6 RandLA's epoch loss
already moves 1e-3); tests/test_torch_parallel_train.py holds one step's
gradient in float64. The batches, draws, BatchNorm statistics and
validation are then the one-process run's to rounding."""

import json
import os

import numpy as np
import pytest
import torch

from pointsecguard_tpu_torch.data import make_synthetic_rooms, randla
from pointsecguard_tpu_torch.models import RandLANet, init_parameters
from pointsecguard_tpu_torch.parallel import make_mesh, spawn
from pointsecguard_tpu_torch.parallel import dryrun
from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint

THREADS = 2  # this process's torch threads: each of two CPU ranks takes 1
RANDLA_TRAIN = ["--model", "randla", "--randla_points", "1024", "--batch_size", "2",
                "--steps_per_epoch", "3", "--val_steps", "2", "--epochs", "1",
                "--learning_rate", "1e-12"]


@pytest.fixture(scope="module", autouse=True)
def _rank_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _one_process(calls: list) -> list:
    """``calls`` in this process at one torch thread, a rank's count."""
    torch.set_num_threads(THREADS // 2)
    try:
        return dryrun.programs(None, calls)
    finally:
        torch.set_num_threads(THREADS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Synthetic rooms prepared as RandLA clouds at 0.1 m, and a seeded
    RandLA checkpoint in two log dirs."""
    root = tmp_path_factory.mktemp("parallel_cli")
    make_synthetic_rooms(str(root / "rooms"), points_per_room=3000, seed=0)
    for name in sorted(os.listdir(root / "rooms")):
        randla.prepare_room(str(root / "rooms" / name), str(root / "prep"), 0.1)
    model = RandLANet()
    init_parameters(model, torch.Generator().manual_seed(0))
    for d in ("randla_1", "randla_2"):
        save_checkpoint(str(root / d), model.state_dict())
    return root


def _argv(root, which: str, log: str) -> tuple[str, list]:
    common = ["--device", "cpu", "--log_dir", str(root / log), "--randla_dir", str(root / "prep")]
    if which == "train":
        return "train", common + RANDLA_TRAIN
    return "attack", common + ["--model", "randla", "--attack", "nb", "--randla_points", "1024",
                               "--num_clouds", "2", "--batch_size", "2"]


@pytest.fixture(scope="module")
def runs(root):
    """One process, 2 data ranks (training) and 1 × 2 points ranks
    (training and NB), each CLI run in its own log dir."""
    def calls(jobs, flags):
        return [("cli_program", (cli, argv + flags), {}) for cli, argv in jobs]

    one = _one_process(calls([_argv(root, "train", "train_1"),
                              _argv(root, "attack", "randla_1")], []))
    dp = spawn(dryrun.programs, make_mesh(["cpu"] * 2),
               (calls([_argv(root, "train", "train_dp")], ["--devices", "2"]),))
    sp = spawn(dryrun.programs, make_mesh(["cpu"] * 2, points_axis=2),
               (calls([_argv(root, "train", "train_sp"), _argv(root, "attack", "randla_2")],
                      ["--devices", "2", "--shard_points", "2"]),))
    return {"one": one, "dp": dp, "sp": sp}


def _events(path) -> list:
    with open(path / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def _tsv(path) -> list:
    """The TSV's rows without their ``time_s`` cell."""
    with open(path) as f:
        lines = f.read().splitlines()
    col = lines[0].split("\t").index("time_s")
    return [[c for i, c in enumerate(line.split("\t")) if i != col] for line in lines]


@pytest.mark.parametrize("layout", ["dp", "sp"])
def test_train_equals_one_process(root, runs, layout):
    """RandLA ``cli.train --devices 2 [--shard_points 2]``: the epoch's loss
    within rtol 1e-5 of the one-process run's, the same batches, the
    validation metrics equal, the checkpoint (written by rank 0 alone)
    within rtol 1e-4 / atol 1e-5 (the BatchNorm statistics follow the
    steps' rounding, see above)."""
    one, many = _events(root / "train_1"), _events(root / f"train_{layout}")
    assert [e["event"] for e in many] == ["epoch", "eval"]
    assert many[0]["batches"] == one[0]["batches"] == 3 and many[0]["nan_batches"] == 0
    assert many[0]["loss"] == pytest.approx(one[0]["loss"], rel=1e-5)
    assert (many[1]["miou"], many[1]["accuracy"]) == (one[1]["miou"], one[1]["accuracy"])
    want = CheckpointManager(str(root / "train_1" / "checkpoints")).restore_latest()
    got = CheckpointManager(str(root / f"train_{layout}" / "checkpoints")).restore_latest()
    assert got["step"] == want["step"] and got["epoch"] == want["epoch"] == 1
    for k, v in want["model"].items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert runs[layout][1][0][0][0] is None  # a rank returns no train state
    assert runs["one"][0][0][0] is not None


def test_randla_attack_with_shard_points_equals_one_process(root, runs):
    """RandLA NB with ``--devices 2 --shard_points 2``: both ranks attack the
    whole clouds, their pyramid's kNN split over the points axis; the TSV
    is the one-process TSV, ``time_s`` aside."""
    assert _tsv(root / "randla_2" / "randla_nb_area5.tsv") \
        == _tsv(root / "randla_1" / "randla_nb_area5.tsv")
    (clean1, adv1), _ = runs["one"][1]
    for rank in runs["sp"]:
        (clean2, adv2), _ = rank[1]
        assert (clean2.miou, adv2.miou) == (clean1.miou, adv1.miou)


def test_only_rank_zero_writes(root, runs):
    """One event line an epoch (not one a rank), and rank 0's log file."""
    for d in ("train_dp", "train_sp"):
        assert len(_events(root / d)) == 2
        assert os.path.exists(str(root / d) + ".train.log")
    with open(root / "randla_2" / "randla_nb_area5.tsv") as f:
        assert len(f.read().splitlines()) == 1 + 2
