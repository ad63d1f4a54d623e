"""``cli.attack`` NB and ``cli.eval`` of the trained PointNet++ fixture
with ``--devices 2`` through the CLI bodies on two gloo ranks of the CPU,
against the one-process run of the same arguments (``parallel.dryrun.
cli_program`` as in tests/test_torch_parallel_cli.py). A CPU rank takes
the spawning process's torch threads divided by the ranks (here 2 // 2),
and the one-process run here takes as many: the CPU's matmuls round by
their thread count."""

import os

import flax.serialization
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.parallel import make_mesh, spawn
from pointsecguard_tpu_torch.parallel import dryrun
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import from_jax_variables

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
THREADS = 2  # this process's torch threads: each of two CPU ranks takes 1


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
    """Synthetic rooms and the trained PointNet++ fixture as a port
    checkpoint in two log dirs."""
    root = tmp_path_factory.mktemp("parallel_attack")
    make_synthetic_rooms(str(root / "rooms"), points_per_room=3000, seed=0)
    with open(os.path.join(FIXDIR, "trained_pointnet2.msgpack"), "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    sd = from_jax_variables({k: np.asarray(v) for k, v in flatten_dict(raw, sep="/").items()})
    for d in ("ssg_1", "ssg_2"):
        save_checkpoint(str(root / d), sd)
    return root


def _calls(root, log: str, flags: list) -> list:
    data = ["--device", "cpu", "--data_root", str(root / "rooms"), "--log_dir", str(root / log),
            "--model", "pointnet2", "--num_point", "128", "--batch_size", "4", *flags]
    return [("cli_program", ("attack", data + ["--attack", "nb", "--max_blocks", "4"]), {}),
            ("cli_program", ("attack", data + ["--attack", "random", "--max_blocks", "4"]), {}),
            ("cli_program", ("eval", data + ["--num_votes", "1"]), {})]


@pytest.fixture(scope="module")
def runs(root):
    return {"one": _one_process(_calls(root, "ssg_1", [])),
            "dp": spawn(dryrun.programs, make_mesh(["cpu"] * 2),
                        (_calls(root, "ssg_2", ["--devices", "2"]),))}


def _tsv(path) -> list:
    """The TSV's rows without their ``time_s`` cell."""
    with open(path) as f:
        lines = f.read().splitlines()
    col = lines[0].split("\t").index("time_s")
    return [[c for i, c in enumerate(line.split("\t")) if i != col] for line in lines]


@pytest.mark.parametrize("attack,case", [("nb", 0), ("random", 1)])
def test_attack_equals_one_process(root, runs, attack, case):
    """NB, and ``--attack random`` (noise drawn for the whole batch, each
    rank keeping its rows), with ``--devices 2``: each rank attacks its 2
    rows of a batch of 4; the TSV rank 0 writes is the one-process TSV,
    ``time_s`` aside, and so are the pooled metrics on every rank."""
    got = _tsv(root / "ssg_2" / f"pointnet2_{attack}_area5.tsv")
    assert got == _tsv(root / "ssg_1" / f"pointnet2_{attack}_area5.tsv")
    assert len(got) == 1 + 4
    (clean1, adv1), _ = runs["one"][case]
    for rank in runs["dp"]:
        (clean2, adv2), _ = rank[case]
        assert (clean2.miou, adv2.miou, adv2.accuracy) == (clean1.miou, adv1.miou, adv1.accuracy)
    if attack == "nb":
        assert adv1.accuracy < clean1.accuracy


def test_eval_equals_one_process(runs):
    """Whole-scene voting eval with ``--devices 2``: every rank predicts its
    rows of each batch (the room's tail padded to the ranks' shape), the
    votes, pooled on every rank, give the one-process metrics."""
    want, _ = runs["one"][2]
    assert want.accuracy > 0.3
    for rank in runs["dp"]:
        got, _ = rank[2]
        assert got.accuracy == want.accuracy and got.miou == want.miou
        np.testing.assert_array_equal(got.class_iou, want.class_iou)

