"""``cli.benchmark --devices 2`` and ``cli.attack --log_steps --devices 2``
through the CLI bodies on two gloo ranks of the CPU, against the
one-process run of the same arguments (``parallel.dryrun.cli_program``, as
in tests/test_torch_parallel_attack.py): the five benchmark modes on a
seeded PointNet over 128-point blocks (the cheapest block model on the
CPU; ``chip_smoke.py`` runs them on the trained SSG), NES among the attacks
(its draws made for the whole batch), a targeted decision attack on
``--task cls`` (its seed harvested from the whole batch), and NB's
per-step trajectory. The ranks start once for the module: four of them,
of which the first two run every program (``dryrun.programs``' ``ranks``,
as ``chip_smoke.py`` runs its two-rank programs). A CPU rank takes one
torch thread, and the one-process run takes as many: the CPU's matmuls
round by their thread count. Integer outputs must be equal, floats within
``RTOL``."""

import numpy as np
import pytest
import torch

from pointsecguard_tpu_torch.cli import benchmark as bench_cli
from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset, make_synthetic_modelnet
from pointsecguard_tpu_torch.models import PointNetSemSeg
from pointsecguard_tpu_torch.parallel import dryrun, make_mesh, spawn
from pointsecguard_tpu_torch.train.trainer import cls_model
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

THREADS = 2  # this process's torch threads: a CPU rank takes max(1, 2 // 4) = 1
RTOL = 1e-5  # float results: the ranks' per-row sums round as one process's, or nearly

# (name, argv after the data flags); the benchmark cases first
SEMSEG = [
    ("prediction", ["--mode", "prediction"]),
    ("attack pgd", ["--mode", "attack", "--attack_name", "pgd", "--iters", "2"]),
    ("attack nes", ["--mode", "attack", "--attack_name", "nes", "--iters", "2",
                    "--samples", "2", "--eps", "0.2"]),
    ("distortion", ["--mode", "distortion", "--attack_name", "fgsm", "--eps", "0.05"]),
    ("iteration", ["--mode", "iteration", "--attack_name", "bim", "--iters", "4"]),
    ("worstcase", ["--mode", "worstcase", "--attack_names", "fgsm,pgd", "--iters", "2"]),
]


@pytest.fixture(scope="module", autouse=True)
def _rank_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Synthetic rooms with a seeded PointNet, and ModelNet shapes with a
    seeded PointNet classifier that gives the last two test shapes a class
    of their own, the targeted attack's target; a log dir per run."""
    root = tmp_path_factory.mktemp("parallel_benchmark")
    make_synthetic_rooms(str(root / "rooms"), points_per_room=3000, seed=0)
    torch.manual_seed(0)
    sd = PointNetSemSeg().state_dict()
    mn = str(root / "mn")
    make_synthetic_modelnet(mn, points_per_shape=256, train_per_class=1, test_per_class=2,
                            seed=4)
    # xyz only: a seed's coordinates carry its class, with no other normals
    dataset = ModelNetDataset(mn, "test", num_point=128, use_normals=False)
    torch.manual_seed(5)
    model, _ = cls_model("pointnet_cls", dataset.num_classes, use_normals=False)
    with torch.no_grad():
        pts = torch.from_numpy(np.stack([dataset.load(i)[0] for i in range(8)]))
        pred = torch.argmax(model.eval()(pts)[0], dim=-1).tolist()
    target = pred[-1]
    assert pred.index(target) == 6  # the seed: shape 6, the last batch's row on rank 0
    for run in ("one", "dp"):
        save_checkpoint(str(root / f"pn_{run}"), sd)
        save_checkpoint(str(root / f"cls_{run}"), model.state_dict())
    return {"root": root, "mn": mn, "target": target}


def _calls(fx, run: str, flags: list) -> list:
    root = fx["root"]
    semseg = ["--device", "cpu", "--model", "pointnet", "--data_root", str(root / "rooms"),
              "--log_dir", str(root / f"pn_{run}"), "--num_point", "128", "--batch_size", "4",
              *flags]
    calls = [("cli_program", ("benchmark", semseg + ["--max_blocks", "8", *argv]), {})
             for _, argv in SEMSEG]
    # the targeted decision attack at one shape a rank
    cls = ["--device", "cpu", "--task", "cls", "--model", "pointnet_cls", "--data_root",
           fx["mn"], "--log_dir", str(root / f"cls_{run}"), "--num_point", "128",
           "--batch_size", "2", "--max_blocks", "8", "--mode", "attack", "--attack_name",
           "evolutionary", "--goal", "t", "--target", str(fx["target"]), "--iters", "3",
           "--init_tries", "2", "--no_normals", *flags]
    calls.append(("cli_program", ("benchmark", cls), {}))
    calls.append(("cli_program", ("attack", semseg + ["--attack", "nb", "--log_steps",
                                                     "--max_blocks", "6"]), {}))
    return calls


@pytest.fixture(scope="module")
def runs(root):
    torch.set_num_threads(THREADS // 2)
    try:
        one = dryrun.programs(None, _calls(root, "one", []))
    finally:
        torch.set_num_threads(THREADS)
    # the first two of four ranks (a 2 x 2 mesh), as chip_smoke.py runs its
    # two-rank programs inside its one start of four; ranks 2 and 3 wait
    calls = [(name, args, {"ranks": 2, "view": "data"})
             for name, args, _ in _calls(root, "dp", ["--devices", "2"])]
    # and a program whose collectives span every rank of its mesh: the
    # pair's group, not the four processes' default one
    calls.append(("collective_program", (XYZ, 4), {"ranks": 2}))
    dp = spawn(dryrun.programs, make_mesh(["cpu"] * 4, points_axis=2), (calls,))
    assert all(r is None for rank in dp[2:] for r in rank)
    return {"one": [r for r, _ in one],
            "dp": [[r for r, _ in rank[:-1]] + rank[-1:] for rank in dp[:2]]}


XYZ = np.random.default_rng(3).random((2, 64, 3)).astype(np.float32)


def test_pair_collectives_stay_in_the_pair(runs):
    """``collective_program`` on the first two of four ranks as a points
    mesh of its own: the all-reduce sums their ids alone (0 + 1), and each
    rank's half of the kNN equals ``ops.knn``'s rows of it."""
    from pointsecguard_tpu_torch import ops

    _, want = ops.knn(torch.from_numpy(XYZ), torch.from_numpy(XYZ), 4)
    for r, rank in enumerate(runs["dp"]):
        ids, _, idx, _ = rank[-1]
        assert ids.tolist() == [1.0] * 4
        np.testing.assert_array_equal(idx, want[:, r * 32:(r + 1) * 32].numpy())


def _equal(got, want, what: str):
    """Integer and boolean arrays equal, floats within ``RTOL``, through
    tuples, lists and dicts."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, (float, np.ndarray, np.generic)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("case", range(len(SEMSEG)), ids=[n for n, _ in SEMSEG])
def test_benchmark_mode_equals_one_process(runs, case):
    """Every rank returns what one process returns: the prediction arrays,
    ares' five per-point arrays (NES on its whole-batch draws), the sweep's
    probes and minimal ε (each probe decided on the pooled counts), the
    iteration rows, the worst case's union."""
    want = runs["one"][case]
    for rank in runs["dp"]:
        _equal(rank[case], want, SEMSEG[case][0])


def test_prediction_file_written_once(root, runs):
    """Rank 0 alone writes ``predictions.npz``, equal to one process's."""
    got = np.load(root["root"] / "pn_dp" / "predictions.npz")
    want = np.load(root["root"] / "pn_one" / "predictions.npz")
    for k in ("ys", "ys_target", "predictions"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["ys"].shape == (8, 128)


def test_targeted_decision_attack_equals_one_process(root, runs):
    """Evolutionary toward the class the model gives shapes 6 and 7 alone,
    at batch 2 over 2 ranks, each holding one shape of a batch: the seed is
    the first such shape of the gathered batches (shape 6, on rank 0), so
    rank 1 starts from it too, not from its own shape 7; the five arrays
    equal one process's, and the seeded shapes are successes."""
    case = len(SEMSEG)
    want = runs["one"][case]
    for rank in runs["dp"]:
        _equal(rank[case], want, "evolutionary t")
    acc, acc_adv, total, succ, dist = want
    assert total.tolist() == [True] * 6 + [False] * 2 and succ.any()


def _steps(path) -> list:
    with open(path) as f:
        return f.read().splitlines()


def test_log_steps_equals_one_process(root, runs):
    """``cli.attack --log_steps --devices 2``: each step's accuracy pooled
    over the ranks' counts and the mean L2 over the gathered clouds; rank
    0's ``_steps.tsv`` is the one-process file, and so is the TSV without
    its ``time_s``."""
    got = _steps(root["root"] / "pn_dp" / "pointnet_nb_area5_steps.tsv")
    want = _steps(root["root"] / "pn_one" / "pointnet_nb_area5_steps.tsv")
    assert got == want and len(want) == 1 + 2 * 10  # 2 batches of 10 NB iterations
    strip = lambda rows: [r.rsplit("\t", 1)[0] for r in rows]  # noqa: E731 (time_s last)
    assert strip(_steps(root["root"] / "pn_dp" / "pointnet_nb_area5.tsv")) == \
        strip(_steps(root["root"] / "pn_one" / "pointnet_nb_area5.tsv"))


def test_batch_size_must_divide_the_ranks(root):
    """``--batch_size 3`` over 2 ranks: ``make_batch_put``'s message, from
    the ranks."""
    with pytest.raises(Exception, match="not divisible by the data axis"):
        bench_cli.main(["--device", "cpu", "--model", "pointnet", "--devices", "2",
                        "--batch_size", "3",
                        "--data_root", str(root["root"] / "rooms"), "--log_dir",
                        str(root["root"] / "pn_one"), "--num_point", "128",
                        "--mode", "prediction"])
