"""``cli.train`` → ``cli.eval`` → ``cli.attack_object`` of the part-seg
PointNet++ MSG and PointNet on the CPU (``--device cpu``), on a small
synthetic ShapeNetPart (two train-and-val shapes and one test shape a
category, 300 points a file, 64 loaded): one training step each, eval held
to the trainer and to JAX's ``evaluate_partseg`` on the same weights, NB
through each, and the part-seg defaults (2048 points, batch 8). The SSG and
the helpers are in ``test_torch_partseg_cli.py``."""

import pytest
import torch

from pointsecguard_tpu_torch.cli import attack_object as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.data.shapenet_part import make_synthetic_shapenetpart
from test_torch_partseg_cli import _attack, _events, _tsv, check_eval, train

_NETS = ("pointnet2_part_seg_msg", "pointnet_part_seg")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The small tree and one epoch of one step (6 train-and-val shapes at
    batch 4, the tail dropped) for each net, an eval after it."""
    root = tmp_path_factory.mktemp("partseg_nets")
    small = str(root / "sn_small")
    make_synthetic_shapenetpart(small, points_per_shape=300, train_per_class=1,
                                val_per_class=1, test_per_class=1, seed=5)
    data, logs = {}, {}
    for model in _NETS:
        data[model], logs[model] = small, str(root / model)
        train(small, logs[model], model, 1, 1)
    return {"data": data, "logs": logs}


@pytest.mark.parametrize("model", _NETS)
def test_one_step_and_an_eval(trained, model):
    ev = _events(trained["logs"][model])
    assert [e["event"] for e in ev] == ["epoch", "eval"] and ev[0]["batches"] == 1
    assert set(ev[1]) >= {"instance_miou", "class_avg_miou", "accuracy"}


@pytest.mark.parametrize("model", _NETS)
def test_eval_matches_the_trainer_and_jax(trained, model, capsys):
    check_eval(trained, model, capsys)


@pytest.mark.parametrize("model", _NETS)
def test_attack_object_nb(trained, model):
    out = _attack(trained, "--attack", "nb", "--iters", "1", model=model)
    assert len(_tsv(out["tsv"])[1]) == 3 and out["l2_mean"] > 0


def test_part_seg_defaults_and_refusals(trained):
    """Batch 8 and 2048 points by default (the loader repeats the 300-row
    files); ``--visual`` / ``--adv_set`` stay the segmentation models'."""
    model = "pointnet_part_seg"
    out = attack_cli.main(["--device", "cpu", "--model", model, "--data_root",
                           trained["data"][model], "--log_dir", trained["logs"][model],
                           "--attack", "random"])
    assert len(out["batch_ms"]) == 1  # the 3 test shapes in one batch of 8
    with pytest.raises(SystemExit, match="--visual and --adv_set"):
        eval_cli.main(["--device", "cpu", "--model", model, "--data_root",
                       trained["data"][model], "--log_dir", trained["logs"][model], "--visual"])
