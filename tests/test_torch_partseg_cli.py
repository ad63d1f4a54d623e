"""The port's part-segmentation path through its CLIs on the CPU
(``--device cpu``): ``cli.train`` → ``cli.eval`` → ``cli.attack_object`` of
the SSG on the 3-category synthetic ShapeNetPart (300-point shapes, 64 of
them loaded, the JAX CLI test's fixture and sizes); MSG and PointNet in
``test_torch_partseg_cli_nets.py``.

The SSG trains 2 epochs at batch 4 and resumes for a 3rd: every loss
finite, the loss falling. (The instance-mIoU floor of the JAX CLI test,
0.25 after 6 epochs, is left to the card's longer run: on this fixture
both packages sit near 0.2–0.35 for several epochs before the jump, and
where depends on the BLAS's rounding, e.g. the thread count.) ``cli.eval``
is held to the trainer's own figures and to the JAX package's
``evaluate_partseg`` over the JAX model on the same weights (carried back
through ``utils/convert.py``); the attack TSV's clean mIoUs to that JAX
model's, shape by shape. ``tar_nb --origin`` moves the origin part's
points and no other."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from pointsecguard_tpu.data.shapenet_part import ShapeNetPartDataset as JaxShapeNetPart
from pointsecguard_tpu.models import PointNet2PartSegMSG as JaxMSG
from pointsecguard_tpu.models import PointNet2PartSegSSG as JaxSSG
from pointsecguard_tpu.models import PointNetPartSeg as JaxPointNet
from pointsecguard_tpu.train.object_eval import evaluate_partseg as jax_evaluate_partseg
from pointsecguard_tpu.train.object_eval import shape_part_ious as jax_shape_part_ious
from pointsecguard_tpu_torch import attacks
from pointsecguard_tpu_torch.cli import attack_object as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data.shapenet_part import SEG_CLASSES, make_synthetic_shapenetpart
from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
from pointsecguard_tpu_torch.utils.convert import cls_to_jax_variables

NPOINT = 64
_JAX = {"pointnet2_part_seg": lambda: JaxSSG(num_classes=50, normal_channel=True),
        "pointnet2_part_seg_msg": lambda: JaxMSG(num_classes=50, normal_channel=True),
        "pointnet_part_seg": lambda: JaxPointNet(part_num=50, normal_channel=True)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _events(log):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def train(data, log, model, epochs, eval_every):
    train_cli.main(["--device", "cpu", "--model", model, "--data_root", data, "--log_dir", log,
                    "--npoint", str(NPOINT), "--batch_size", "4", "--epochs", str(epochs),
                    "--eval_every", str(eval_every), "--learning_rate", "0.003"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fixture tree and the SSG trained 2 epochs (an eval after the
    2nd) and resumed for a 3rd (an eval after it), 5 steps of 4 shapes an
    epoch."""
    root = tmp_path_factory.mktemp("partseg")
    model = "pointnet2_part_seg"
    data, log = {model: str(root / "sn")}, {model: str(root / model)}
    make_synthetic_shapenetpart(data[model], points_per_shape=300, seed=4)
    for epochs in (2, 3):
        train(data[model], log[model], model, epochs, 2)
    return {"data": data, "logs": log}


def test_training_epochs_evals_and_resume(trained):
    ev = _events(trained["logs"]["pointnet2_part_seg"])
    epochs = [e for e in ev if e["event"] == "epoch"]
    evals = [e for e in ev if e["event"] == "eval"]
    assert [e["epoch"] for e in epochs] == list(range(3))  # the resumed run repeats none
    assert [e["epoch"] for e in evals] == [1, 2]
    assert all(e["batches"] == 5 and np.isfinite(e["loss"]) and not e["nan_batches"]
               for e in epochs)
    assert epochs[-1]["loss"] < epochs[0]["loss"]
    assert [e["bn_momentum"] for e in epochs] == [0.1] * 3  # halved every 20 epochs
    assert set(evals[0]) >= {"instance_miou", "class_avg_miou", "accuracy"}


def _jax_logp(model, log):
    flat = cls_to_jax_variables(model, load_checkpoint(log))
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    net = _JAX[model]()
    return jax.jit(lambda p, oh: net.apply(variables, p, oh)[0])


def check_eval(trained, model, capsys):
    """The trainer's figures for the checkpoint ``cli.eval`` loads (the
    best), and JAX's ``evaluate_partseg`` over the JAX model on the same
    weights, at another batch size."""
    log, data = trained["logs"][model], trained["data"][model]
    m = eval_cli.main(["--device", "cpu", "--model", model, "--data_root", data,
                       "--log_dir", log, "--num_point", str(NPOINT), "--batch_size", "4"])
    best = max((e for e in _events(log) if e["event"] == "eval"),
               key=lambda e: e["instance_miou"])
    for key in ("instance_miou", "class_avg_miou", "accuracy"):
        assert m[key] == pytest.approx(best[key], abs=1e-12)
    m2 = eval_cli.main(["--device", "cpu", "--model", model, "--data_root", data,
                        "--log_dir", log, "--num_point", str(NPOINT), "--batch_size", "2"])
    want = jax_evaluate_partseg(_jax_logp(model, log),
                                JaxShapeNetPart(data, "test", num_point=NPOINT), batch_size=2)
    assert m2["category_miou"] == pytest.approx(want["category_miou"], abs=1e-12)
    assert m2["accuracy"] == pytest.approx(want["accuracy"], abs=1e-12)
    assert "PARTSEG instance mIoU" in capsys.readouterr().err


def test_eval_matches_the_trainer_and_jax(trained, capsys):
    check_eval(trained, "pointnet2_part_seg", capsys)


def _attack(trained, *flags, model="pointnet2_part_seg"):
    return attack_cli.main(["--device", "cpu", "--model", model, "--data_root",
                            trained["data"][model], "--log_dir", trained["logs"][model],
                            "--num_point", str(NPOINT), "--batch_size", "4", *flags])


def _tsv(path):
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        return head, [line.rstrip("\n").split("\t") for line in f]


def test_attack_object_nb_with_control(trained, capsys):
    """The 6 test shapes in two batches (the second padded); NB moves xyz
    only, within ε = 0.05 (L∞); the clean mIoUs are the JAX model's."""
    out = _attack(trained, "--attack", "nb", "--iters", "2", "--control")
    head, rows = _tsv(out["tsv"])
    assert head == ["idx", "category", "clean_miou", "adv_miou", "l2", "rand_miou"]
    assert [int(r[0]) for r in rows] == list(range(6)) and len(out["batch_ms"]) == 2
    ds = JaxShapeNetPart(trained["data"]["pointnet2_part_seg"], "test", num_point=NPOINT)
    loaded = [ds.load(i) for i in range(6)]
    logp = np.asarray(_jax_logp("pointnet2_part_seg", trained["logs"]["pointnet2_part_seg"])(
        jnp.asarray(np.stack([l[0] for l in loaded])),
        jnp.asarray(np.eye(16, dtype=np.float32)[[l[1] for l in loaded]])))
    want = [np.mean(jax_shape_part_ious(logp[i], loaded[i][2], ds.categories[i]))
            for i in range(6)]
    assert [r[1] for r in rows] == ds.categories[:6]
    np.testing.assert_allclose([float(r[2]) for r in rows], want, atol=1e-4)
    l2 = np.array([float(r[4]) for r in rows])
    assert (l2 > 0).all() and (l2 <= 0.05 * np.sqrt(3 * NPOINT) + 1e-6).all()
    assert out["rand_miou"] is not None and 0 <= out["adv_miou"] <= 1
    err = capsys.readouterr().err
    assert "DATASET clean instance mIoU" in err and "rand-noise mIoU" in err


def test_attack_object_tar_nb_origin_moves_the_origin_part_only(trained, monkeypatch):
    """``--origin``: the engine gets the mask of the origin part's points
    and moves no other point; its target is ``--target``."""
    runs = []
    engine = attacks.pgd_color_attack

    def recording(f, pts, labels, cfg, mask=None, **kw):
        res = engine(f, pts, labels, cfg, mask=mask, **kw)
        runs.append((labels, mask, (res.points_adv - pts).abs().sum(-1), cfg))
        return res

    monkeypatch.setattr(attacks, "pgd_color_attack", recording)
    origin, target = SEG_CLASSES["Table"][0], SEG_CLASSES["Table"][2]
    out = _attack(trained, "--attack", "tar_nb", "--iters", "3", "--origin", str(origin),
                  "--target", str(target), "--control")
    assert len(runs) == 2 and np.isfinite(out["l2_mean"])
    for labels, mask, moved, cfg in runs:
        assert cfg.targeted and cfg.target == target
        assert torch.equal(mask, labels == origin)
        assert not moved[~mask].any()
    assert any(moved[mask].gt(0).any() for _, mask, moved, _ in runs)


@pytest.mark.parametrize("flags", [
    ["--attack", "nb", "--iters", "1", "--fixed_geometry"],
    ["--attack", "tar_nb", "--iters", "1", "--target", "47"],
    ["--attack", "nu", "--steps", "1"],
    ["--attack", "tar_nu", "--steps", "1", "--target", "23", "--origin", "22"],
    ["--attack", "nb", "--iters", "1", "--defense", "sor"],
    ["--attack", "nb", "--iters", "1", "--defense", "srs", "--eot", "2"],
    ["--attack", "random", "--noise_norm", "0.5"],
], ids=" ".join)
def test_attack_object_flags(trained, flags):
    out = _attack(trained, *flags, "--max_shapes", "4")
    _, rows = _tsv(out["tsv"])
    assert len(rows) == 4 and all(len(r) == 5 for r in rows)
    assert np.isfinite(out["l2_mean"]) and out["l2_mean"] > 0
    if "random" in flags:
        assert {r[4] for r in rows} == {"0.500000"}
