"""The port's ``cli.benchmark`` on the CPU (``--device cpu``): the five
modes on synthetic rooms with the trained PointNet++ SSG fixture on
128-point blocks (prediction mode against the JAX model's argmax on the
same weights and blocks), the RandLA-Net and ResGCN branches, the flags
that stay refused, and the geometry built once a batch however many
queries an attack makes."""

import functools
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
from pointsecguard_tpu.models import build_geometry as jax_build_geometry
from pointsecguard_tpu_torch import configs as tconfigs
from pointsecguard_tpu_torch.cli import benchmark as bench_cli
from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks, make_synthetic_rooms, randla
from pointsecguard_tpu_torch.models import DenseDeepGCN, PointNet2SemSegSSG, RandLANet
from pointsecguard_tpu_torch.train import trainer
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import from_jax_variables

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL_RESGCN = ["--resgcn_blocks", "2", "--resgcn_filters", "8", "--resgcn_k", "4"]
NARROW = {"d_out": (8, 16), "num_layers": 2, "sub_sampling_ratio": (4, 4)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ssg(tmp_path_factory):
    """Synthetic rooms and the trained SSG fixture as the port's checkpoint."""
    root = tmp_path_factory.mktemp("benchmark")
    data = str(root / "data")
    make_synthetic_rooms(data, points_per_room=6000, seed=0)
    with open(os.path.join(FIXDIR, "trained_pointnet2.msgpack"), "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    model = PointNet2SemSegSSG()
    model.load_state_dict(from_jax_variables(
        {k: np.asarray(v) for k, v in flatten_dict(raw, sep="/").items()}))
    log = str(root / "log")
    save_checkpoint(log, model.state_dict())
    return {"data": data, "log": log, "raw": raw}


def _bench(ssg, *flags):
    return bench_cli.main(["--device", "cpu", "--data_root", ssg["data"], "--log_dir",
                           ssg["log"], "--num_point", "128", "--batch_size", "4",
                           "--max_blocks", "8", *flags])


def test_prediction_mode_matches_the_jax_argmax(ssg):
    ys, ys_target, preds = _bench(ssg, "--mode", "prediction")
    saved = np.load(os.path.join(ssg["log"], "predictions.npz"))
    assert sorted(saved.files) == ["predictions", "ys", "ys_target"]
    np.testing.assert_array_equal(saved["predictions"], preds)
    rooms = RoomSet.load(ssg["data"], "test", 5)
    feats, labs, _, _ = WholeSceneBlocks(rooms, block_points=128).room_blocks(
        0, np.random.default_rng(0))
    np.testing.assert_array_equal(saved["ys"], labs[:8])
    assert (saved["ys_target"] == 7).all() and saved["ys"].dtype == np.int32
    model = JaxSSG()

    def predict(p):
        out = model.apply(ssg["raw"], p, geometry=jax_build_geometry(p[..., :3]))[0]
        return out, jnp.argmax(out, -1)

    outs, want = (np.asarray(a) for a in jax.jit(predict)(jnp.asarray(feats[:8])))
    top2 = np.sort(outs, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4  # no near-tie of the log-probabilities
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(preds[clear], want[clear])
    assert (preds == labs[:8]).mean() > 0.4  # the trained fixture


def test_attack_mode_five_arrays(ssg):
    acc, acc_adv, total, succ, dist = _bench(ssg, "--mode", "attack", "--attack_name", "bim")
    assert acc.shape == acc_adv.shape == total.shape == succ.shape == (8 * 128,)
    assert dist.shape == (8,) and (dist > 0).all()
    assert acc_adv.mean() < acc.mean()
    np.testing.assert_array_equal(succ, total & ~acc_adv)


def test_distortion_and_iteration_modes(ssg):
    eps, details = _bench(ssg, "--mode", "distortion", "--attack_name", "bim", "--iters", "2",
                          "--eps", "0.05")
    probes = details["probes"]
    assert probes[0]["eps"] == 0.05 and len(probes) >= 2
    if np.isfinite(eps):
        assert any(p["success"] and p["eps"] == eps for p in probes)
    rows = _bench(ssg, "--mode", "iteration", "--attack_name", "fgsm")
    assert [r["iters"] for r in rows] == [1]  # fgsm: one step
    rows = _bench(ssg, "--mode", "iteration", "--attack_name", "mim", "--iters", "4")
    assert [r["iters"] for r in rows] == [1, 2, 3, 4]
    assert rows[-1]["l2"] > rows[0]["l2"]
    with pytest.raises(SystemExit, match="iteration-bounded"):
        _bench(ssg, "--mode", "iteration", "--attack_name", "cw")


def test_worstcase_mode(ssg):
    robust, per_attack, combined = _bench(ssg, "--mode", "worstcase", "--attack_names",
                                          "fgsm,nes", "--samples", "2", "--iters", "2")
    assert set(per_attack) == {"fgsm", "nes"}
    assert robust <= 1.0 - max(v["succ_rate"] for v in per_attack.values()) + 1e-12
    assert combined["dist"].shape == (8,)


def test_geometry_is_built_once_per_batch(ssg, monkeypatch):
    """NES at samples=2, iters=2 makes 1 + 2·2·2 + 1 = 10 forwards a batch;
    the PointNet++ geometry is built once a batch (two batches)."""
    calls = []
    real = trainer.build_geometry
    monkeypatch.setattr(trainer, "build_geometry",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    forwards = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: forwards.append(1) if isinstance(m, PointNet2SemSegSSG) else None)
    try:
        acc, acc_adv, *_ = _bench(ssg, "--mode", "attack", "--attack_name", "nes", "--samples",
                                  "2", "--iters", "2", "--eps", "0.3")
    finally:
        hook.remove()
    assert len(calls) == 2
    assert len(forwards) == 2 * 10
    assert acc_adv.mean() <= acc.mean()


def test_randla_and_resgcn_branches(tmp_path, monkeypatch, capsys):
    """RandLA-Net: one batch of 2 × 4096-point clouds from prepared rooms,
    a narrow random checkpoint, the pyramid built once a batch (a
    --max_blocks of 1 is rounded up to the batch); ResGCN: small flags,
    one batch of 4 blocks."""
    make_synthetic_rooms(str(tmp_path / "rooms"), points_per_room=6000, seed=2)
    for name in sorted(os.listdir(tmp_path / "rooms")):
        randla.prepare_room(str(tmp_path / "rooms" / name), str(tmp_path / "prep"), 0.1)
    monkeypatch.setattr(tconfigs, "RandlaConfig",
                        functools.partial(tconfigs.RandlaConfig, **NARROW))
    torch.manual_seed(0)
    save_checkpoint(str(tmp_path / "randla"),
                    RandLANet(num_classes=13, d_out=NARROW["d_out"]).state_dict())
    plans = []
    real = trainer.build_pyramid
    monkeypatch.setattr(trainer, "build_pyramid",
                        lambda *a, **k: plans.append(1) or real(*a, **k))
    acc, acc_adv, total, succ, dist = bench_cli.main([
        "--device", "cpu", "--model", "randla", "--randla_dir", str(tmp_path / "prep"),
        "--log_dir", str(tmp_path / "randla"), "--num_point", "4096", "--batch_size", "2",
        "--max_blocks", "1", "--attack_name", "pgd", "--iters", "2", "--eps", "0.2"])
    assert "(--max_blocks 1 rounded up to full 2-cloud batches)" in capsys.readouterr().err
    assert acc.shape == (2 * 4096,) and dist.shape == (2,) and len(plans) == 1
    with pytest.raises(SystemExit, match="explicit --max_blocks"):
        bench_cli.main(["--device", "cpu", "--model", "randla", "--max_blocks", "0",
                        "--randla_dir", str(tmp_path / "prep"), "--log_dir",
                        str(tmp_path / "randla")])

    make_synthetic_rooms(str(tmp_path / "data"), points_per_room=6000, seed=0)
    save_checkpoint(str(tmp_path / "resgcn"),
                    DenseDeepGCN(n_blocks=2, n_filters=8, k=4).state_dict())
    acc, acc_adv, total, succ, dist = bench_cli.main([
        "--device", "cpu", "--model", "resgcn", *SMALL_RESGCN, "--data_root",
        str(tmp_path / "data"), "--log_dir", str(tmp_path / "resgcn"), "--num_point", "128",
        "--batch_size", "4", "--max_blocks", "4", "--attack_name", "bim", "--iters", "2"])
    assert acc.shape == (4 * 128,) and (dist > 0).all()


# the classification task and the one-decision attacks, once refused, are
# ported (tests/test_torch_cls_cli.py runs them): their flags are parsed and
# pass the refusals and the JAX CLI's task checks; --devices and --precision
# bfloat16 stay refused, on either task
_CLS = ["--task", "cls", "--model", "pointnet2_cls"]


@pytest.mark.parametrize("flags", [
    [*_CLS, "--devices", "2"], [*_CLS, "--precision", "bfloat16"],
    ["--model", "pointnet_cls", "--task", "cls", "-d", "4"],
    ["--devices", "2"], ["--precision", "bfloat16"], ["--resgcn_blocks", "3"],
])
def test_unported_flags_are_refused(flags, tmp_path):
    with pytest.raises(SystemExit, match="not ported yet"):
        bench_cli.main(["--device", "cpu", "--log_dir", str(tmp_path), *flags])


@pytest.mark.parametrize("flags,name,value", [
    (_CLS, "task", "cls"),
    (["--task", "cls", "--model", "pointnet_cls"], "model", "pointnet_cls"),
    (["--task", "cls", "--model", "pointnet2_cls_msg"], "model", "pointnet2_cls_msg"),
    ([*_CLS, "--attack_name", "deepfool"], "attack_name", "deepfool"),
    ([*_CLS, "--attack_name", "boundary", "--mode", "distortion"], "attack_name", "boundary"),
    ([*_CLS, "--attack_name", "evolutionary", "--goal", "t"], "attack_name", "evolutionary"),
    ([*_CLS, "--mode", "worstcase", "--attack_names", "pgd,deepfool"], "attack_names",
     "pgd,deepfool"),
    ([*_CLS, "--overshoot", "0.5"], "overshoot", 0.5),
    ([*_CLS, "--init_tries", "3"], "init_tries", 3),
    ([*_CLS, "--spherical_step", "0.2"], "spherical_step", 0.2),
    ([*_CLS, "--source_step", "0.2"], "source_step", 0.2),
    ([*_CLS, "--num_category", "10"], "num_category", 10),
    ([*_CLS, "--no_normals"], "no_normals", True),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_cls_flags_are_taken(flags, name, value):
    args = bench_cli._parser().parse_args(flags)
    bench_cli._refuse_unported(args)
    bench_cli._check_task(args)
    assert getattr(args, name) == value


@pytest.mark.parametrize("flags,message", [
    (["--task", "cls"], "pointnet2 is a semseg model; pass --task semseg"),
    (["--model", "pointnet2_cls"], "pointnet2_cls is a classification model; pass --task cls"),
    (["--attack_name", "deepfool"], "deepfool need one decision per shape"),
    (["--mode", "worstcase", "--attack_names", "pgd,boundary"],
     "boundary need one decision per shape"),
    ([*_CLS, "--attack_name", "deepfool", "--goal", "t"], "untargeted by construction"),
    ([*_CLS, "--attack_name", "evolutionary", "--goal", "tm"], "meaningless"),
])
def test_task_checks_stop_the_run(flags, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        bench_cli.main(["--device", "cpu", "--log_dir", str(tmp_path), *flags])


def test_batch_coverage(ssg, capsys):
    with pytest.raises(SystemExit, match="exceeds the 8 available blocks"):
        _bench(ssg, "--mode", "prediction", "--batch_size", "16")
    ys, _, _ = _bench(ssg, "--mode", "prediction", "--batch_size", "3")
    assert "benchmarking 6 of 8 blocks" in capsys.readouterr().err and len(ys) == 6


def test_cuda_device_without_a_card_raises(ssg):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_cli.main(["--data_root", ssg["data"], "--log_dir", ssg["log"], "--mode",
                        "prediction"])
