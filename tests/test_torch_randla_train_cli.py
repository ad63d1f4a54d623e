"""The port's RandLA-Net protocol on the CPU: ``cli.train --model randla``
(checkpoint, resume, the JAX loop's clouds), ``cli.eval --model randla``
against the JAX ``_eval_randla`` on the same prepared clouds, seed and
weights, ``cli.attack --save_adv`` → ``cli.eval --adv_set``, and the flags
that stay refused.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import configs as jconfigs
from pointsecguard_tpu_torch import configs as tconfigs
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import make_synthetic_rooms, randla
from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint
from pointsecguard_tpu_torch.utils.convert import randla_from_jax_variables

EPOCHS = 3
TRAIN = ["--model", "randla", "--device", "cpu", "--randla_points", "512",
         "--batch_size", "2", "--steps_per_epoch", "4", "--val_steps", "2", "--seed", "0"]
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
def prepared(tmp_path_factory):
    """Synthetic rooms prepared at 0.2 m, as ``tests/test_cli_families.py``
    prepares them for the JAX CLI, and a second Area-5 cloud (a copy of
    the first under another name), so that eval votes over two clouds."""
    import shutil

    root = tmp_path_factory.mktemp("randla_train_cli")
    make_synthetic_rooms(str(root / "rooms"), points_per_room=4000, seed=2)
    for name in sorted(os.listdir(root / "rooms")):
        randla.prepare_room(str(root / "rooms" / name), str(root / "prep"), 0.2)
    for suffix in (".ply", "_KDTree.pkl", "_proj.pkl"):
        shutil.copy(root / "prep" / f"Area_5_synth_1{suffix}",
                    root / "prep" / f"Area_5_synth_2{suffix}")
    return root


@pytest.fixture(scope="module")
def trained(prepared):
    """The full-width model through ``cli.train`` for 3 epochs of 4 steps,
    with the batches handed to the prefetch thread recorded (its items are
    ``stack_batches`` stacks of ``--steps_per_call`` batches: each batch
    of a stack is recorded)."""
    from pointsecguard_tpu_torch.data import loader

    seen = []
    real = loader.prefetch

    def spy(iterable, *a, **kw):
        def record():
            for item in iterable:
                seen.extend(batch.copy() for batch in item[0])
                yield item
        return real(record(), *a, **kw)

    log = str(prepared / "log")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loader, "prefetch", spy)
        _, best = train_cli.main(TRAIN + ["--randla_dir", str(prepared / "prep"),
                                          "--log_dir", log, "--epochs", str(EPOCHS)])
    return {"log": log, "best_miou": best, "feats": seen}


def _events(log):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_training_writes_checkpoints_and_one_line_per_epoch(trained):
    ckdir = os.path.join(trained["log"], "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["best.pt", "latest.pt"]
    epochs = [e for e in _events(trained["log"]) if e["event"] == "epoch"]
    evals = [e for e in _events(trained["log"]) if e["event"] == "eval"]
    assert [e["epoch"] for e in epochs] == [e["epoch"] for e in evals] == list(range(EPOCHS))
    for i, e in enumerate(epochs):
        assert e["batches"] == 4 and e["nan_batches"] == 0 and np.isfinite(e["loss"])
        assert e["lr"] == pytest.approx(1e-2 * 0.95**i, rel=1e-12)  # the config's lr
    assert trained["best_miou"] == max(e["miou"] for e in evals)
    latest = CheckpointManager(ckdir).restore_latest()
    assert latest["epoch"] == EPOCHS and latest["step"] == 4 * EPOCHS
    assert latest["count"].item() == 4 * EPOCHS


def test_training_takes_the_clouds_of_the_jax_loop(trained, prepared):
    """The JAX loop spends one sampler batch on shaping its state, then
    trains on ``steps_per_epoch`` batches an epoch from the same sampler:
    the port trained on those clouds, array-equal."""
    from pointsecguard_tpu.data.randla import SpatiallyRegularSampler as JaxSampler

    sampler = JaxSampler.load(str(prepared / "prep"), split="train", num_points=512,
                              rng=np.random.default_rng(0))
    next(iter(sampler.batches(2, 1)))
    want = [f for _, f, _, _, _ in sampler.batches(2, 4 * EPOCHS)]
    assert len(trained["feats"]) == len(want)
    for got, w in zip(trained["feats"], want):
        np.testing.assert_array_equal(got, w)


def test_resume_repeats_no_epoch(trained, prepared, capfd):
    train_cli.main(TRAIN + ["--randla_dir", str(prepared / "prep"),
                            "--log_dir", trained["log"], "--epochs", str(EPOCHS + 1)])
    assert "resumed from epoch 3" in capfd.readouterr().err
    epochs = [e["epoch"] for e in _events(trained["log"]) if e["event"] == "epoch"]
    assert epochs == list(range(EPOCHS + 1))
    latest = CheckpointManager(os.path.join(trained["log"], "checkpoints")).restore_latest()
    assert latest["epoch"] == EPOCHS + 1 and latest["step"] == 4 * (EPOCHS + 1)


def test_defaults_resolve_to_the_config(prepared, tmp_path, monkeypatch):
    """--batch_size 0 → 6, --learning_rate 0 → 1e-2."""
    from pointsecguard_tpu_torch.train import schedules

    bases = []
    real = schedules.randla_lr
    monkeypatch.setattr(schedules, "randla_lr",
                        lambda epoch, **kw: bases.append(kw["base"]) or real(epoch, **kw))
    log = str(tmp_path / "log")
    train_cli.main(["--model", "randla", "--device", "cpu", "--randla_points", "512",
                    "--steps_per_epoch", "1", "--val_steps", "1", "--epochs", "1",
                    "--randla_dir", str(prepared / "prep"), "--log_dir", log])
    assert bases == [1e-2]
    latest = CheckpointManager(os.path.join(log, "checkpoints")).restore_latest()
    assert latest["step"] == 1
    assert [e["batches"] for e in _events(log) if e["event"] == "epoch"] == [1]


# --- eval against the JAX package ---------------------------------------------

@pytest.fixture(scope="module")
def jax_weights(prepared):
    """A narrow two-layer RandLA-Net initialised by the JAX package, saved
    by its own ``CheckpointManager`` and converted into the port's
    checkpoint. At initialisation every point takes one class, absent
    from the test cloud; BatchNorm statistics from one train-mode forward
    over a test sample (keep fraction 0) make the predictions vary."""
    from flax.traverse_util import unflatten_dict

    from pointsecguard_tpu.models import RandLANet as JaxRandLANet
    from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
    from pointsecguard_tpu.train import create_train_state
    from pointsecguard_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
    from pointsecguard_tpu_torch.models import RandLANet
    from pointsecguard_tpu_torch.train.trainer import randla_family
    from pointsecguard_tpu_torch.utils.convert import randla_to_jax_variables

    model = JaxRandLANet(d_out=NARROW["d_out"])
    pyramid = jax.jit(lambda x: jax_build_pyramid(
        x, num_layers=2, sub_ratios=NARROW["sub_sampling_ratio"], knn_tile=None))
    state, _ = create_train_state(model, (jnp.zeros((1, 512, 6)), None),
                                  rng=jax.random.PRNGKey(0),
                                  model_args=lambda f: (f, pyramid(f[..., :3])))
    flat = flatten_dict({"params": state.params, "batch_stats": state.batch_stats}, sep="/")
    port = RandLANet(d_out=NARROW["d_out"])
    port.load_state_dict(randla_from_jax_variables({k: np.asarray(v) for k, v in flat.items()}))
    sampler = randla.SpatiallyRegularSampler.load(str(prepared / "prep"), split="test",
                                                  num_points=512,
                                                  rng=np.random.default_rng(1))
    feats = torch.from_numpy(next(sampler.batches(2, 1))[1])
    port.train()
    with torch.no_grad():
        port(feats, randla_family(tconfigs.RandlaConfig(**NARROW)).plan(feats), momentum=0.0)
    stats = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in randla_to_jax_variables(
        port.state_dict()).items() if k.startswith("batch_stats/")}
    state = state.replace(batch_stats=unflatten_dict(stats, sep="/"))
    jlog, tlog = prepared / "jax_eval_log", prepared / "port_eval_log"
    manager = JaxCheckpointManager(str(jlog / "checkpoints"))
    manager.save(1, state, miou=0.1)
    restored, _ = manager.restore_best(state)
    flat = flatten_dict({"params": restored.params, "batch_stats": restored.batch_stats},
                        sep="/")
    save_checkpoint(str(tlog), randla_from_jax_variables(
        {k: np.asarray(v) for k, v in flat.items()}))
    return jlog, tlog


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(jconfigs, "RandlaConfig",
                        functools.partial(jconfigs.RandlaConfig, **NARROW))
    monkeypatch.setattr(tconfigs, "RandlaConfig",
                        functools.partial(tconfigs.RandlaConfig, **NARROW))


def test_eval_matches_the_jax_eval(prepared, jax_weights, narrow):
    """Voting of 6 samples of 512 points (both test clouds touched) and
    reprojection through ``_proj.pkl``: the float32 softmaxes differ in
    summation order only, so the metrics agree to 2e-3 (an argmax flip of
    a sub-cloud point moves the full-resolution scores)."""
    from pointsecguard_tpu.cli import eval as jax_eval_cli

    jlog, tlog = jax_weights
    argv = ["--model", "randla", "--randla_dir", str(prepared / "prep"),
            "--randla_points", "512", "--num_clouds", "6", "--seed", "3"]
    want = jax_eval_cli.main(argv + ["--log_dir", str(jlog)])
    got = eval_cli.main(argv + ["--log_dir", str(tlog), "--device", "cpu"])
    assert got.accuracy == pytest.approx(float(want.accuracy), abs=2e-3)
    assert got.miou == pytest.approx(float(want.miou), abs=2e-3)
    np.testing.assert_allclose(got.class_iou, np.asarray(want.class_iou), atol=5e-3)
    assert 0.0 < got.accuracy < 1.0


def test_eval_skips_clouds_never_sampled(prepared, jax_weights, narrow, capfd):
    """One sample touches one of the two test clouds: the other is skipped,
    not scored as class 0."""
    _, tlog = jax_weights
    eval_cli.main(["--model", "randla", "--device", "cpu", "--randla_dir",
                   str(prepared / "prep"), "--randla_points", "512", "--num_clouds", "1",
                   "--log_dir", str(tlog)])
    # cli.eval's basicConfig(force=True) evicts pytest's caplog handler
    assert "scored 1/2 clouds" in capfd.readouterr().err


def test_eval_falls_back_to_sub_cloud_labels_without_projection(prepared, jax_weights,
                                                                narrow, tmp_path):
    """Without ``_proj.pkl`` the sub-cloud's own labels are scored: the
    confusion then counts the sub-cloud's points."""
    import shutil

    _, tlog = jax_weights
    bare = tmp_path / "bare"
    shutil.copytree(prepared / "prep", bare)
    for name in os.listdir(bare):
        if name.endswith("_proj.pkl"):
            os.remove(bare / name)
    argv = ["--model", "randla", "--device", "cpu", "--randla_points", "512",
            "--num_clouds", "6", "--log_dir", str(tlog)]
    full = eval_cli.main(argv + ["--randla_dir", str(prepared / "prep")])
    sub = eval_cli.main(argv + ["--randla_dir", str(bare)])
    assert 0.0 < sub.accuracy < 1.0 and sub.accuracy != full.accuracy


def test_save_adv_then_eval_adv_set(prepared, jax_weights, narrow):
    """``--save_adv`` writes what ``--adv_set`` reads: the same checkpoint
    on the saved clouds gives the attack run's adversarial accuracy."""
    _, tlog = jax_weights
    clean_m, adv_m = attack_cli.main([
        "--model", "randla", "--attack", "nb", "--device", "cpu", "--save_adv",
        "--randla_dir", str(prepared / "prep"), "--randla_points", "512",
        "--num_clouds", "4", "--batch_size", "2", "--log_dir", str(tlog)])
    path = tlog / "randla_nb_adv_area5.npz"
    with np.load(path) as npz:
        assert npz["points"].shape == (4, 512, 6) and npz["labels"].shape == (4, 512)
        assert npz["points"].dtype == np.float32 and npz["labels"].dtype == np.int32
    m = eval_cli.main(["--model", "randla", "--device", "cpu", "--log_dir", str(tlog),
                       "--adv_set", str(path), "--batch_size", "2"])
    assert m.accuracy == pytest.approx(adv_m.accuracy, abs=1e-6)
    assert m.miou == pytest.approx(adv_m.miou, abs=1e-6)


@pytest.mark.parametrize("cli,flags", [
    (train_cli, ["--randla_dataset", "semantickitti"]),
    (eval_cli, ["--randla_dataset", "semantickitti"]),
], ids=["train --randla_dataset", "eval --randla_dataset"])
def test_randla_flags_still_refused(cli, flags):
    """Kept under its name from before the flag was ported; it now holds
    that ``--randla_dataset`` is parsed and refused by nothing
    (tests/test_torch_randla_presets_cli.py trains and evaluates both
    outdoor presets)."""
    args = cli._parser().parse_args(["--model", "randla", "--device", "cpu"] + flags)
    cli._refuse_unported(args)
    assert args.randla_dataset == flags[1]
