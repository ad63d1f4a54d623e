"""The weighted ensemble victim of the port against the JAX package, on
the CPU: ``models/registry.py:ensemble_outputs_fn`` in both modes,
``cli.attack --ensemble`` / ``--ensemble_mode`` with a PointNet++ SSG
primary (the trained fixture) and a PointNet member (JAX-initialised
weights) on 128-point blocks, the self-ensemble, the defense around the
mixture, and the refusals in the JAX driver's words."""

import argparse
import inspect
import logging
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu.cli import _attack_blocks as jax_blocks
from pointsecguard_tpu.cli import attack as jax_attack_cli
from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
from pointsecguard_tpu.models import PointNetSemSeg as JaxPointNet
from pointsecguard_tpu.models import build_geometry as jax_build_geometry
from pointsecguard_tpu.models import registry as jax_registry
from pointsecguard_tpu_torch.cli import _attack_blocks
from pointsecguard_tpu_torch.cli import _attack_common
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks, make_synthetic_rooms
from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, PointNetSemSeg
from pointsecguard_tpu_torch.models import registry
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import from_jax_variables, pointnet_from_jax_variables

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("mode", ["probs", "log_probs"])
def test_ensemble_outputs_fn_matches_jax(mode):
    """Three members' logits, unequal weights (normalised to sum 1)."""
    rng = np.random.default_rng(0)
    outs = [rng.standard_normal((2, 32, 13)).astype(np.float32) * s for s in (1.0, 3.0, 0.3)]
    weights = [1.0, 0.5, 2.0]
    jfns = [lambda p, o=o: jnp.asarray(o) + 0 * p[..., :1] for o in outs]
    tfns = [lambda p, o=o: torch.from_numpy(o) + 0 * p[..., :1] for o in outs]
    pts = np.zeros((2, 32, 9), np.float32)
    want = jax_registry.ensemble_outputs_fn(jfns, weights, mode=mode)(jnp.asarray(pts))
    got = registry.ensemble_outputs_fn(tfns, weights, mode=mode)(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # equal weights: the unweighted softmax-space mean
    np.testing.assert_allclose(
        registry.ensemble_outputs([torch.from_numpy(o) for o in outs]).numpy(),
        np.asarray(jax_registry.ensemble_outputs([jnp.asarray(o) for o in outs])), atol=1e-6)
    with pytest.raises(ValueError, match="2 weights"):
        registry.ensemble_outputs_fn(tfns, weights[:2])
    with pytest.raises(ValueError, match="unknown ensemble mode"):
        registry.ensemble_outputs_fn(tfns, mode="bogus")(torch.from_numpy(pts))


@pytest.fixture(scope="module")
def victims(tmp_path_factory):
    """Synthetic rooms; the trained SSG fixture and a JAX-initialised
    PointNet (PRNGKey(7)) as the port's checkpoints; both JAX models."""
    root = tmp_path_factory.mktemp("ensemble")
    data = str(root / "data")
    make_synthetic_rooms(data, points_per_room=6000, seed=0)
    with open(os.path.join(FIXDIR, "trained_pointnet2.msgpack"), "rb") as f:
        ssg_vars = flax.serialization.msgpack_restore(f.read())
    ssg = PointNet2SemSegSSG()
    ssg.load_state_dict(from_jax_variables(_flat(ssg_vars)))
    pn_vars = jax.jit(JaxPointNet().init)(jax.random.PRNGKey(7), jnp.zeros((1, 64, 9)))
    pn = PointNetSemSeg()
    pn.load_state_dict(pointnet_from_jax_variables(_flat(pn_vars)))
    logs = {"ssg": str(root / "ssg"), "pn": str(root / "pn")}
    save_checkpoint(logs["ssg"], ssg.state_dict())
    save_checkpoint(logs["pn"], pn.state_dict())
    rooms = RoomSet.load(data, "test", 5)
    feats, labs, _, _ = WholeSceneBlocks(rooms, block_points=128).room_blocks(
        0, np.random.default_rng(0))
    return {"data": data, "logs": logs, "root": root, "ssg_vars": ssg_vars,
            "pn_vars": pn_vars, "feats": feats[:8], "labels": labs[:8]}


_MODEL = {"ssg": "pointnet2", "pn": "pointnet"}


def _run(victims, primary, *flags, attack="nb"):
    """``cli.attack`` on one batch of 8 blocks with the ``primary`` victim
    (``ssg`` | ``pn``): its result and TSV rows."""
    log, model = victims["logs"][primary], _MODEL[primary]
    out = attack_cli.main(["--device", "cpu", "--model", model, "--attack", attack,
                           "--data_root", victims["data"], "--log_dir", log,
                           "--num_point", "128", "--batch_size", "8", "--max_blocks", "8",
                           *flags])
    with open(os.path.join(log, f"{model}_{attack}_area5.tsv")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    return out, rows


def _jax_mixture(victims, members, weights, mode="probs"):
    """The JAX package's mixture of ``members`` (``ssg`` with its geometry,
    ``pn``) on the fixture's blocks."""
    ssg, pn = JaxSSG(), JaxPointNet()

    def run(p):
        geo = jax_build_geometry(p[..., :3])
        fns = {"ssg": lambda q: ssg.apply(victims["ssg_vars"], q, geometry=geo)[0],
               "pn": lambda q: pn.apply(victims["pn_vars"], q)[0]}
        return jax_registry.ensemble_outputs_fn([fns[m] for m in members], weights,
                                                mode=mode)(p)

    return np.asarray(jax.jit(run)(jnp.asarray(victims["feats"])))


def test_ensemble_clean_predictions_match_jax(victims):
    """The clean mixture's per-block accuracy in the TSV, and the port's
    closures' predictions, equal the JAX mixture's argmax (members' weights
    1 and 0.5)."""
    spec = f"pointnet:{victims['logs']['pn']}:0.5"
    out = _jax_mixture(victims, ["ssg", "pn"], [1.0, 0.5])
    want = out.argmax(-1)
    top2 = np.sort(out, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5  # no near-tie of the mixture
    assert clear.mean() > 0.99
    args = argparse.Namespace(ensemble=[spec], ensemble_mode="probs", model="pointnet2")
    model, family = _attack_blocks.load_block_model("pointnet2", victims["logs"]["ssg"], args,
                                                    torch.device("cpu"))
    make = _attack_blocks.member_factory(model, family)
    closures = _attack_blocks.ensemble_closures(
        args, torch.device("cpu"), lambda p, attack: (make(p), make(p) if attack else None),
        logging.getLogger("test"))
    pts = torch.from_numpy(victims["feats"])
    f_eval, f_atk = closures(pts, True)
    with torch.no_grad():
        got = f_eval(pts)
    np.testing.assert_allclose(got.numpy(), out, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy()[clear], want[clear])
    # the clean column does not depend on the attack: --attack random skips the engine
    _, rows = _run(victims, "ssg", "--ensemble", spec, attack="random")
    labels = victims["labels"]
    for b, r in enumerate(rows):
        assert r[2] == f"{(want[b] == labels[b]).mean():.4f}"


def test_self_ensemble_reproduces_the_single_model(victims):
    """A self-ensemble (the same PointNet checkpoint twice): the mixture of
    equal members predicts exactly like the single model (JAX
    tests/test_cli_e2e.py:184), under either attack objective."""
    (clean_s, adv_s), _ = _run(victims, "pn")
    for mode in ("probs", "log_probs"):
        (clean_e, adv_e), rows = _run(victims, "pn", "--ensemble",
                                      f"pointnet:{victims['logs']['pn']}",
                                      "--ensemble_mode", mode)
        assert float(clean_e.accuracy) == float(clean_s.accuracy)
        assert float(clean_e.miou) == float(clean_s.miou)
        assert float(adv_e.accuracy) == pytest.approx(float(adv_s.accuracy), abs=0.05)
        assert len(rows) == 8


def test_defense_wraps_the_mixture(victims, monkeypatch):
    """``--defense`` wraps the ensemble's closures, not its members: the
    wrappers receive the mixture (eval: ``probs``; attack: the mode's),
    equal to the JAX mixture of the same members."""
    seen = []
    real = _attack_common.defense_wrapper

    def spy(args):
        eval_wrap, attack_wrap = real(args)

        def wrap(kind, inner):
            def outer(f):
                seen.append((kind, f))
                return inner(f)
            return outer

        return wrap("eval", eval_wrap), wrap("attack", attack_wrap)

    monkeypatch.setattr(_attack_common, "defense_wrapper", spy)
    _run(victims, "pn", "--ensemble", f"pointnet:{victims['logs']['pn']}:0.5",
         "--ensemble_mode", "log_probs", "--defense", "bit_depth")
    assert {k for k, _ in seen} == {"eval", "attack"}
    assert all(f.__qualname__ == "ensemble_outputs_fn.<locals>.combined" for _, f in seen)
    pts = torch.from_numpy(victims["feats"])
    want = {"eval": _jax_mixture(victims, ["pn", "pn"], [1.0, 0.5], "probs"),
            "attack": _jax_mixture(victims, ["pn", "pn"], [1.0, 0.5], "log_probs")}
    for kind, f in seen:
        with torch.no_grad():
            np.testing.assert_allclose(f(pts).numpy(), want[kind], atol=1e-4)


def _jax_source_has(message):
    src = inspect.getsource(jax_blocks) + inspect.getsource(jax_attack_cli)
    flat = " ".join(src.replace('"\n', "").replace('"', "").split())
    return " ".join(message.split()) in flat


@pytest.mark.parametrize("flags,message,jax_text", [
    (["--ensemble", "pointnet"], "--ensemble expects MODEL:LOG_DIR[:WEIGHT], got 'pointnet'",
     "--ensemble expects MODEL:LOG_DIR[:WEIGHT], got"),
    (["--ensemble", "a:b:c:d"], "--ensemble expects MODEL:LOG_DIR[:WEIGHT], got 'a:b:c:d'",
     "--ensemble expects MODEL:LOG_DIR[:WEIGHT], got"),
    (["--ensemble", "randla:log"],
     "--ensemble member 'randla' is not a block-family model "
     "(pointnet2/pointnet2_msg/pointnet/resgcn)",
     "--ensemble member '{m_name}' is not a block-family model "
     "(pointnet2/pointnet2_msg/pointnet/resgcn)"),
    (["--model", "randla", "--ensemble", "pointnet2:log"],
     "--ensemble is a block-family feature (members share the [B,N,9] block input; "
     "RandLA clouds have a different contract)", None),
])
def test_bad_ensembles_are_refused_as_in_jax(flags, message, jax_text, tmp_path):
    """Before any checkpoint is read, with the JAX driver's message."""
    with pytest.raises(SystemExit) as got:
        attack_cli.main(["--device", "cpu", "--log_dir", str(tmp_path / "none"), *flags])
    assert str(got.value) == message
    assert _jax_source_has(jax_text or message)
