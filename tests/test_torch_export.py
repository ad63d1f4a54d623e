"""Serving artifacts of the port (``utils/export.py``, ``cli/export.py``),
mirroring ``tests/test_export.py``, and against the JAX package's.

The exported program must give the live model's outputs after a save →
load round trip, take the weights as arguments (never constants), run in a
process that imports no model code, and keep the kernels as custom-op
nodes; the CLI must write a loadable artifact from a port checkpoint. For
all eleven models at small widths, the same seeded weights (the port's,
carried to flax through ``utils/convert.py`` by ``flax_variables``)
exported by both packages give the same outputs on the same numpy-seeded
probe, within the 1e-4 of the models' parity tests, and the same
``params.npz``, key for key.
"""

import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from pointsecguard_tpu import models as jmodels
from pointsecguard_tpu.utils import export as jexport
from pointsecguard_tpu_torch import models
from pointsecguard_tpu_torch.cli import export as export_cli
from pointsecguard_tpu_torch.models import init_parameters
from pointsecguard_tpu_torch.models.common import BatchNorm
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.export import (
    export_forward,
    flax_variables,
    load_artifact,
    save_artifact,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 2, 128
PARITY_ATOL = 1e-4  # the models' own parity tests (tests/test_torch_pointnet2.py, ...)
RANDLA = dict(d_out=(4, 8, 16, 32, 64))
RANDLA_PYRAMID = dict(num_layers=5, k=4, sub_ratios=(2, 2, 2, 2, 2))
RESGCN = dict(n_blocks=4, n_filters=8, k=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# name (a cli.export --model) → (port constructor, JAX constructor, input
# channels, takes the category one-hot)
CASES = {
    "pointnet2": (models.PointNet2SemSegSSG, jmodels.PointNet2SemSegSSG, 9, False),
    "pointnet2_msg": (models.PointNet2SemSegMSG, jmodels.PointNet2SemSegMSG, 9, False),
    "pointnet": (models.PointNetSemSeg, jmodels.PointNetSemSeg, 9, False),
    "pointnet2_cls": (functools.partial(models.PointNet2ClsSSG, num_classes=5),
                      functools.partial(jmodels.PointNet2ClsSSG, num_classes=5), 6, False),
    "pointnet2_cls_msg": (functools.partial(models.PointNet2ClsMSG, num_classes=5),
                          functools.partial(jmodels.PointNet2ClsMSG, num_classes=5), 6, False),
    "pointnet_cls": (functools.partial(models.PointNetCls, num_classes=5),
                     functools.partial(jmodels.PointNetCls, num_classes=5), 6, False),
    "pointnet2_part_seg": (models.PointNet2PartSegSSG, jmodels.PointNet2PartSegSSG, 3, True),
    "pointnet2_part_seg_msg": (models.PointNet2PartSegMSG, jmodels.PointNet2PartSegMSG,
                               3, True),
    "pointnet_part_seg": (functools.partial(models.PointNetPartSeg, normal_channel=False),
                          functools.partial(jmodels.PointNetPartSeg, normal_channel=False),
                          3, True),
    "randla": (functools.partial(models.RandLANet, **RANDLA),
               functools.partial(jmodels.RandLANet, **RANDLA), 6, False),
    "resgcn": (functools.partial(models.DenseDeepGCN, **RESGCN),
               functools.partial(jmodels.DenseDeepGCN, stochastic=False, **RESGCN), 9, False),
}
NAMES = sorted(CASES)


def _port_call(name):
    """The served forward of ``cli.export`` at the cases' small widths."""
    if name == "randla":
        return lambda m, f: m(f, models.build_pyramid(f[..., :3], **RANDLA_PYRAMID))
    if name == "resgcn":
        return lambda m, p: m(p)
    if CASES[name][3]:
        return lambda m, p, label: m(p, label)[0]
    return lambda m, p: m(p)[0]


def _jax_apply(name, model):
    if name == "randla":
        from pointsecguard_tpu.models import build_pyramid

        return lambda v, f: model.apply(v, f, build_pyramid(f[..., :3], **RANDLA_PYRAMID))
    if name == "resgcn":
        return lambda v, p: model.apply(v, p)
    if CASES[name][3]:
        return lambda v, p, label: model.apply(v, p, label)[0]
    return lambda v, p: model.apply(v, p)[0]


def _inputs(name: str, seed: int) -> list[np.ndarray]:
    """Points [B, N, C] (and the part-seg one-hot [B, 16]) from a seed."""
    rng = np.random.default_rng(seed)
    out = [(rng.normal(size=(B, N, CASES[name][2])) * 0.3).astype(np.float32)]
    if CASES[name][3]:
        out.append(np.eye(16, dtype=np.float32)[rng.integers(0, 16, B)])
    return out


@functools.lru_cache(maxsize=None)
def _state(name: str) -> dict:
    """The port's initialisation with every BatchNorm's parameters and
    statistics drawn from the seed, so that no layer is the identity."""
    model = CASES[name][0]()
    init_parameters(model, torch.Generator().manual_seed(0),
                    scale=2.0 if name == "resgcn" else 1.0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.mean.shape[0]
                mod.scale.copy_(torch.rand(n, generator=gen) + 0.5)
                mod.bias.copy_(torch.rand(n, generator=gen) - 0.5)
                mod.mean.copy_(torch.rand(n, generator=gen) - 0.5)
                mod.var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
    return model.state_dict()


def _port_model(name: str):
    model = CASES[name][0]()
    model.load_state_dict(_state(name))
    return model.eval()


def _port_artifact(name: str, path: str):
    model = _port_model(name)
    example = tuple(torch.from_numpy(x) for x in _inputs(name, 0))
    exported = export_forward(model, example, _port_call(name))
    save_artifact(path, exported, model.state_dict(),
                  {"model": name, "platforms": ["cpu"], "checkpoint_step": 0,
                   "precision": "float32"})
    return model, exported


# --- the round trip (tests/test_export.py's TestExportRoundTrip) -------------

def test_pointnet2_artifact_matches_live_model(tmp_path):
    art = str(tmp_path / "art")
    model, exported = _port_artifact("pointnet2", art)
    assert sorted(os.listdir(art)) == ["forward.pt2", "meta.json", "params.npz"]
    forward, meta = load_artifact(art, "cpu")
    assert meta["model"] == "pointnet2" and meta["platforms"] == ["cpu"]
    assert meta["in_avals"] == [f"float32[{B},{N},9]"]
    probe = torch.from_numpy(_inputs("pointnet2", 9)[0])
    with torch.no_grad():
        want = model(probe)[0]
    torch.testing.assert_close(forward(probe), want, rtol=0, atol=1e-5)
    # the program holds no weight: every parameter and statistic is an input
    assert not exported.state_dict and not exported.constants


def test_params_are_arguments_not_constants(tmp_path):
    """Serving different weights through the same program changes the
    output: the weights ride as arguments."""
    model = _port_model("pointnet")
    pts = torch.from_numpy(_inputs("pointnet", 1)[0])
    exported = export_forward(model, (pts,), _port_call("pointnet"))
    program = exported.module()
    s1 = {k: v.clone() for k, v in model.state_dict().items()}
    s2 = {k: v + 0.05 for k, v in s1.items()}
    with torch.no_grad():
        o1, o2 = program(s1, pts), program(s2, pts)
    torch.testing.assert_close(o1, model(pts)[0], rtol=0, atol=0)
    assert float((o1 - o2).abs().max()) > 1e-4


def test_partseg_two_input_artifact(tmp_path):
    art = str(tmp_path / "art_part")
    model, _ = _port_artifact("pointnet2_part_seg", art)
    forward, meta = load_artifact(art, "cpu")
    assert meta["in_avals"] == [f"float32[{B},{N},3]", f"float32[{B},16]"]
    pts, onehot = (torch.from_numpy(x) for x in _inputs("pointnet2_part_seg", 5))
    with torch.no_grad():
        want = model(pts, onehot)[0]
    torch.testing.assert_close(forward(pts, onehot), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,kernels", [
    ("pointnet2", {"psg.fps.default": 4, "psg.bottom_k.default": 8}),
    ("randla", {"psg.knn.default": 10}),
    ("resgcn", {"psg.knn.default": 4}),
    ("pointnet2_cls", {"psg.fps.default": 2, "psg.bottom_k.default": 1}),
    ("pointnet", {}),
])
def test_graph_holds_the_kernel_ops(tmp_path, name, kernels):
    """The kernels stay custom-op nodes of the program, one per launch of
    a forward (the live forward's counts: SSG 4 FPS + 8 bottom-k, RandLA's
    pyramid 10 kNN, ResGCN one kNN per graph, the PointNets none)."""
    _port_artifact(name, str(tmp_path / "art"))
    program = torch.export.load(str(tmp_path / "art" / "forward.pt2"))
    found: dict[str, int] = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("psg."):
            found[str(node.target)] = found.get(str(node.target), 0) + 1
    assert found == kernels


def test_load_artifact_imports_no_model_code(tmp_path):
    """A serving process: load and run the artifact with nothing of the
    port's models imported, and the same outputs as the live model."""
    art = str(tmp_path / "art")
    model, _ = _port_artifact("pointnet2", art)
    probe = _inputs("pointnet2", 3)[0]
    np.save(tmp_path / "probe.npy", probe)
    script = (
        "import sys, numpy as np, torch\n"
        "from pointsecguard_tpu_torch.utils.export import load_artifact\n"
        f"forward, meta = load_artifact({art!r}, 'cpu')\n"
        f"out = forward(torch.from_numpy(np.load({str(tmp_path / 'probe.npy')!r})))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "loaded = sorted(m for m in sys.modules if m.startswith('pointsecguard_tpu'))\n"
        "print(','.join(loaded))\n")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300, check=True)
    loaded = run.stdout.strip().splitlines()[-1].split(",")
    assert "pointsecguard_tpu_torch.utils.export" in loaded
    assert not [m for m in loaded if m.startswith(("pointsecguard_tpu_torch.models",
                                                   "pointsecguard_tpu."))]
    with torch.no_grad():
        want = model(torch.from_numpy(probe))[0].numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


# --- the CLI (tests/test_export.py's TestExportCLI) ---------------------------

def _checkpoint(tmp_path, name: str, **kwargs) -> str:
    args = export_cli._parser().parse_args(["--model", name, "--output", "unused", *[
        f"--{k}={v}" for k, v in kwargs.items()]])
    model, _, _ = export_cli.served_model(args, None)
    init_parameters(model, torch.Generator().manual_seed(0))
    log = str(tmp_path / f"log_{name}")
    save_checkpoint(log, model.state_dict())
    return log


def _cli(log: str, out: str, name: str, *flags) -> str:
    return export_cli.main(["--model", name, "--log_dir", log, "--output", out,
                            "--device", "cpu", "--platforms", "cpu", "--check", *flags])


def test_cls_export_cli(tmp_path):
    log = _checkpoint(tmp_path, "pointnet2_cls")
    out = _cli(log, str(tmp_path / "artifact_cls"), "pointnet2_cls", "--num_point", "64")
    forward, meta = load_artifact(out, "cpu")
    assert meta["checkpoint_step"] is None  # best.pt keeps no epoch
    assert forward(torch.rand(1, 64, 6)).shape == (1, 40)


def test_partseg_export_cli(tmp_path):
    log = _checkpoint(tmp_path, "pointnet2_part_seg")
    out = _cli(log, str(tmp_path / "artifact_part"), "pointnet2_part_seg",
               "--num_point", "64")
    forward, _ = load_artifact(out, "cpu")
    onehot = torch.from_numpy(np.eye(16, dtype=np.float32)[[2]])
    assert forward(torch.rand(1, 64, 6), onehot).shape == (1, 64, 50)


def test_cli_writes_and_checks_artifact(tmp_path):
    log = _checkpoint(tmp_path, "pointnet")
    out = _cli(log, str(tmp_path / "artifact"), "pointnet", "--num_point", "128",
               "--precision", "bfloat16")
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert (meta["model"], meta["platforms"], meta["precision"]) == (
        "pointnet", ["cpu"], "bfloat16")
    forward, _ = load_artifact(out, "cpu")
    assert forward(torch.rand(1, 128, 9)).shape == (1, 128, 13)


def test_resgcn_export_honors_optinit_flags(tmp_path):
    """A checkpoint trained with non-default OptInit flags (conv mr, k 4)
    exports with the same architecture, and its params.npz carries the
    flax names of that conv (``MRConv_0``)."""
    flags = {"resgcn_blocks": 2, "resgcn_k": 4, "resgcn_filters": 8, "resgcn_conv": "mr"}
    log = _checkpoint(tmp_path, "resgcn", **flags)
    out = _cli(log, str(tmp_path / "artifact"), "resgcn", "--num_point", "64",
               *[f"--{k}={v}" for k, v in flags.items()])
    forward, _ = load_artifact(out, "cpu")
    assert forward(torch.rand(1, 64, 9)).shape == (1, 64, 13)
    with np.load(os.path.join(out, "params.npz")) as z:
        assert any("MRConv_0" in k for k in z.files)


def test_randla_export_cli_builds_the_pyramid_inside(tmp_path):
    log = _checkpoint(tmp_path, "randla")
    out = _cli(log, str(tmp_path / "artifact"), "randla", "--randla_points", "1024")
    forward, meta = load_artifact(out, "cpu")
    assert meta["in_avals"] == ["float32[1,1024,6]"]
    assert forward(torch.rand(1, 1024, 6)).shape == (1, 1024, 13)


# cli.export flags of each model at a CPU test's size
CLI_SIZES = {**{m: ["--num_point", "128"] for m in ("pointnet2", "pointnet2_msg", "pointnet")},
             **{m: ["--num_point", "64"] for m in export_cli.MODELS if "cls" in m or "part" in m},
             "randla": ["--randla_points", "1024"],
             "resgcn": ["--num_point", "128", "--resgcn_blocks", "3", "--resgcn_filters", "8",
                        "--resgcn_k", "4"]}


@pytest.mark.parametrize("name", export_cli.MODELS)
def test_cli_check_every_model(tmp_path, name):
    """``cli.export --check`` of each of the eleven models from a port
    checkpoint: the round trip holds, and the artifact's forward has the
    JAX CLI's output shape."""
    sizes = CLI_SIZES[name]
    flags = dict(zip(sizes[2::2], sizes[3::2])) if name == "resgcn" else {}
    log = _checkpoint(tmp_path, name, **{k.lstrip("-"): v for k, v in flags.items()})
    out = _cli(log, str(tmp_path / "artifact"), name, *sizes)
    forward, meta = load_artifact(out, "cpu")
    inputs = export_cli.probes([torch.zeros(tuple(int(d) for d in a.split("[")[1][:-1].split(",")))
                                for a in meta["in_avals"]])
    classes = 40 if "cls" in name else 50 if "part" in name else 13
    n = int(meta["in_avals"][0].split(",")[1])
    want = (1, classes) if "cls" in name else (1, n, classes)
    assert tuple(forward(*inputs).shape) == want


def test_latest_checkpoint_and_its_step(tmp_path):
    """Without best.pt the CLI restores latest.pt and records its epoch."""
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

    log = _checkpoint(tmp_path, "pointnet")
    state = torch.load(os.path.join(log, "checkpoints", "best.pt"))
    os.remove(os.path.join(log, "checkpoints", "best.pt"))
    CheckpointManager(os.path.join(log, "checkpoints"), keep="latest").save(
        3, {"model": state})
    out = _cli(log, str(tmp_path / "artifact"), "pointnet", "--num_point", "64")
    assert load_artifact(out, "cpu")[1]["checkpoint_step"] == 3


@pytest.mark.parametrize("platforms,match", [
    ("tpu,cpu", "--platforms tpu"), ("tpu", "--platforms tpu"), ("gpu", "want cuda"),
    ("", "want cuda")])
def test_platforms_refused(tmp_path, platforms, match):
    with pytest.raises(SystemExit, match=match):
        export_cli.main(["--model", "pointnet", "--log_dir", str(tmp_path), "--output",
                         str(tmp_path / "a"), "--device", "cpu", "--platforms", platforms])


def test_artifact_refuses_a_platform_it_was_not_exported_for(tmp_path):
    art = str(tmp_path / "art")
    _port_artifact("pointnet", art)
    with pytest.raises(ValueError, match="exported for"):
        load_artifact(art, "cuda")


def test_no_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        _cli(str(tmp_path / "empty"), str(tmp_path / "a"), "pointnet")


# --- against the JAX package -----------------------------------------------------

def _npz_keys(path: str) -> list[str]:
    with np.load(os.path.join(path, "params.npz")) as z:
        return list(z.files)


@pytest.mark.parametrize("name", NAMES)
def test_artifact_equals_the_jax_artifact(tmp_path, name):
    """The same weights exported by both packages: outputs on the same
    numpy probe within ``PARITY_ATOL``, and equal ``params.npz`` files."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _port_artifact(name, port_dir)
    flat = flax_variables(name, _state(name))
    variables = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    apply_fn = _jax_apply(name, CASES[name][1]())
    example = tuple(jnp.asarray(x) for x in _inputs(name, 0))
    exported = jexport.export_forward(apply_fn, variables,
                                      example if len(example) > 1 else example[0],
                                      platforms=("cpu",))
    jexport.save_artifact(jax_dir, exported, variables, meta={"model": name})

    probe = _inputs(name, 11)
    jax_forward, _ = jexport.load_artifact(jax_dir)
    port_forward, meta = load_artifact(port_dir, "cpu")
    want = np.asarray(jax_forward(*(jnp.asarray(x) for x in probe)))
    got = port_forward(*(torch.from_numpy(x) for x in probe)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY_ATOL)

    with np.load(os.path.join(port_dir, "params.npz")) as p, \
            np.load(os.path.join(jax_dir, "params.npz")) as j:
        assert sorted(p.files) == sorted(j.files)
        for key in j.files:
            assert p[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    assert sorted(meta["params"]) == sorted(_npz_keys(jax_dir))
