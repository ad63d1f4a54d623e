"""``cli.import_ckpt`` of the port and its maps (``utils/importers.py``)
against the JAX package's importer, on the CPU.

The reference ships no trained weights, so the test builds state dicts
with the reference's key schema from standard torch layers (as
``tests/test_importers.py`` does) and a ``{tf_variable_name: array}``
RandLA dump. For all eleven ``--model`` choices the port's state dict
equals, leaf for leaf, the JAX importer's flax tree carried through
``utils/convert.py``; a missing or unmatched key raises; the CLI writes a
checkpoint that ``cli.eval --device cpu`` restores.
"""

import os

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch import nn

from pointsecguard_tpu.utils import importers as jimporters
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import import_ckpt
from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.utils import convert, importers
from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

RESGCN_BLOCKS, RESGCN_FILTERS = 3, 16
RANDLA_D_OUT = (4, 8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mlp(cin, outs, conv=nn.Conv2d, bn=nn.BatchNorm2d):
    """`pointnet_util.py:166-178,270-280` schema: mlp_convs / mlp_bns."""
    m = nn.Module()
    m.mlp_convs, m.mlp_bns = nn.ModuleList(), nn.ModuleList()
    for o in outs:
        m.mlp_convs.append(conv(cin, o, 1))
        m.mlp_bns.append(bn(o))
        cin = o
    return m


def _fp(cin, outs):
    return _mlp(cin, outs, nn.Conv1d, nn.BatchNorm1d)


def _msg(cin, mlps):
    """`pointnet_util.py:210-232` schema: per-scale conv_blocks / bn_blocks,
    each scale's first conv on cin + 3 relative coordinates."""
    m = nn.Module()
    m.conv_blocks, m.bn_blocks = nn.ModuleList(), nn.ModuleList()
    for mlp in mlps:
        s = _mlp(cin + 3, mlp)
        m.conv_blocks.append(s.mlp_convs)
        m.bn_blocks.append(s.mlp_bns)
    return m


def _stn(cin, k):
    """`pointnet.py:10-85` STN3d / STNkd schema."""
    m = nn.Module()
    for i, (a, b) in enumerate(((cin, 64), (64, 128), (128, 1024))):
        setattr(m, f"conv{i + 1}", nn.Conv1d(a, b, 1))
        setattr(m, f"bn{i + 1}", nn.BatchNorm1d(b))
    m.fc1, m.fc2, m.fc3 = nn.Linear(1024, 512), nn.Linear(512, 256), nn.Linear(256, k * k)
    m.bn4, m.bn5 = nn.BatchNorm1d(512), nn.BatchNorm1d(256)
    return m


def _encoder(channel):
    """`pointnet.py:88-101` PointNetEncoder schema."""
    m = nn.Module()
    m.stn, m.fstn = _stn(channel, 3), _stn(64, 64)
    for i, (a, b) in enumerate(((channel, 64), (64, 128), (128, 1024))):
        setattr(m, f"conv{i + 1}", nn.Conv1d(a, b, 1))
        setattr(m, f"bn{i + 1}", nn.BatchNorm1d(b))
    return m


def _head(m, widths, names=("conv", "bn")):
    """1×1 convs along ``widths``, each but the last with its BatchNorm."""
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        setattr(m, f"{names[0]}{i + 1}", nn.Conv1d(a, b, 1))
        if i < len(widths) - 2:
            setattr(m, f"{names[1]}{i + 1}", nn.BatchNorm1d(b))


def _cls_head(m, k=40):
    m.fc1, m.bn1 = nn.Linear(1024, 512), nn.BatchNorm1d(512)
    m.fc2, m.bn2 = nn.Linear(512, 256), nn.BatchNorm1d(256)
    m.fc3 = nn.Linear(256, k)


def _basic(cin, cout, norm=True):
    """ResGCN's BasicConv: an nn.Sequential of [Conv2d, act, BN]."""
    mods = [nn.Conv2d(cin, cout, 1)]
    if norm:
        mods += [nn.ReLU(), nn.BatchNorm2d(cout)]
    return nn.Sequential(*mods)


def _gconv(cin, cout):
    g = nn.Module()
    g.gconv = nn.Module()
    g.gconv.nn = _basic(2 * cin, cout)
    return g


def _reference(model: str) -> nn.Module:
    """A module with the reference's parameter schema for ``model``."""
    m = nn.Module()
    if model == "pointnet2":
        for k, (cin, outs) in enumerate(((12, (32, 32, 64)), (67, (64, 64, 128)),
                                         (131, (128, 128, 256)), (259, (256, 256, 512)))):
            setattr(m, f"sa{k + 1}", _mlp(cin, outs))
        for name, cin, outs in (("fp4", 768, (256, 256)), ("fp3", 384, (256, 256)),
                                ("fp2", 320, (256, 128)), ("fp1", 128, (128, 128, 128))):
            setattr(m, name, _fp(cin, outs))
        _head(m, (128, 128, 13))
    elif model == "pointnet2_msg":
        m.sa1 = _msg(9, ((16, 16, 32), (32, 32, 64)))
        m.sa2 = _msg(96, ((64, 64, 128), (64, 96, 128)))
        m.sa3 = _msg(256, ((128, 196, 256), (128, 196, 256)))
        m.sa4 = _msg(512, ((256, 256, 512), (256, 384, 512)))
        for name, cin, outs in (("fp4", 1536, (256, 256)), ("fp3", 512, (256, 256)),
                                ("fp2", 352, (256, 128)), ("fp1", 128, (128, 128, 128))):
            setattr(m, name, _fp(cin, outs))
        _head(m, (128, 128, 13))
    elif model == "pointnet":
        m.feat = _encoder(6)
        _head(m, (1088, 512, 256, 128, 13))
    elif model == "pointnet_cls":
        m.feat = _encoder(6)
        _cls_head(m)
    elif model == "pointnet_part_seg":
        m.stn, m.fstn = _stn(6, 3), _stn(128, 128)
        for i, (a, b) in enumerate(((6, 64), (64, 128), (128, 128), (128, 512),
                                    (512, 2048))):
            setattr(m, f"conv{i + 1}", nn.Conv1d(a, b, 1))
            setattr(m, f"bn{i + 1}", nn.BatchNorm1d(b))
        _head(m, (4944, 256, 256, 128, 50), names=("convs", "bns"))
    elif model == "pointnet2_cls_ssg":
        m.sa1, m.sa2 = _mlp(6, (64, 64, 128)), _mlp(131, (128, 128, 256))
        m.sa3 = _mlp(259, (256, 512, 1024))
        _cls_head(m)
    elif model == "pointnet2_cls_msg":
        m.sa1 = _msg(3, ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
        m.sa2 = _msg(320, ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
        m.sa3 = _mlp(643, (256, 512, 1024))
        _cls_head(m)
    elif model == "pointnet2_part_seg_ssg":
        m.sa1, m.sa2 = _mlp(9, (64, 64, 128)), _mlp(131, (128, 128, 256))
        m.sa3 = _mlp(259, (256, 512, 1024))
        m.fp3, m.fp2 = _fp(1280, (256, 256)), _fp(384, (256, 128))
        m.fp1 = _fp(128 + 16 + 6 + 3, (128, 128, 128))
        _head(m, (128, 128, 50))
    elif model == "pointnet2_part_seg_msg":
        m.sa1 = _msg(3, ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
        m.sa2 = _msg(320, ((128, 128, 256), (128, 196, 256)))
        m.sa3 = _mlp(515, (256, 512, 1024))
        m.fp3, m.fp2 = _fp(1536, (256, 256)), _fp(576, (256, 128))
        m.fp1 = _fp(128 + 16 + 3 + 3, (128, 128))
        _head(m, (128, 128, 50))
    elif model == "resgcn":
        c = RESGCN_FILTERS
        m.head = _gconv(9, c)
        body = []
        for _ in range(RESGCN_BLOCKS - 1):
            blk = nn.Module()
            blk.body = _gconv(c, c)
            body.append(blk)
        m.backbone = nn.Sequential(*body)
        fused = c * RESGCN_BLOCKS
        m.fusion_block = _basic(fused, 1024)
        m.prediction = nn.Sequential(_basic(fused + 1024, 512), _basic(512, 256),
                                     nn.Dropout(), _basic(256, 13, norm=False))
    else:
        raise ValueError(model)
    gen = torch.Generator().manual_seed(len(model))
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
                mod.running_mean.normal_(generator=gen)
                mod.running_var.uniform_(0.5, 2.0, generator=gen)
                mod.weight.normal_(generator=gen)
                mod.bias.normal_(generator=gen)
    return m


def _randla_arrays(rng, d_in=6, num_classes=13, d_out=RANDLA_D_OUT):
    """A {tf_var_name: array} dict with the fork's variable schema
    (`RandLANet.py:150-190,323-344,398-410`, `helper_tf_util.py:115-212`):
    conv2d kernels [1, 1, in, out], conv2d_transpose kernels reversed
    [1, 1, out, in], every conv with bn owns an unnamed BN scope; plus
    Adam slots and bookkeeping scalars, which the map skips."""
    names = {}

    def dense(scope, cin, cout, bias=True):
        names[f"{scope}/kernel"] = rng.standard_normal((cin, cout)).astype(np.float32)
        if bias:
            names[f"{scope}/bias"] = rng.standard_normal(cout).astype(np.float32)

    def bn(scope, c):
        pre = f"{scope}/" if scope else ""
        names[f"{pre}batch_normalization/gamma"] = rng.random(c).astype(np.float32) + 0.5
        names[f"{pre}batch_normalization/beta"] = rng.standard_normal(c).astype(np.float32)
        names[f"{pre}batch_normalization/moving_mean"] = (
            rng.standard_normal(c).astype(np.float32))
        names[f"{pre}batch_normalization/moving_variance"] = (
            rng.random(c).astype(np.float32) + 0.5)

    def conv(scope, cin, cout, with_bn=True, transpose=False):
        shape = (1, 1, cout, cin) if transpose else (1, 1, cin, cout)
        names[f"{scope}/weights"] = rng.standard_normal(shape).astype(np.float32)
        names[f"{scope}/biases"] = rng.standard_normal(cout).astype(np.float32)
        if with_bn:
            bn(scope, cout)

    dense("fc0", d_in, 8)
    bn("", 8)
    f_in = 8
    for i, d in enumerate(d_out):
        e = f"Encoder_layer_{i}"
        conv(f"{e}mlp1", f_in, d // 2)
        conv(f"{e}LFAmlp1", 10, d // 2)
        dense(f"{e}LFAatt_pooling_1fc", d, d, bias=False)
        conv(f"{e}LFAatt_pooling_1mlp", d, d // 2)
        conv(f"{e}LFAmlp2", d // 2, d // 2)
        dense(f"{e}LFAatt_pooling_2fc", d, d, bias=False)
        conv(f"{e}LFAatt_pooling_2mlp", d, d)
        conv(f"{e}mlp2", d, 2 * d)
        conv(f"{e}shortcut", f_in, 2 * d)
        f_in = 2 * d
    enc = [2 * d_out[0]] + [2 * d for d in d_out]
    conv("decoder_0", enc[-1], enc[-1])
    f = enc[-1]
    for j in range(len(d_out)):
        conv(f"Decoder_layer_{j}", enc[-j - 2] + f, enc[-j - 2], transpose=True)
        f = enc[-j - 2]
    conv("fc1", f, 64)
    conv("fc2", 64, 32)
    conv("fc", 32, num_classes, with_bn=False)
    for k in [k for k in names if k.endswith(("kernel", "weights"))][:3]:
        names[f"{k}/Adam"] = np.zeros_like(names[k])
    names["optimizer/learning_rate"] = np.float32(0.01)
    names["beta1_power"] = np.float32(0.9)
    return names


# --model → the JAX importer call and the utils/convert.py map it feeds
_JAX = {
    "pointnet2": (jimporters.import_pointnet2_semseg, convert.from_jax_variables),
    "pointnet2_msg": (jimporters.import_pointnet2_semseg_msg,
                      convert.pointnet2_msg_from_jax_variables),
    "pointnet": (jimporters.import_pointnet_semseg, convert.pointnet_from_jax_variables),
    "pointnet_cls": (jimporters.import_pointnet_cls,
                     lambda f: convert.cls_from_jax_variables("pointnet_cls", f)),
    "pointnet_part_seg": (jimporters.import_pointnet_partseg,
                          lambda f: convert.cls_from_jax_variables("pointnet_part_seg", f)),
    "pointnet2_cls_ssg": (lambda c: jimporters.import_pointnet2_cls(c),
                          lambda f: convert.cls_from_jax_variables("pointnet2_cls", f)),
    "pointnet2_cls_msg": (lambda c: jimporters.import_pointnet2_cls(c, msg=True),
                          lambda f: convert.cls_from_jax_variables("pointnet2_cls_msg", f)),
    "pointnet2_part_seg_ssg": (
        lambda c: jimporters.import_pointnet2_partseg(c),
        lambda f: convert.cls_from_jax_variables("pointnet2_part_seg", f)),
    "pointnet2_part_seg_msg": (
        lambda c: jimporters.import_pointnet2_partseg(c, msg=True),
        lambda f: convert.cls_from_jax_variables("pointnet2_part_seg_msg", f)),
    "resgcn": (lambda c: jimporters.import_resgcn(c, n_blocks=RESGCN_BLOCKS),
               convert.resgcn_from_jax_variables),
    "randla": (jimporters.map_randla_vars, convert.randla_from_jax_variables),
}


def _ckpt(model: str):
    if model == "randla":
        return _randla_arrays(np.random.default_rng(0))
    sd = _reference(model).state_dict()
    if model == "resgcn":  # DataParallel's prefix, under "state_dict"
        return {"state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 3}
    return {"model_state_dict": sd, "epoch": 5}


def test_the_cli_takes_the_eleven_jax_models():
    from pointsecguard_tpu.cli import import_ckpt as jax_cli

    src = open(jax_cli.__file__).read()
    assert all(f'"{m}"' in src for m in importers.MODELS) and len(importers.MODELS) == 11
    assert sorted(importers.MODELS) == sorted(_JAX)


@pytest.mark.parametrize("model", sorted(_JAX))
def test_import_equals_the_jax_importer_then_convert(model):
    ckpt = _ckpt(model)
    jax_import, jax_convert = _JAX[model]
    want = jax_convert({k: np.asarray(v) for k, v in
                        flatten_dict(jax_import(ckpt), sep="/").items()})
    got = importers.state_dict_from_variables(
        model, importers.reference_variables(model, ckpt, resgcn_blocks=RESGCN_BLOCKS))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("model", ["pointnet2", "pointnet_cls", "resgcn"])
def test_a_missing_key_raises_as_in_jax(model):
    ckpt = _ckpt(model)
    sd = dict(ckpt.get("model_state_dict") or ckpt["state_dict"])
    sd.pop(sorted(k for k in sd if k.endswith("running_var"))[0])
    broken = {"state_dict": sd}
    with pytest.raises(KeyError):
        _JAX[model][0](broken)
    with pytest.raises(KeyError):
        importers.reference_variables(model, broken, resgcn_blocks=RESGCN_BLOCKS)


def test_randla_unmatched_or_missing_variables_raise_as_in_jax():
    arrays = _randla_arrays(np.random.default_rng(1))
    extra = dict(arrays, **{"Encoder_layer_9mlp1/weights": np.zeros((1, 1, 2, 2))})
    missing = {k: v for k, v in arrays.items() if k != "fc2/biases"}
    for fn in (jimporters.map_randla_vars, importers.map_randla_vars):
        with pytest.raises(ValueError, match="did not map onto the flax tree"):
            fn(extra)
        with pytest.raises(ValueError, match="fc2/biases"):
            fn(missing)


def test_a_reference_of_another_shape_is_refused_by_convert():
    """A PointNet semseg whose encoder reads 9 channels fills no tensor of
    the port's 6-channel encoder: ``utils/convert.py`` raises."""
    m = _reference("pointnet")
    m.feat = _encoder(9)
    variables = importers.reference_variables("pointnet", m.state_dict())
    with pytest.raises(ValueError):
        importers.state_dict_from_variables("pointnet", variables)


def test_cli_import_then_eval_restores_the_weights(tmp_path):
    pth = str(tmp_path / "best_model.pth")
    torch.save(_ckpt("pointnet2"), pth)
    log = str(tmp_path / "imported")
    state = import_ckpt.main(["--model", "pointnet2", "--ckpt", pth, "--log_dir", log,
                              "--num_point", "64"])
    restored = load_checkpoint(log)
    assert set(restored) == set(state)
    assert all(torch.equal(restored[k], state[k]) for k in state)
    data = str(tmp_path / "data")
    make_synthetic_rooms(data, points_per_room=1000, seed=5)
    total = eval_cli.main(["--device", "cpu", "--model", "pointnet2", "--data_root", data,
                           "--log_dir", log, "--num_point", "128", "--batch_size", "8",
                           "--num_votes", "1"])
    assert 0.0 <= total.accuracy <= 1.0


def test_cli_imports_resgcn_for_eval(tmp_path):
    pth = str(tmp_path / "_ckpt_best.pth")
    torch.save(_ckpt("resgcn"), pth)
    log = str(tmp_path / "imported")
    import_ckpt.main(["--model", "resgcn", "--ckpt", pth, "--log_dir", log,
                      "--resgcn_blocks", str(RESGCN_BLOCKS)])
    data = str(tmp_path / "data")
    make_synthetic_rooms(data, points_per_room=1000, seed=5)
    total = eval_cli.main(["--device", "cpu", "--model", "resgcn", "--data_root", data,
                           "--log_dir", log, "--num_point", "128", "--batch_size", "8",
                           "--num_votes", "1", "--resgcn_blocks", str(RESGCN_BLOCKS),
                           "--resgcn_filters", str(RESGCN_FILTERS), "--resgcn_k", "4"])
    assert 0.0 <= total.accuracy <= 1.0


def test_cli_imports_the_randla_npz_and_refuses_a_tf_prefix(tmp_path):
    npz = str(tmp_path / "snap.npz")
    np.savez(npz, **_randla_arrays(np.random.default_rng(2)))
    log = str(tmp_path / "imported")
    state = import_ckpt.main(["--model", "randla", "--ckpt", npz, "--log_dir", log])
    assert os.path.exists(os.path.join(log, "checkpoints", "best.pt"))
    assert state["fc.weight"].shape == (13, 32)
    with pytest.raises(SystemExit, match="needs tensorflow.*--help"):
        import_ckpt.main(["--model", "randla", "--ckpt", str(tmp_path / "snap-100"),
                          "--log_dir", log])
    with pytest.raises(SystemExit, match="divisible by 512"):
        import_ckpt.main(["--model", "randla", "--ckpt", npz, "--log_dir", log,
                          "--num_point", "1000"])
