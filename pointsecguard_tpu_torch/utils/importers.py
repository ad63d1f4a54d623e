"""Reference checkpoints → the port's state dicts (port of
``pointsecguard_tpu/utils/importers.py``; ``cli.import_ckpt`` drives it).

The maps are the JAX package's, copied as they stand (numpy only), with
its names and its errors: each maps a reference checkpoint onto the flax
variable tree of the JAX model ({"params", "batch_stats"}), and
``state_dict_from_variables`` carries that tree through the matching
``utils/convert.py`` ``*_from_jax_variables`` to the port's state dict,
which raises on a leaf that fills no tensor of the port model.

- PointNet++ semseg: torch ``state_dict`` from `train_semseg.py:188-198`
  checkpoints ({epoch, model_state_dict, ...} or a bare state dict) for
  `models/pointnet2_sem_seg.py` — Conv2d/Conv1d 1×1 + BatchNorm stacks;
  likewise MSG, PointNet and the classifiers and part-seg nets.
- ResGCN (DenseDeepGCN): torch ``state_dict`` from
  `ResGCN/utils/ckpt_util.py:109-114` checkpoints (handles the
  DataParallel ``module.`` prefix like `load_pretrained_models:27-86`).
- RandLA-Net: a ``{tf_variable_name: array}`` dump of a TF1 snapshot
  (`RandLANet.py:141-142`; ``map_randla_vars``). Reading the snapshot
  itself needs TensorFlow, which the port does not use:
  ``cli.import_ckpt`` says how to dump it to ``.npz``.

Conventions converted:
- torch Conv2d/Conv1d 1×1 weight [out, in, 1(,1)] → flax Dense kernel
  [in, out] (squeeze + transpose);
- torch/TF BatchNorm (weight/gamma, bias/beta, running_mean/var) →
  flax BatchNorm scale/bias + batch_stats mean/var;
- channel-concat orders are identical by construction (the parity tests
  pin the layers to the reference arithmetic), so weights map verbatim.
"""

from __future__ import annotations

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _strip_module(sd: dict) -> dict:
    """Drop DataParallel's ``module.`` prefix (`ckpt_util.py:40-52`)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _unwrap(ckpt) -> dict:
    """Accept either a bare state dict or the reference's checkpoint dict
    ({'model_state_dict': ...}, `train_semseg.py:190-195`)."""
    if "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    elif "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return _strip_module(ckpt)


def _dense_from_conv(sd: dict, key: str):
    w = _np(sd[f"{key}.weight"])  # [out, in, 1(, 1)]
    w = w.reshape(w.shape[0], w.shape[1])
    out = {"kernel": w.T.astype(np.float32)}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"]).astype(np.float32)
    return out


def _bn(sd: dict, key: str):
    params = {
        "scale": _np(sd[f"{key}.weight"]).astype(np.float32),
        "bias": _np(sd[f"{key}.bias"]).astype(np.float32),
    }
    stats = {
        "mean": _np(sd[f"{key}.running_mean"]).astype(np.float32),
        "var": _np(sd[f"{key}.running_var"]).astype(np.float32),
    }
    return params, stats


def _point_mlp(sd: dict, conv_prefix: str, bn_prefix: str, n: int):
    """A stack of n (conv 1×1 + BN) layers → PointMLP params/stats."""
    params, stats = {}, {}
    for i in range(n):
        dense = _dense_from_conv(sd, f"{conv_prefix}.{i}")
        bn_p, bn_s = _bn(sd, f"{bn_prefix}.{i}")
        params[f"PointConv_{i}"] = {"Dense_0": dense, "BatchNorm_0": bn_p}
        stats[f"PointConv_{i}"] = {"BatchNorm_0": bn_s}
    return params, stats


def import_pointnet2_semseg(ckpt: dict) -> dict:
    """torch `pointnet2_sem_seg.py` state dict → our PointNet2SemSegSSG
    variables ({"params", "batch_stats"}).

    Layer correspondence (both orders are declaration order):
    sa1..sa4 → SetAbstraction_0..3; fp4..fp1 → FeaturePropagation_0..3
    (the reference APPLIES fp4 first, `pointnet2_sem_seg.py:31-34`, which
    is our declaration order); conv1+bn1 → the head PointMLP_0;
    conv2 → the final Dense_0.
    """
    sd = _unwrap(ckpt)
    params: dict = {}
    stats: dict = {}
    sa_sizes = {f"sa{k}": len(m) for k, m in
                zip(range(1, 5), ([32, 32, 64], [64, 64, 128],
                                  [128, 128, 256], [256, 256, 512]))}
    for k in range(4):
        p, s = _point_mlp(sd, f"sa{k + 1}.mlp_convs", f"sa{k + 1}.mlp_bns",
                          sa_sizes[f"sa{k + 1}"])
        params[f"SetAbstraction_{k}"] = {"PointMLP_0": p}
        stats[f"SetAbstraction_{k}"] = {"PointMLP_0": s}
    fp_sizes = {"fp4": 2, "fp3": 2, "fp2": 2, "fp1": 3}
    for k, name in enumerate(["fp4", "fp3", "fp2", "fp1"]):
        p, s = _point_mlp(sd, f"{name}.mlp_convs", f"{name}.mlp_bns",
                          fp_sizes[name])
        params[f"FeaturePropagation_{k}"] = {"PointMLP_0": p}
        stats[f"FeaturePropagation_{k}"] = {"PointMLP_0": s}
    head_p, head_s = _bn(sd, "bn1")
    params["PointMLP_0"] = {"PointConv_0": {
        "Dense_0": _dense_from_conv(sd, "conv1"), "BatchNorm_0": head_p,
    }}
    stats["PointMLP_0"] = {"PointConv_0": {"BatchNorm_0": head_s}}
    params["Dense_0"] = _dense_from_conv(sd, "conv2")
    return {"params": params, "batch_stats": stats}


def import_pointnet2_semseg_msg(ckpt: dict) -> dict:
    """torch `pointnet2_sem_seg_msg.py:6-41` state dict → our
    PointNet2SemSegMSG variables (sa1..sa4 two-scale MSG levels,
    fp4..fp1 applied-order chain, conv1/bn1 + conv2 head)."""
    sd = _unwrap(ckpt)
    msg_specs = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)),
    )
    params: dict = {}
    stats: dict = {}
    for k, mlps in enumerate(msg_specs):
        p, s = _msg_abstraction(sd, f"sa{k + 1}", mlps)
        params[f"SetAbstractionMSG_{k}"] = p
        stats[f"SetAbstractionMSG_{k}"] = s
    fp_sizes = {"fp4": 2, "fp3": 2, "fp2": 2, "fp1": 3}
    for k, name in enumerate(["fp4", "fp3", "fp2", "fp1"]):
        p, s = _point_mlp(sd, f"{name}.mlp_convs", f"{name}.mlp_bns",
                          fp_sizes[name])
        params[f"FeaturePropagation_{k}"] = {"PointMLP_0": p}
        stats[f"FeaturePropagation_{k}"] = {"PointMLP_0": s}
    head_p, head_s = _bn(sd, "bn1")
    params["PointMLP_0"] = {"PointConv_0": {
        "Dense_0": _dense_from_conv(sd, "conv1"), "BatchNorm_0": head_p,
    }}
    stats["PointMLP_0"] = {"PointConv_0": {"BatchNorm_0": head_s}}
    params["Dense_0"] = _dense_from_conv(sd, "conv2")
    return {"params": params, "batch_stats": stats}


def _stn(sd: dict, prefix: str):
    """STN3d/STNkd (`pointnet.py:10-85`: conv1-3/bn1-3 shared MLP, then
    fc1/bn4 → fc2/bn5 → fc3) → our STN module tree."""
    params: dict = {}
    stats: dict = {}
    for i in range(3):
        bn_p, bn_s = _bn(sd, f"{prefix}.bn{i + 1}")
        params[f"PointConv_{i}"] = {
            "Dense_0": _dense_from_conv(sd, f"{prefix}.conv{i + 1}"),
            "BatchNorm_0": bn_p,
        }
        stats[f"PointConv_{i}"] = {"BatchNorm_0": bn_s}
    bn4_p, bn4_s = _bn(sd, f"{prefix}.bn4")
    bn5_p, bn5_s = _bn(sd, f"{prefix}.bn5")
    params.update({
        "Dense_0": _dense_from_conv(sd, f"{prefix}.fc1"),
        "BatchNorm_0": bn4_p,
        "Dense_1": _dense_from_conv(sd, f"{prefix}.fc2"),
        "BatchNorm_1": bn5_p,
        "Dense_2": _dense_from_conv(sd, f"{prefix}.fc3"),
    })
    stats.update({"BatchNorm_0": bn4_s, "BatchNorm_1": bn5_s})
    return params, stats


def _pointnet_encoder(sd: dict, prefix: str, *, feature_transform=True):
    """PointNetEncoder (`pointnet.py:88-132`: stn + conv1-3/bn1-3 +
    optional fstn) → our PointNetEncoder tree."""
    params: dict = {}
    stats: dict = {}
    p, s = _stn(sd, f"{prefix}.stn")
    params["STN_0"] = p
    stats["STN_0"] = s
    if feature_transform:
        p, s = _stn(sd, f"{prefix}.fstn")
        params["STN_1"] = p
        stats["STN_1"] = s
    for i in range(3):
        bn_p, bn_s = _bn(sd, f"{prefix}.bn{i + 1}")
        params[f"PointConv_{i}"] = {
            "Dense_0": _dense_from_conv(sd, f"{prefix}.conv{i + 1}"),
            "BatchNorm_0": bn_p,
        }
        stats[f"PointConv_{i}"] = {"BatchNorm_0": bn_s}
    return params, stats


def import_pointnet_semseg(ckpt: dict) -> dict:
    """torch `pointnet_sem_seg.py:9-38` state dict → PointNetSemSeg
    variables (encoder + conv1-3/bn1-3 head + conv4 logits)."""
    sd = _unwrap(ckpt)
    enc_p, enc_s = _pointnet_encoder(sd, "feat")
    params: dict = {"PointNetEncoder_0": enc_p}
    stats: dict = {"PointNetEncoder_0": enc_s}
    for i in range(3):
        bn_p, bn_s = _bn(sd, f"bn{i + 1}")
        params[f"PointConv_{i}"] = {
            "Dense_0": _dense_from_conv(sd, f"conv{i + 1}"),
            "BatchNorm_0": bn_p,
        }
        stats[f"PointConv_{i}"] = {"BatchNorm_0": bn_s}
    params["Dense_0"] = _dense_from_conv(sd, "conv4")
    return {"params": params, "batch_stats": stats}


def import_pointnet_cls(ckpt: dict) -> dict:
    """torch `pointnet_cls.py:6-29` state dict → PointNetCls variables
    (encoder + fc1/bn1 → fc2/bn2 → fc3 head)."""
    sd = _unwrap(ckpt)
    enc_p, enc_s = _pointnet_encoder(sd, "feat")
    bn1_p, bn1_s = _bn(sd, "bn1")
    bn2_p, bn2_s = _bn(sd, "bn2")
    params = {
        "PointNetEncoder_0": enc_p,
        "Dense_0": _dense_from_conv(sd, "fc1"),
        "BatchNorm_0": bn1_p,
        "Dense_1": _dense_from_conv(sd, "fc2"),
        "BatchNorm_1": bn2_p,
        "Dense_2": _dense_from_conv(sd, "fc3"),
    }
    stats = {
        "PointNetEncoder_0": enc_s,
        "BatchNorm_0": bn1_s,
        "BatchNorm_1": bn2_s,
    }
    return {"params": params, "batch_stats": stats}


def import_pointnet_partseg(ckpt: dict) -> dict:
    """torch `pointnet_part_seg.py:9-75` state dict → PointNetPartSeg
    variables (stn + conv1-5/bn1-5 + fstn(k=128) + convs1-3/bns1-3 +
    convs4 logits)."""
    sd = _unwrap(ckpt)
    params: dict = {}
    stats: dict = {}
    p, s = _stn(sd, "stn")
    params["STN_0"] = p
    stats["STN_0"] = s
    p, s = _stn(sd, "fstn")
    params["STN_1"] = p
    stats["STN_1"] = s
    for i in range(5):
        bn_p, bn_s = _bn(sd, f"bn{i + 1}")
        params[f"PointConv_{i}"] = {
            "Dense_0": _dense_from_conv(sd, f"conv{i + 1}"),
            "BatchNorm_0": bn_p,
        }
        stats[f"PointConv_{i}"] = {"BatchNorm_0": bn_s}
    for i in range(3):
        bn_p, bn_s = _bn(sd, f"bns{i + 1}")
        params[f"PointConv_{i + 5}"] = {
            "Dense_0": _dense_from_conv(sd, f"convs{i + 1}"),
            "BatchNorm_0": bn_p,
        }
        stats[f"PointConv_{i + 5}"] = {"BatchNorm_0": bn_s}
    params["Dense_0"] = _dense_from_conv(sd, "convs4")
    return {"params": params, "batch_stats": stats}


def _cls_head(sd: dict):
    """fc1/bn1 → fc2/bn2 → fc3 (`pointnet2_cls_ssg.py:14-20`) → our
    ``_ClsHead`` (Dense_0/BatchNorm_0/Dense_1/BatchNorm_1/Dense_2)."""
    bn1_p, bn1_s = _bn(sd, "bn1")
    bn2_p, bn2_s = _bn(sd, "bn2")
    params = {
        "Dense_0": _dense_from_conv(sd, "fc1"),
        "BatchNorm_0": bn1_p,
        "Dense_1": _dense_from_conv(sd, "fc2"),
        "BatchNorm_1": bn2_p,
        "Dense_2": _dense_from_conv(sd, "fc3"),
    }
    return params, {"BatchNorm_0": bn1_s, "BatchNorm_1": bn2_s}


def _msg_abstraction(sd: dict, prefix: str, mlps):
    """PointNetSetAbstractionMsg's conv_blocks.{scale}.{layer} nested
    ModuleLists (`pointnet_util.py:210-232`) → SetAbstractionMSG's
    PointMLP_{scale} stack."""
    params, stats = {}, {}
    for i, mlp in enumerate(mlps):
        p, s = _point_mlp(
            sd, f"{prefix}.conv_blocks.{i}", f"{prefix}.bn_blocks.{i}",
            len(mlp),
        )
        params[f"PointMLP_{i}"] = p
        stats[f"PointMLP_{i}"] = s
    return params, stats


def import_pointnet2_cls(ckpt: dict, *, msg: bool = False) -> dict:
    """torch `pointnet2_cls_ssg.py:6-39` / `pointnet2_cls_msg.py:6-40`
    state dict → PointNet2ClsSSG/MSG variables. The reference ships these
    models with no drivers; importing upstream-trained classification
    checkpoints activates them here."""
    sd = _unwrap(ckpt)
    params: dict = {}
    stats: dict = {}
    if msg:
        msg_specs = (
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)),
        )
        for k, mlps in enumerate(msg_specs):
            p, s = _msg_abstraction(sd, f"sa{k + 1}", mlps)
            params[f"SetAbstractionMSG_{k}"] = p
            stats[f"SetAbstractionMSG_{k}"] = s
        p, s = _point_mlp(sd, "sa3.mlp_convs", "sa3.mlp_bns", 3)
        params["SetAbstraction_0"] = {"PointMLP_0": p}
        stats["SetAbstraction_0"] = {"PointMLP_0": s}
    else:
        for k in range(3):
            p, s = _point_mlp(
                sd, f"sa{k + 1}.mlp_convs", f"sa{k + 1}.mlp_bns", 3
            )
            params[f"SetAbstraction_{k}"] = {"PointMLP_0": p}
            stats[f"SetAbstraction_{k}"] = {"PointMLP_0": s}
    head_p, head_s = _cls_head(sd)
    params["_ClsHead_0"] = head_p
    stats["_ClsHead_0"] = head_s
    return {"params": params, "batch_stats": stats}


def import_pointnet2_partseg(ckpt: dict, *, msg: bool = False) -> dict:
    """torch `pointnet2_part_seg_ssg.py:7-52` / `pointnet2_part_seg_msg.py`
    state dict → PointNet2PartSegSSG/MSG variables."""
    sd = _unwrap(ckpt)
    params: dict = {}
    stats: dict = {}
    if msg:
        msg_specs = (
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
            ((128, 128, 256), (128, 196, 256)),
        )
        for k, mlps in enumerate(msg_specs):
            p, s = _msg_abstraction(sd, f"sa{k + 1}", mlps)
            params[f"SetAbstractionMSG_{k}"] = p
            stats[f"SetAbstractionMSG_{k}"] = s
        p, s = _point_mlp(sd, "sa3.mlp_convs", "sa3.mlp_bns", 3)
        params["SetAbstraction_0"] = {"PointMLP_0": p}
        stats["SetAbstraction_0"] = {"PointMLP_0": s}
        fp_sizes = {"fp3": 2, "fp2": 2, "fp1": 2}
    else:
        for k in range(3):
            p, s = _point_mlp(
                sd, f"sa{k + 1}.mlp_convs", f"sa{k + 1}.mlp_bns", 3
            )
            params[f"SetAbstraction_{k}"] = {"PointMLP_0": p}
            stats[f"SetAbstraction_{k}"] = {"PointMLP_0": s}
        fp_sizes = {"fp3": 2, "fp2": 2, "fp1": 3}
    # the reference applies fp3 first (`pointnet2_part_seg_ssg.py:38-41`),
    # matching our FeaturePropagation declaration order
    for k, name in enumerate(["fp3", "fp2", "fp1"]):
        p, s = _point_mlp(sd, f"{name}.mlp_convs", f"{name}.mlp_bns",
                          fp_sizes[name])
        params[f"FeaturePropagation_{k}"] = {"PointMLP_0": p}
        stats[f"FeaturePropagation_{k}"] = {"PointMLP_0": s}
    head_p, head_s = _bn(sd, "bn1")
    params["PointMLP_0"] = {"PointConv_0": {
        "Dense_0": _dense_from_conv(sd, "conv1"), "BatchNorm_0": head_p,
    }}
    stats["PointMLP_0"] = {"PointConv_0": {"BatchNorm_0": head_s}}
    params["Dense_0"] = _dense_from_conv(sd, "conv2")
    return {"params": params, "batch_stats": stats}


def import_resgcn(ckpt: dict, *, n_blocks: int = 28,
                  conv: str = "edge") -> dict:
    """torch DenseDeepGCN state dict (`ResGCN/sem_seg_dense/
    architecture.py` + `gcn_lib/dense`) → our DenseDeepGCN variables.

    Reference schema: ``BasicConv`` IS an nn.Sequential of
    [Conv2d, act, BN] (`torch_nn.py:55-67`) so the conv sits at ``.0``
    and the BN at ``.2`` (no BN in the last prediction conv, act=None →
    conv only). Attribute paths (`architecture.py:21-45`,
    `torch_vertex.py:29,45,95`):
    head.gconv.nn → our EdgeConv_0/BasicConv_0;
    backbone.{b}.body.gconv.nn → DynConv_{b}/EdgeConv_0/BasicConv_0;
    fusion_block → BasicConv_0; prediction.{0,1,3} → BasicConv_{1,2,3}.
    """
    sd = _unwrap(ckpt)

    def basic_conv(prefix):
        dense = _dense_from_conv(sd, f"{prefix}.0")
        if f"{prefix}.2.running_mean" in sd:
            bn_p, bn_s = _bn(sd, f"{prefix}.2")
            return ({"Dense_0": dense, "BatchNorm_0": bn_p},
                    {"BatchNorm_0": bn_s})
        return {"Dense_0": dense}, None

    params: dict = {}
    stats: dict = {}

    def put(tree_path, prefix):
        p, s = basic_conv(prefix)
        node = params
        for part in tree_path[:-1]:
            node = node.setdefault(part, {})
        node[tree_path[-1]] = p
        if s is not None:
            node = stats
            for part in tree_path[:-1]:
                node = node.setdefault(part, {})
            node[tree_path[-1]] = s

    # flax names the graph-conv submodule by its class (`models/resgcn.py`
    # _graph_conv): EdgeConv_0 for conv='edge', MRConv_0 for conv='mr' —
    # the torch attribute path is `gconv.nn` either way
    gc = {"edge": "EdgeConv_0", "mr": "MRConv_0"}[conv]
    put((gc, "BasicConv_0"), "head.gconv.nn")
    for b in range(n_blocks - 1):
        put((f"DynConv_{b}", gc, "BasicConv_0"),
            f"backbone.{b}.body.gconv.nn")
    put(("BasicConv_0",), "fusion_block")
    put(("BasicConv_1",), "prediction.0")
    put(("BasicConv_2",), "prediction.1")
    put(("BasicConv_3",), "prediction.3")
    return {"params": params, "batch_stats": stats}


def _tf_var_ignored(name: str) -> bool:
    """Non-model variables a real snapshot would contain: the Adam slots
    (`RandLANet.py:127-129`: AdamOptimizer under scope 'optimizer') and
    bookkeeping scalars."""
    if name.startswith(("optimizer/", "loss/", "results/")):
        return True
    leaf = name.rsplit("/", 1)[-1]
    return leaf in (
        "Adam", "Adam_1", "learning_rate", "global_step",
        "beta1_power", "beta2_power",
    )


def map_randla_vars(arrays: dict, *, num_layers: int = 5) -> dict:
    """Map a {tf_var_name: ndarray} dict onto RandLANet flax variables.

    The fork ships no snapshot, but its variable schema is statically
    derivable from the graph definition:

    - ``fc0/{kernel,bias}`` — `tf.layers.dense(..., name='fc0')`
      (`RandLANet.py:158`), followed by one UNNAMED top-level
      `tf.layers.batch_normalization` (`:160`) →
      ``batch_normalization/{gamma,beta,moving_mean,moving_variance}``;
    - every `helper_tf_util.conv2d(scope)` (`helper_tf_util.py:115-170`)
      → ``<scope>/weights`` [1,1,in,out] + ``<scope>/biases`` [out], and
      with bn=True an unnamed BN *inside* the scope →
      ``<scope>/batch_normalization/*``;
    - `conv2d_transpose` (`helper_tf_util.py:184-212`) is identical
      except the kernel is **reversed**: [1,1,out,in];
    - encoder scopes (`RandLANet.py:161-190,323-344,398-410`):
      ``Encoder_layer_{i}{mlp1,mlp2,shortcut}``,
      ``Encoder_layer_{i}LFA{mlp1,mlp2}``,
      ``Encoder_layer_{i}LFAatt_pooling_{1,2}{fc,mlp}`` (the attention
      ``fc`` is a bias-free `tf.layers.dense` → ``<scope>fc/kernel``);
    - decoder scopes: ``decoder_0``, ``Decoder_layer_{j}`` (transpose
      convs), ``fc1``, ``fc2``, ``fc`` (no BN on the final ``fc``).

    Raises ValueError listing unmatched model variables if the snapshot
    schema differs.
    """
    arrays = {k.split(":", 1)[0]: v for k, v in arrays.items()}
    used: set = set()

    def take(name):
        if name not in arrays:
            raise ValueError(
                f"RandLA TF import: expected variable '{name}' not in "
                f"checkpoint ({len(arrays)} variables present)"
            )
        used.add(name)
        return _np(arrays[name]).astype(np.float32)

    def bn(scope):
        pre = f"{scope}/" if scope else ""
        p = {"scale": take(f"{pre}batch_normalization/gamma"),
             "bias": take(f"{pre}batch_normalization/beta")}
        s = {"mean": take(f"{pre}batch_normalization/moving_mean"),
             "var": take(f"{pre}batch_normalization/moving_variance")}
        return p, s

    def conv(scope, *, transpose=False, with_bn=True):
        """One helper_tf_util conv2d/conv2d_transpose → our PointConv."""
        w = take(f"{scope}/weights")
        w = w.reshape(w.shape[-2], w.shape[-1])  # [1,1,a,b] → [a,b]
        if transpose:
            w = np.ascontiguousarray(w.T)  # [out,in] → [in,out]
        p = {"Dense_0": {"kernel": w, "bias": take(f"{scope}/biases")}}
        if not with_bn:
            return p, None
        bn_p, bn_s = bn(scope)
        p["BatchNorm_0"] = bn_p
        return p, {"BatchNorm_0": bn_s}

    params: dict = {}
    stats: dict = {}

    # fc0 + top-level BN (`RandLANet.py:158-160`)
    params["Dense_0"] = {"kernel": take("fc0/kernel"),
                         "bias": take("fc0/bias")}
    top_bn_p, top_bn_s = bn("")
    params["BatchNorm_0"] = top_bn_p
    stats["BatchNorm_0"] = top_bn_s

    # encoder (`RandLANet.py:161-171` → dilated_res_block `:323-330`)
    for i in range(num_layers):
        E = f"Encoder_layer_{i}"
        blk_p: dict = {}
        blk_s: dict = {}
        blk_p["PointConv_0"], blk_s["PointConv_0"] = conv(f"{E}mlp1")
        lfa_p: dict = {}
        lfa_s: dict = {}
        lfa_p["PointConv_0"], lfa_s["PointConv_0"] = conv(f"{E}LFAmlp1")
        for a, ap in ((1, "AttentivePooling_0"), (2, "AttentivePooling_1")):
            mlp_p, mlp_s = conv(f"{E}LFAatt_pooling_{a}mlp")
            lfa_p[ap] = {
                "Dense_0": {"kernel": take(f"{E}LFAatt_pooling_{a}fc/kernel")},
                "PointConv_0": mlp_p,
            }
            lfa_s[ap] = {"PointConv_0": mlp_s}
        lfa_p["PointConv_1"], lfa_s["PointConv_1"] = conv(f"{E}LFAmlp2")
        blk_p["LocalFeatureAggregation_0"] = lfa_p
        blk_s["LocalFeatureAggregation_0"] = lfa_s
        blk_p["PointConv_1"], blk_s["PointConv_1"] = conv(f"{E}mlp2")
        blk_p["PointConv_2"], blk_s["PointConv_2"] = conv(f"{E}shortcut")
        params[f"DilatedResBlock_{i}"] = blk_p
        stats[f"DilatedResBlock_{i}"] = blk_s

    # bottleneck + decoder (`RandLANet.py:173-186`); Decoder_layer_{j}
    # are conv2d_TRANSPOSE scopes — reversed kernels
    params["PointConv_0"], stats["PointConv_0"] = conv("decoder_0")
    for j in range(num_layers):
        params[f"PointConv_{1 + j}"], stats[f"PointConv_{1 + j}"] = conv(
            f"Decoder_layer_{j}", transpose=True
        )
    # heads (`RandLANet.py:188-190`); final fc has bn=False
    n = 1 + num_layers
    params[f"PointConv_{n}"], stats[f"PointConv_{n}"] = conv("fc1")
    params[f"PointConv_{n + 1}"], stats[f"PointConv_{n + 1}"] = conv("fc2")
    fc_p, _ = conv("fc", with_bn=False)
    params["Dense_1"] = fc_p["Dense_0"]

    unmatched = sorted(
        k for k in arrays if k not in used and not _tf_var_ignored(k)
    )
    if unmatched:
        raise ValueError(
            "RandLA TF import: checkpoint contains model variables that "
            f"did not map onto the flax tree: {unmatched[:20]}"
            + (" ..." if len(unmatched) > 20 else "")
        )
    return {"params": params, "batch_stats": stats}


def flat_variables(variables: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested {"params", "batch_stats"} tree → flat "/"-joined leaves,
    the layout of ``utils/convert.py``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in variables.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flat_variables(value, f"{path}/"))
        else:
            flat[path] = np.asarray(value)
    return flat


# --model of cli.import_ckpt → the utils/convert.py name of the object-task nets
_OBJECT_MODELS = {
    "pointnet_cls": "pointnet_cls", "pointnet_part_seg": "pointnet_part_seg",
    "pointnet2_cls_ssg": "pointnet2_cls", "pointnet2_cls_msg": "pointnet2_cls_msg",
    "pointnet2_part_seg_ssg": "pointnet2_part_seg",
    "pointnet2_part_seg_msg": "pointnet2_part_seg_msg",
}
MODELS = ("pointnet2", "pointnet2_msg", "resgcn", "randla", "pointnet", *_OBJECT_MODELS)


def reference_variables(model: str, ckpt, *, resgcn_blocks: int = 28,
                        resgcn_conv: str = "edge") -> dict:
    """The flax variables of ``model`` (a ``cli.import_ckpt --model``
    name) from a reference checkpoint: a torch state dict (or the
    reference's checkpoint dict), or for randla the TF variable arrays."""
    if model == "randla":
        return map_randla_vars(ckpt)
    if model == "resgcn":
        return import_resgcn(ckpt, n_blocks=resgcn_blocks, conv=resgcn_conv)
    importers = {
        "pointnet2": import_pointnet2_semseg, "pointnet2_msg": import_pointnet2_semseg_msg,
        "pointnet": import_pointnet_semseg, "pointnet_cls": import_pointnet_cls,
        "pointnet_part_seg": import_pointnet_partseg,
    }
    if model in importers:
        return importers[model](ckpt)
    if model.startswith("pointnet2_cls"):
        return import_pointnet2_cls(ckpt, msg=model.endswith("msg"))
    if model.startswith("pointnet2_part_seg"):
        return import_pointnet2_partseg(ckpt, msg=model.endswith("msg"))
    raise ValueError(f"unknown model {model!r}; known: {list(MODELS)}")


def state_dict_from_variables(model: str, variables: dict) -> dict:
    """The port's state dict of ``model`` from its flax variables
    (``utils/convert.py``); ValueError on a leaf that fills nothing."""
    from pointsecguard_tpu_torch.utils import convert

    flat = flat_variables(variables)
    if model in _OBJECT_MODELS:
        return convert.cls_from_jax_variables(_OBJECT_MODELS[model], flat)
    return {"pointnet2": convert.from_jax_variables,
            "pointnet2_msg": convert.pointnet2_msg_from_jax_variables,
            "pointnet": convert.pointnet_from_jax_variables,
            "randla": convert.randla_from_jax_variables,
            "resgcn": convert.resgcn_from_jax_variables}[model](flat)
