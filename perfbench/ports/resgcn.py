"""How the port runs the ``resgcn`` configurations: its
``models/resgcn.py`` ``DenseDeepGCN`` at the configuration's sizes and the
trainer's ``resgcn_family``. Its graphs are built inside every forward,
so its plan is None; ``graphs`` takes them from the model's modules."""

from __future__ import annotations

import contextlib

from perfbench.core.run import to_host

PRESET = "resgcn"  # the attack presets' model family


def build(cfg: dict, device, precision: str):
    """(model on ``device``, family) of the port."""
    from pointsecguard_tpu_torch.models import DenseDeepGCN
    from pointsecguard_tpu_torch.train.trainer import resgcn_family
    from pointsecguard_tpu_torch.utils.runtime import model_dtype

    model = DenseDeepGCN(num_classes=cfg["num_classes"], in_channels=cfg["in_channels"],
                         n_blocks=cfg["n_blocks"], n_filters=cfg["n_filters"], k=cfg["k"],
                         block=cfg["block"], conv=cfg["conv"], epsilon=cfg["epsilon"],
                         dropout=cfg["dropout"], dtype=model_dtype(precision))
    if cfg["fusion"] != 1024 or cfg["pred"] != [512, 256]:
        raise ValueError("the port's DenseDeepGCN fixes the fusion at 1024 and the "
                         f"prediction convs at 512, 256; the configuration has "
                         f"{cfg['fusion']}, {cfg['pred']}")
    return model.to(device), resgcn_family()


def loss():
    """The port's training loss of the family (mean cross-entropy)."""
    from pointsecguard_tpu_torch.models.resgcn import ce_loss

    return ce_loss


geometry_arrays = None  # no plan: the graphs come from ``graphs``


@contextlib.contextmanager
def graphs(model):
    """A list that receives host copies (``core.run.to_host``) of the
    graphs [B, N, k] of every forward of ``model`` run inside: the head's,
    as its EdgeConv is handed it, then each block's, as its ``DynConv``
    returns it (module hooks, removed on leaving)."""
    got = []
    handles = [model.head.register_forward_pre_hook(
        lambda m, args: got.append(to_host(args[1])))]
    handles += [blk.register_forward_hook(lambda m, args, out: got.append(to_host(out[1])))
                for blk in model.backbone]
    try:
        yield got
    finally:
        for h in handles:
            h.remove()
