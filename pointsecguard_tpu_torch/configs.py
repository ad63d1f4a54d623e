"""Configurations of the port: the fields of ``pointsecguard_tpu/configs.py``
that its ported paths read."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RandlaConfig:
    """`helper_tool.py:44-66` ConfigS3DIS."""

    k_n: int = 16
    num_layers: int = 5
    num_points: int = 40960
    sub_grid_size: float = 0.04
    batch_size: int = 6
    val_batch_size: int = 1
    train_steps: int = 500
    val_steps: int = 100
    sub_sampling_ratio: tuple = (4, 4, 4, 4, 2)
    d_out: tuple = (16, 64, 128, 256, 512)
    noise_init: float = 3.5
    max_epoch: int = 100
    learning_rate: float = 1e-2
    lr_decay: float = 0.95


@dataclass(frozen=True)
class RandlaSemanticKITTIConfig:
    """`helper_tool.py:18-41` ConfigSemanticKITTI."""

    k_n: int = 16
    num_layers: int = 4
    num_points: int = 45056
    num_classes: int = 19
    sub_grid_size: float = 0.06
    batch_size: int = 6
    val_batch_size: int = 20
    train_steps: int = 500
    val_steps: int = 100
    sub_sampling_ratio: tuple = (4, 4, 4, 4)
    d_out: tuple = (16, 64, 128, 256)
    noise_init: float = 3.5
    learning_rate: float = 1e-2
    lr_decay: float = 0.95


@dataclass(frozen=True)
class RandlaSemantic3DConfig:
    """`helper_tool.py:69-100` ConfigSemantic3D (its augmentation fields
    are read by no training loop of either package, so they are left out)."""

    k_n: int = 16
    num_layers: int = 5
    num_points: int = 65536
    num_classes: int = 8
    sub_grid_size: float = 0.06
    batch_size: int = 4
    val_batch_size: int = 16
    train_steps: int = 500
    val_steps: int = 100
    sub_sampling_ratio: tuple = (4, 4, 4, 4, 2)
    d_out: tuple = (16, 64, 128, 256, 512)
    noise_init: float = 3.5
    learning_rate: float = 1e-2
    lr_decay: float = 0.95


@dataclass(frozen=True)
class ResgcnConfig:
    """`ResGCN/sem_seg_dense/config.py:18-92` defaults (the fields the
    ported paths read; the JAX config's batch size and epoch count belong
    to its CLI, and its ``stochastic`` is always on: the dilation is
    stochastic in training whenever ``epsilon`` > 0). The block and conv
    types default in ``DenseDeepGCN``; the StepLR fields are read by no
    path of either package, so ``resgcn_lr`` keeps its lr constant."""

    num_point: int = 4096
    k: int = 16
    n_blocks: int = 28
    n_filters: int = 64
    epsilon: float = 0.0  # stochastic knn epsilon (0.2 to enable)
    dropout: float = 0.0
    lr: float = 1e-3


def resgcn_overrides(args) -> dict:
    """CLI flags → ``DenseDeepGCN`` keyword arguments (the reference's
    OptInit model flags, `ResGCN/sem_seg_dense/config.py:40-57`: --n_blocks,
    --n_filters, --kernel_size/k, --block, --conv, --epsilon/stochastic).
    0 / "" / None means "use the config default"; shared by cli.{train,
    eval, attack} so that a non-default model trains, evaluates and is
    attacked with one flag set. ``--resgcn_fast`` (``cli.attack`` and
    ``cli.eval``, as in JAX `configs.py:153-154`) sets the subsample
    dilation and the "approx" kNN, which is exact here."""
    ov = {}
    for flag, key in (("resgcn_blocks", "n_blocks"), ("resgcn_k", "k"),
                      ("resgcn_filters", "n_filters"), ("resgcn_block_type", "block"),
                      ("resgcn_conv", "conv"), ("resgcn_epsilon", "epsilon")):
        value = getattr(args, flag, None)
        if value:
            ov[key] = value
    if getattr(args, "resgcn_fast", False):
        ov.update(dilated_mode="subsample", knn_strategy="approx")
    return ov


def resgcn_refusals(args) -> list[str]:
    """The refusal the three CLIs share: ``--resgcn_*`` flags with a model
    other than resgcn."""
    if args.model != "resgcn" and resgcn_overrides(args):
        return [f"--resgcn_* with --model {args.model}"]
    return []


def add_resgcn_arguments(ap, *, fast_help: str | None = None) -> None:
    """The ``--resgcn_*`` model flags of the CLIs (the JAX CLIs' names,
    types and defaults); ``resgcn_overrides`` reads them. ``fast_help``:
    also ``--resgcn_fast`` with this help, where the JAX CLI has it
    (``cli.attack``, ``cli.eval``)."""
    ap.add_argument("--resgcn_blocks", type=int, default=0,
                    help="resgcn depth (0 = the config's 28; must match the checkpoint)")
    ap.add_argument("--resgcn_k", type=int, default=0,
                    help="resgcn kNN k (0 = the config's 16)")
    ap.add_argument("--resgcn_filters", type=int, default=0,
                    help="resgcn channel width (0 = the config's 64)")
    ap.add_argument("--resgcn_block_type", default="", choices=["", "res", "dense", "plain"],
                    help="resgcn backbone block (OptInit --block; \"\" = res)")
    ap.add_argument("--resgcn_conv", default="", choices=["", "edge", "mr"],
                    help="resgcn graph conv (OptInit --conv; \"\" = edge)")
    ap.add_argument("--resgcn_epsilon", type=float, default=0.0,
                    help="resgcn stochastic-dilation epsilon in training "
                         "(OptInit --epsilon; the reference enables it with 0.2)")
    if fast_help is not None:
        ap.add_argument("--resgcn_fast", action="store_true", help=fast_help)


def add_precision_argument(ap) -> None:
    """``--precision`` of the five CLIs that take it (the JAX CLIs' name,
    choices and default); ``utils.runtime.model_dtype`` reads it."""
    ap.add_argument("--precision", default="float32", choices=["float32", "bfloat16"],
                    help="bfloat16: every Linear product in bf16; parameters, "
                         "BatchNorm statistics, softmaxes, logits, losses and the "
                         "neighbour search stay float32")


def add_parallel_arguments(ap, *, shard_points: bool = True) -> None:
    """``--devices`` / ``-d`` and, where the JAX CLI has it,
    ``--shard_points`` (``parallel.data_parallel_mesh`` reads them)."""
    ap.add_argument("--devices", "-d", type=int, default=1,
                    help="data-parallel ranks: one card each (NCCL), or processes "
                         "over gloo with --device cpu")
    if shard_points:
        ap.add_argument("--shard_points", type=int, default=1,
                        help="split each cloud's points axis over this many of the "
                             "--devices ranks (the kNN of the RandLA pyramid is "
                             "divided; every other layer sees the whole cloud)")
