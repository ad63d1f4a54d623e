"""Training loops behind ``cli.train`` (port of
``pointsecguard_tpu/train/loops.py:71-815``): the PointNet family
(``--model pointnet2|pointnet2_msg|pointnet``) and ResGCN-28 (``--model
resgcn``) on the host block sampler, RandLA-Net on the spatially-regular
sampler, and the ModelNet classifiers (``--model
pointnet2_cls|pointnet2_cls_msg|pointnet_cls``, ``train_cls``).

The PointNet family follows the reference script
`train_semseg.py:148-265`: z-rotation augmentation, weighted NLL
(PointNet: plus 0.001 times the feature-transform regularizer,
`pointnet_sem_seg.py:40-49`), Adam with step decay and the BatchNorm
momentum anneal, whole-scene eval, best-mIoU checkpointing, auto-resume.
RandLA-Net follows `RandLANet.py:197-311`: weighted softmax
cross-entropy, Adam without weight decay at ``1e-2 · 0.95^epoch``, a
validation confusion after every epoch.

ResGCN follows `sem_seg_dense/train.py:50-95`: raw sampler blocks (no
augmentation), plain mean cross-entropy, Adam without weight decay at a
constant 1e-3, no evaluation in the loop.

The PointNet++ and RandLA loops save ``latest.pt`` after every evaluated
epoch and ``best.pt`` when the mIoU improves; the ResGCN loop saves
``latest.pt`` after every epoch with −loss as its metric and no
``best.pt`` (the JAX loop's keep-latest manager). All three resume from
``latest.pt``. The JAX RandLA
loop saves only on improvement (``pointsecguard_tpu/train/loops.py:453-455``),
so a rerun there can repeat epochs; here none is repeated.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def train_pointnet_family(args, device: torch.device):
    """Train ``args.model`` (pointnet2, pointnet2_msg or pointnet) on the
    rooms under ``args.data_root``; returns ``(state, best mIoU)``. ``args`` carries
    ``cli.train``'s flags (data_root, log_dir, test_area, npoint,
    min_block_points, batch_size, learning_rate, seed, prefetch, epochs,
    eval_every)."""
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, augment
    from pointsecguard_tpu_torch.data.loader import make_batch_put, prefetch, wait_batch
    from pointsecguard_tpu_torch.models import init_parameters, weighted_nll_loss
    from pointsecguard_tpu_torch.train.evaluator import evaluate_whole_scenes
    from pointsecguard_tpu_torch.train.schedules import (
        pointnet2_bn_momentum,
        pointnet2_lr,
    )
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET_MODELS,
        TrainState,
        make_eval_step,
        make_train_step,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager
    from pointsecguard_tpu_torch.utils.logging import EventLog, SummaryLogger

    rooms = RoomSet.load(args.data_root, "train", args.test_area)
    test_rooms = RoomSet.load(args.data_root, "test", args.test_area)
    sampler = S3DISBlockSampler(
        rooms, num_point=args.npoint,
        min_points=getattr(args, "min_block_points", 1024),
    )
    batch_size = args.batch_size or 32
    base_lr = args.learning_rate or 0.001
    depth = getattr(args, "prefetch", 2)

    rng = np.random.default_rng(args.seed)
    # the JAX loop spends one sampler batch on shaping its initial state;
    # the same draw is spent here, so that both loops train on the same
    # batches from the same seed
    next(iter(sampler.batches(rng, batch_size)))
    model_cls, family = POINTNET_MODELS[args.model]
    model = model_cls()
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    # PointNet's family adds 0.001 · the feature-transform regularizer
    step_fn = make_train_step(model, weighted_nll_loss, family=family)
    eval_fn = make_eval_step(model, device, family)
    weights = torch.from_numpy(
        np.asarray(rooms.label_weights, np.float32)).to(device)
    ckpt = CheckpointManager(f"{args.log_dir}/checkpoints")
    resumed = ckpt.restore_latest()
    start_epoch = 0
    if resumed:
        state.load_payload(resumed)
        start_epoch = resumed["epoch"]
        log.info("resumed from epoch %d", start_epoch)

    # FPS starts and dropout masks of every step (PointNet++), drawn on
    # the device
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    events = EventLog(f"{args.log_dir}/events.jsonl")
    tb = SummaryLogger(f"{args.log_dir}/tb")
    put = make_batch_put(device, depth)
    best_miou = 0.0
    for epoch in range(start_epoch, args.epochs):
        lr = pointnet2_lr(epoch, base=base_lr)
        bn_m = pointnet2_bn_momentum(epoch)
        t0 = time.time()

        # host pipeline: sample + augment + copy to the device on a
        # background thread; the RNG is read on that thread alone
        def _augmented():
            for pts, labels in sampler.batches(rng, batch_size):
                pts[:, :, :3] = augment.rotate_point_cloud_z(pts[:, :, :3], rng)
                yield pts, labels

        losses = []
        for batch in prefetch(_augmented(), put, depth=depth):
            pts, labels = wait_batch(batch)
            losses.append(step_fn(state, pts, labels, weights, lr, bn_m, gen))
        # one read of the device per EPOCH: reading each step's loss would
        # make the host wait for the device and sample only in between
        mean_loss, n_batches, nan_batches = _epoch_losses(losses)
        log.info(
            "epoch %d lr %.2g bn_m %.3f loss %.4f (%.1fs, %d batches, %d skipped)",
            epoch, lr, bn_m, mean_loss, time.time() - t0, n_batches, nan_batches,
        )
        events.write(
            "epoch", epoch=epoch, lr=lr, bn_momentum=bn_m, loss=mean_loss,
            nan_batches=nan_batches, batches=n_batches,
            seconds=time.time() - t0,
        )
        tb.scalars(epoch, loss=mean_loss, learning_rate=lr)
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            total, _ = evaluate_whole_scenes(
                eval_fn, test_rooms, block_points=args.npoint,
                batch_size=batch_size,
                rng=np.random.default_rng(args.seed),
            )
            miou = float(total.miou)
            log.info("epoch %d eval mIoU %.4f acc %.4f", epoch, miou,
                     float(total.accuracy))
            events.write("eval", epoch=epoch, miou=miou,
                         accuracy=float(total.accuracy))
            tb.scalars(epoch, miou=miou, accuracy=float(total.accuracy))
            best_miou = max(best_miou, miou)
            ckpt.save(epoch + 1, state.payload(), miou=miou)
    events.close()
    tb.close()
    log.info("best mIoU %.4f", best_miou)
    return state, best_miou


def _epoch_losses(losses: list) -> tuple[float, int, int]:
    """(mean finite loss, batches, batches the NaN guard skipped) from an
    epoch's device losses, read in one transfer."""
    losses_np = (torch.stack(losses).cpu().numpy() if losses
                 else np.zeros(0, np.float32))
    finite = np.isfinite(losses_np)
    nan_batches = int((~finite).sum())
    n_batches = int(losses_np.size)
    mean_loss = float(losses_np[finite].sum()) / max(n_batches - nan_batches, 1)
    return mean_loss, n_batches, nan_batches


def cls_lr(epoch: int, *, base: float = 0.001) -> float:
    """The upstream classification schedule: ×0.7 every 20 epochs."""
    return base * (0.7 ** (epoch // 20))


def train_cls(args, device: torch.device):
    """Train the classifier ``args.model`` (pointnet2_cls,
    pointnet2_cls_msg or pointnet_cls) on the ModelNet tree under
    ``args.data_root``; returns ``(state, best instance accuracy)``
    (JAX `train/loops.py:684-815`). Adam at ``args.learning_rate`` (0 →
    1e-3) with weight decay 1e-4 and ×0.7 every 20 epochs, NLL (PointNet:
    plus its aux loss), the random dropout, scale and shift of each batch,
    BatchNorm keep 0.9 (torch's 0.1, not annealed); the instance accuracy
    on the test split every ``args.eval_every`` epochs and after the last,
    each saved as a checkpoint with that accuracy as its metric. ``args``
    carries ``cli.train``'s flags (npoint: 0 → 1024, batch_size: 0 → 24,
    num_category, no_normals)."""
    from pointsecguard_tpu_torch.data import augment
    from pointsecguard_tpu_torch.data.loader import make_batch_put, prefetch, wait_batch
    from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset
    from pointsecguard_tpu_torch.models import init_parameters, weighted_nll_loss
    from pointsecguard_tpu_torch.train.object_eval import evaluate_cls
    from pointsecguard_tpu_torch.train.trainer import (
        TrainState,
        cls_model,
        make_logp_step,
        make_train_step,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager
    from pointsecguard_tpu_torch.utils.logging import EventLog, SummaryLogger

    npoint = args.npoint or 1024
    use_normals = not args.no_normals
    train_ds, test_ds = (ModelNetDataset(args.data_root, split, num_point=npoint,
                                         num_category=args.num_category,
                                         use_normals=use_normals)
                         for split in ("train", "test"))
    batch_size = args.batch_size or 24
    depth = getattr(args, "prefetch", 2)
    rng = np.random.default_rng(args.seed)
    # the JAX loop shapes its initial state on one batch: spent here too
    next(iter(train_ds.batches(rng, batch_size)))
    model, family = cls_model(args.model, train_ds.num_classes, use_normals)
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    step_fn = make_train_step(model, weighted_nll_loss, family=family)
    weights = torch.ones(train_ds.num_classes, device=device)
    ckpt = CheckpointManager(f"{args.log_dir}/checkpoints")
    resumed = ckpt.restore_latest()
    start_epoch = 0
    if resumed:
        state.load_payload(resumed)
        start_epoch = resumed["epoch"]
        log.info("resumed from epoch %d", start_epoch)

    logp_fn = make_logp_step(model, device, family)
    # FPS starts and dropout masks of every step, drawn on the device
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    events = EventLog(f"{args.log_dir}/events.jsonl")
    tb = SummaryLogger(f"{args.log_dir}/tb")
    put = make_batch_put(device, depth)
    best_acc = 0.0
    for epoch in range(start_epoch, args.epochs):
        lr = cls_lr(epoch, base=args.learning_rate or 0.001)
        t0 = time.time()

        def _augmented():  # on the prefetch thread, which alone reads the RNG
            for pts, labels in train_ds.batches(rng, batch_size):
                pts = augment.random_point_dropout(pts, rng)
                pts[:, :, :3] = augment.random_scale_point_cloud(pts[:, :, :3], rng)
                pts[:, :, :3] = augment.shift_point_cloud(pts[:, :, :3], rng)
                yield pts, labels

        losses = []
        for batch in prefetch(_augmented(), put, depth=depth):
            pts, labels = wait_batch(batch)
            # torch's BatchNorm fraction 0.1: the upstream driver does not anneal it
            losses.append(step_fn(state, pts, labels, weights, lr, 0.1, gen))
        mean_loss, n_batches, nan_batches = _epoch_losses(losses)
        seconds = time.time() - t0
        log.info("epoch %d lr %.2g loss %.4f (%.1fs, %d batches, %d skipped)",
                 epoch, lr, mean_loss, seconds, n_batches, nan_batches)
        events.write("epoch", epoch=epoch, lr=lr, loss=mean_loss, batches=n_batches,
                     nan_batches=nan_batches, seconds=seconds)
        tb.scalars(epoch, loss=mean_loss, learning_rate=lr)
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            inst_acc, class_acc, _ = evaluate_cls(logp_fn, test_ds, batch_size=batch_size)
            log.info("epoch %d eval instance acc %.4f class acc %.4f",
                     epoch, inst_acc, class_acc)
            events.write("eval", epoch=epoch, instance_accuracy=inst_acc,
                         class_accuracy=class_acc)
            tb.scalars(epoch, instance_accuracy=inst_acc, class_accuracy=class_acc)
            best_acc = max(best_acc, inst_acc)
            ckpt.save(epoch + 1, state.payload(), miou=inst_acc)
    events.close()
    tb.close()
    log.info("best instance accuracy %.4f", best_acc)
    return state, best_acc


def train_randla(args, device: torch.device):
    """Train RandLA-Net on the clouds prepared under ``args.randla_dir``
    (``cli.prepare``) for the ``--randla_dataset`` preset; returns
    ``(state, best mIoU)``. ``args`` carries ``cli.train``'s flags
    (randla_dir, randla_dataset, randla_points, log_dir, test_area, epochs,
    batch_size, learning_rate, steps_per_epoch, val_steps, seed, prefetch);
    0 means the preset config's value (S3DIS: batch 6, 40960 points;
    SemanticKITTI: 6, 45056; Semantic3D: 4, 65536; lr 1e-2, 500 steps and
    100 validation batches an epoch). The loss and the validation
    confusion leave the preset's ignored labels out and score in the
    reduced class space; the model takes xyz-only features (d_in 3) on
    SemanticKITTI."""
    from functools import partial

    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.data.loader import make_batch_put, prefetch, wait_batch
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import (
        RandLANet,
        init_parameters,
        weighted_softmax_ce_loss,
    )
    from pointsecguard_tpu_torch.train.schedules import randla_lr
    from pointsecguard_tpu_torch.train.trainer import (
        TrainState,
        make_eval_step,
        make_train_step,
        randla_family,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager
    from pointsecguard_tpu_torch.utils.logging import EventLog, SummaryLogger
    from pointsecguard_tpu_torch.utils.metrics import metrics_from_confusion

    preset = randla_dataset_preset(args.randla_dataset)
    cfg, num_classes = preset.cfg, preset.num_classes
    num_points = args.randla_points or cfg.num_points
    train_steps = args.steps_per_epoch or cfg.train_steps
    val_steps = args.val_steps or cfg.val_steps
    batch_size = args.batch_size or cfg.batch_size
    base_lr = args.learning_rate or cfg.learning_rate
    depth = getattr(args, "prefetch", 2)

    train_sampler = preset.make_sampler(args.randla_dir, "train", num_points,
                                        np.random.default_rng(args.seed),
                                        test_area=args.test_area)
    val_sampler = preset.make_sampler(args.randla_dir, "test", num_points,
                                      np.random.default_rng(args.seed + 9),
                                      test_area=args.test_area)
    # the JAX loop spends one sampler batch on shaping its initial state
    # (`loops.py:358`); it advances the possibilities, so it is spent here
    # too and both loops then train on the same clouds
    next(iter(train_sampler.batches(batch_size, 1)))
    model = RandLANet(num_classes=num_classes, d_out=cfg.d_out,
                      d_in=6 if preset.has_colors else 3)
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    family = randla_family(cfg)
    # the label table goes to the device once, so that no step waits on a copy
    loss_fn = (partial(weighted_softmax_ce_loss,
                       label_table=torch.from_numpy(preset.label_table()).to(device))
               if preset.ignored_labels else weighted_softmax_ce_loss)
    # tf.train.AdamOptimizer has no weight decay (`RandLANet.py:127`)
    step_fn = make_train_step(model, loss_fn, weight_decay=0.0, family=family)
    eval_fn = make_eval_step(model, device, family)
    # the reference's weights of the preset's dataset (`helper_tool.py:245-261`)
    weights = torch.from_numpy(get_class_weights(preset.weights_key)).to(device)
    ckpt = CheckpointManager(f"{args.log_dir}/checkpoints")
    resumed = ckpt.restore_latest()
    start_epoch = 0
    if resumed:
        state.load_payload(resumed)
        start_epoch = resumed["epoch"]
        log.info("resumed from epoch %d", start_epoch)

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)  # dropout masks
    events = EventLog(f"{args.log_dir}/events.jsonl")
    tb = SummaryLogger(f"{args.log_dir}/tb")
    put = make_batch_put(device, depth)
    best_miou = 0.0
    for epoch in range(start_epoch, args.epochs):
        lr = randla_lr(epoch, base=base_lr, decay=cfg.lr_decay)
        t0 = time.time()

        def _pairs():  # sampled on the prefetch thread, which alone reads its RNG
            for _, feats, labels, _, _ in train_sampler.batches(batch_size, train_steps):
                yield feats, labels

        losses = []
        for batch in prefetch(_pairs(), put, depth=depth):
            feats, labels = wait_batch(batch)
            # RandLA's BatchNorm keep is fixed: no momentum is passed
            losses.append(step_fn(state, feats, labels, weights, lr, None, gen))
        mean_loss, n_batches, nan_batches = _epoch_losses(losses)
        seconds = time.time() - t0
        log.info("epoch %d lr %.3g loss %.4f (%.1fs, %d batches, %d skipped)",
                 epoch, lr, mean_loss, seconds, n_batches, nan_batches)
        events.write("epoch", epoch=epoch, lr=lr, loss=mean_loss,
                     nan_batches=nan_batches, batches=n_batches, seconds=seconds)
        tb.scalars(epoch, loss=mean_loss, learning_rate=lr)

        # validation confusion over val_steps batches (`RandLANet.py:255-311`);
        # ignored labels are left out, the rest reduced to the valid classes
        # (`RandLANet.py:103-124`)
        cm = np.zeros((num_classes, num_classes))
        for _, feats, labels, _, _ in val_sampler.batches(cfg.val_batch_size, val_steps):
            valid, y = preset.reduce(labels.reshape(-1))
            np.add.at(cm, (y[valid], eval_fn(feats).reshape(-1)[valid]), 1)
        m = metrics_from_confusion(cm)
        log.info("epoch %d val mIoU %.4f acc %.4f", epoch, m.miou, m.accuracy)
        events.write("eval", epoch=epoch, miou=m.miou, accuracy=m.accuracy)
        tb.scalars(epoch, miou=m.miou, accuracy=m.accuracy)
        best_miou = max(best_miou, m.miou)
        ckpt.save(epoch + 1, state.payload(), miou=m.miou)
    events.close()
    tb.close()
    log.info("best mIoU %.4f", best_miou)
    return state, best_miou


def train_resgcn(args, device: torch.device):
    """Train ResGCN-28 on the rooms under ``args.data_root``; returns
    ``(state, None)`` (the loop does not evaluate, as in the JAX package).
    ``args`` carries ``cli.train``'s flags (data_root, log_dir, test_area,
    npoint, min_block_points, batch_size, learning_rate, seed, prefetch,
    epochs and the ``--resgcn_*`` overrides); 0 means the config's value
    (``configs.ResgcnConfig``: 4096 points, lr 1e-3) or batch 8."""
    from pointsecguard_tpu_torch.configs import ResgcnConfig, resgcn_overrides
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler
    from pointsecguard_tpu_torch.data.loader import make_batch_put, prefetch, wait_batch
    from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters
    from pointsecguard_tpu_torch.models.resgcn import ce_loss
    from pointsecguard_tpu_torch.train.schedules import resgcn_lr
    from pointsecguard_tpu_torch.train.trainer import (
        TrainState,
        make_train_step,
        resgcn_family,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager
    from pointsecguard_tpu_torch.utils.logging import EventLog, SummaryLogger

    cfg = ResgcnConfig()
    rooms = RoomSet.load(args.data_root, "train", args.test_area)
    sampler = S3DISBlockSampler(rooms, num_point=args.npoint or cfg.num_point,
                                min_points=getattr(args, "min_block_points", 1024))
    batch_size = args.batch_size or 8
    depth = getattr(args, "prefetch", 2)
    model_kwargs = dict(n_blocks=cfg.n_blocks, n_filters=cfg.n_filters, k=cfg.k,
                        epsilon=cfg.epsilon, dropout=cfg.dropout)
    model_kwargs.update(resgcn_overrides(args))

    rng = np.random.default_rng(args.seed)
    # the JAX loop shapes its initial state on one sampler batch: spent here too
    next(iter(sampler.batches(rng, batch_size)))
    model = DenseDeepGCN(**model_kwargs)
    # every BasicConv Dense takes flax's kaiming_normal (variance 2 / fan_in)
    init_parameters(model, torch.Generator().manual_seed(args.seed), scale=2.0)
    state = TrainState(model.to(device))
    # torch.optim.Adam without weight decay (`sem_seg_dense/train.py:31`)
    step_fn = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family())
    ones = torch.ones(13, device=device)  # the loss reads no class weights
    ckpt = CheckpointManager(f"{args.log_dir}/checkpoints", keep="latest")
    resumed = ckpt.restore_latest()
    start_epoch = 0
    if resumed:
        state.load_payload(resumed)
        start_epoch = resumed["epoch"]
        log.info("resumed from epoch %d", start_epoch)

    # stochastic dilation (epsilon > 0) and dropout draws of every step
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    events = EventLog(f"{args.log_dir}/events.jsonl")
    tb = SummaryLogger(f"{args.log_dir}/tb")
    put = make_batch_put(device, depth)
    for epoch in range(start_epoch, args.epochs):
        lr = resgcn_lr(epoch, base=args.learning_rate or cfg.lr)
        t0 = time.time()
        losses = []
        for batch in prefetch(sampler.batches(rng, batch_size), put, depth=depth):
            pts, labels = wait_batch(batch)
            # ResGCN's BatchNorm keep is fixed: no momentum is passed
            losses.append(step_fn(state, pts, labels, ones, lr, None, gen))
        mean_loss, n_batches, nan_batches = _epoch_losses(losses)
        seconds = time.time() - t0
        log.info("epoch %d lr %.3g loss %.4f (%.1fs, %d batches, %d skipped)",
                 epoch, lr, mean_loss, seconds, n_batches, nan_batches)
        events.write("epoch", epoch=epoch, lr=lr, loss=mean_loss,
                     nan_batches=nan_batches, batches=n_batches, seconds=seconds)
        tb.scalars(epoch, loss=mean_loss, learning_rate=lr)
        ckpt.save(epoch + 1, state.payload(), miou=-mean_loss)
    events.close()
    tb.close()
    return state, None
