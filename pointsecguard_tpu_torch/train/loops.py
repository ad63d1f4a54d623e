"""Training loops behind ``cli.train`` (port of
``pointsecguard_tpu/train/loops.py:71-971``): the PointNet family
(``--model pointnet2|pointnet2_msg|pointnet``) and ResGCN-28 (``--model
resgcn``) on the host block sampler, RandLA-Net on the spatially-regular
sampler, the ModelNet classifiers (``--model
pointnet2_cls|pointnet2_cls_msg|pointnet_cls``, ``train_cls``) and the
ShapeNetPart part-seg nets (``--model
pointnet2_part_seg|pointnet2_part_seg_msg|pointnet_part_seg``,
``train_partseg``).

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

The training extras of the JAX loops: every loop takes ``--steps_per_call
K`` (K steps a call on ``stack_batches``' stacks); the PointNet family and
ResGCN ``--device_sampler`` (the blocks drawn on the device,
``data.device_sampler``; ``--device_sampler_exact`` without replacement);
the PointNet family, ResGCN and RandLA on S3DIS or Semantic3D
``--adv_train nb`` (``trainer.make_adv_train_fn``); ResGCN ``--remat``;
the PointNet family ``--profile DIR`` (a trace of the first epoch's
training).

Every loop takes ``ctx``, the ``parallel.RankContext`` of a rank of
``--devices N`` (the PointNet family, RandLA and ResGCN also with
``--shard_points P``; the classifiers and part-seg nets data-parallel
only, as in JAX): every rank runs the host sampler from the same seed and
keeps its part of each global batch (``parallel.make_stacked_batch_put``),
the step is the data-parallel one of ``trainer.make_train_step``, random
draws are made for the global batch and sliced (``utils.runtime.batch_draw``),
evaluation runs each rank on its rows and gathers the predictions
(``parallel.dp_map``), and only rank 0 writes ``events.jsonl``, the
TensorBoard summaries and the checkpoints, from which every rank resumes.

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

from pointsecguard_tpu_torch.parallel import dp_map, is_main

log = logging.getLogger(__name__)


def _dtype(args) -> torch.dtype | None:
    """The models' ``dtype`` of ``--precision`` (JAX `train/loops.py:122-124`)."""
    from pointsecguard_tpu_torch.utils.runtime import model_dtype

    return model_dtype(getattr(args, "precision", "float32"))


def _steps_per_call(args) -> int:
    return max(getattr(args, "steps_per_call", 1) or 1, 1)


def _maybe_adv_fn(args, model, family, **kw):
    """``--adv_train nb`` → the step's batch-crafting hook
    (``trainer.make_adv_train_fn`` under the ``--adv_*`` budget; JAX
    `train/loops.py:42-68`); None without it."""
    if (getattr(args, "adv_train", "none") or "none") == "none":
        return None
    from pointsecguard_tpu_torch.attacks.pgd import PGDConfig
    from pointsecguard_tpu_torch.train.trainer import make_adv_train_fn

    cfg = PGDConfig(eps=args.adv_eps, alpha=args.adv_alpha, iters=args.adv_iters,
                    rand_init_eps=args.adv_rand_init)
    return make_adv_train_fn(model, family, cfg, **kw)


class _Silent:
    """The event log and summaries of a rank other than 0: writes nothing."""

    def write(self, *args, **kwargs) -> None:
        pass

    scalars = close = write


def _writers(args, ctx):
    """(events.jsonl log, TensorBoard summaries) of ``args.log_dir`` on the
    rank that writes the run's files; silent ones elsewhere."""
    from pointsecguard_tpu_torch.utils.logging import EventLog, SummaryLogger

    if not is_main(ctx):
        return _Silent(), _Silent()
    return EventLog(f"{args.log_dir}/events.jsonl"), SummaryLogger(f"{args.log_dir}/tb")


def _rank_setup(args, ctx, state, put, batch_size: int):
    """A rank's start: rank 0's initial state broadcast to every rank, and
    the loader's ``put`` of the rank's part of each stacked host batch (its
    rows, under ``--shard_points`` also its points shard). ``put`` as it
    is without a mesh."""
    if ctx is None:
        return put
    from pointsecguard_tpu_torch.parallel import make_stacked_batch_put, replicate

    replicate(ctx, [state.params, state.stats])
    cut = make_stacked_batch_put(ctx, batch_size=batch_size,
                                 shard_points=getattr(args, "shard_points", 1) > 1)

    def rank_put(item):
        pts, labels = item
        if np.ndim(labels) == 2:  # the classifiers' [K, B]: a leaf JAX replicates,
            labels = cut(labels[..., None])[..., 0]  # but a rank holds its rows
        else:
            labels = cut(labels)
        return put((np.ascontiguousarray(cut(pts)), np.ascontiguousarray(labels)))

    return rank_put


def _save(ctx, ckpt, epoch: int, state, metric: float) -> None:
    if is_main(ctx):
        ckpt.save(epoch, state.payload(), miou=metric)


def _host_epoch(multi_step, state, batches, put, depth: int, spc: int, weights, lr,
                bn_momentum, gen) -> list:
    """One epoch of the host pipeline: ``batches`` stacked ``spc`` deep,
    copied to the device on the prefetch thread, ``multi_step`` on each
    stack; the device losses, one tensor a call."""
    from pointsecguard_tpu_torch.data.loader import prefetch, stack_batches, wait_batch

    losses = []
    for batch in prefetch(stack_batches(batches, spc), put, depth=depth):
        pts, labels = wait_batch(batch)
        losses.append(multi_step(state, pts, labels, weights, lr, bn_momentum, gen))
    return losses


def _device_epoch_fn(args, rooms, n_samples: int, device, batch_size: int, num_point: int,
                     step_fn, augment_z: bool, ctx=None):
    """``--device_sampler``: the rooms staged on ``device``, and
    ``epoch(state, weights, lr, bn_momentum, gen) → losses`` running the
    host epoch's step count (``n_samples`` blocks, the host sampler's
    length, in batches; ``device_sampler.epoch_calls``) in calls of
    ``--steps_per_call`` steps of ``step_fn``, each on a batch sampled on
    the device; None without the flag."""
    if not getattr(args, "device_sampler", False):
        return None
    from pointsecguard_tpu_torch.data.device_sampler import (
        epoch_calls,
        make_device_block_sampler,
        make_sampled_multi_train_step,
        stage_rooms,
    )

    staged, num_max = stage_rooms(rooms, device)
    sample_fn = make_device_block_sampler(
        batch_size=batch_size, num_point=num_point, num_max=num_max,
        min_points=getattr(args, "min_block_points", 1024), augment_z=augment_z,
        replacement=not getattr(args, "device_sampler_exact", False))
    log.info("device sampler: %d rooms staged, %d bytes, window %d rows",
             len(rooms.names), staged.nbytes, num_max)
    dstep = make_sampled_multi_train_step(step_fn, sample_fn, ctx)
    calls = epoch_calls(n_samples, batch_size, _steps_per_call(args))

    def epoch(state, weights, lr, bn_momentum, gen):
        return [dstep(state, staged, weights, lr, bn_momentum, k, gen) for k in calls]

    return epoch


def train_pointnet_family(args, device: torch.device, ctx=None):
    """Train ``args.model`` (pointnet2, pointnet2_msg or pointnet) on the
    rooms under ``args.data_root``; returns ``(state, best mIoU)``. ``args`` carries
    ``cli.train``'s flags (data_root, log_dir, test_area, npoint,
    min_block_points, batch_size, learning_rate, seed, prefetch, epochs,
    eval_every, steps_per_call, device_sampler[_exact], adv_train and the
    adv_* budget, profile)."""
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, augment
    from pointsecguard_tpu_torch.data.loader import make_batch_put
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
        make_multi_train_step,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager
    from pointsecguard_tpu_torch.utils.profiling import maybe_trace

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
    model = model_cls(dtype=_dtype(args))
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    # PointNet's family adds 0.001 · the feature-transform regularizer
    multi_step = make_multi_train_step(model, weighted_nll_loss, family=family,
                                       adv_fn=_maybe_adv_fn(args, model, family), ctx=ctx)
    device_epoch = _device_epoch_fn(args, rooms, len(sampler), device, batch_size,
                                    args.npoint, multi_step.step, augment_z=True, ctx=ctx)
    spc = _steps_per_call(args)
    eval_fn = dp_map(make_eval_step(model, device, family), ctx)
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
    events, tb = _writers(args, ctx)
    put = _rank_setup(args, ctx, state, make_batch_put(device, depth), batch_size)
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

        # --profile: a trace of the first epoch's training
        # (rank 0's alone under --devices)
        with maybe_trace(getattr(args, "profile", None)
                         if epoch == start_epoch and is_main(ctx) else None,
                         device, f"epoch_{epoch}"):
            if device_epoch is not None:
                losses = device_epoch(state, weights, lr, bn_m, gen)
            else:
                losses = _host_epoch(multi_step, state, _augmented(), put, depth, spc,
                                     weights, lr, bn_m, gen)
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
            _save(ctx, ckpt, epoch + 1, state, miou)
    events.close()
    tb.close()
    log.info("best mIoU %.4f", best_miou)
    return state, best_miou


def _epoch_losses(losses: list) -> tuple[float, int, int]:
    """(mean finite loss, batches, batches the NaN guard skipped) from an
    epoch's device losses (one tensor a call), read in one transfer."""
    losses_np = (torch.cat([loss.reshape(-1) for loss in losses]).cpu().numpy() if losses
                 else np.zeros(0, np.float32))
    finite = np.isfinite(losses_np)
    nan_batches = int((~finite).sum())
    n_batches = int(losses_np.size)
    mean_loss = float(losses_np[finite].sum()) / max(n_batches - nan_batches, 1)
    return mean_loss, n_batches, nan_batches


def cls_lr(epoch: int, *, base: float = 0.001) -> float:
    """The upstream classification schedule: ×0.7 every 20 epochs."""
    return base * (0.7 ** (epoch // 20))


def train_cls(args, device: torch.device, ctx=None):
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
    num_category, no_normals, steps_per_call)."""
    from pointsecguard_tpu_torch.data import augment
    from pointsecguard_tpu_torch.data.loader import make_batch_put
    from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset
    from pointsecguard_tpu_torch.models import init_parameters, weighted_nll_loss
    from pointsecguard_tpu_torch.train.object_eval import evaluate_cls
    from pointsecguard_tpu_torch.train.trainer import (
        TrainState,
        cls_model,
        make_logp_step,
        make_multi_train_step,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

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
    model, family = cls_model(args.model, train_ds.num_classes, use_normals, _dtype(args))
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    multi_step = make_multi_train_step(model, weighted_nll_loss, family=family, ctx=ctx)
    weights = torch.ones(train_ds.num_classes, device=device)
    ckpt = CheckpointManager(f"{args.log_dir}/checkpoints")
    resumed = ckpt.restore_latest()
    start_epoch = 0
    if resumed:
        state.load_payload(resumed)
        start_epoch = resumed["epoch"]
        log.info("resumed from epoch %d", start_epoch)

    logp_fn = dp_map(make_logp_step(model, device, family), ctx)
    # FPS starts and dropout masks of every step, drawn on the device
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    events, tb = _writers(args, ctx)
    put = _rank_setup(args, ctx, state, make_batch_put(device, depth), batch_size)
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

        # torch's BatchNorm fraction 0.1: the upstream driver does not anneal it
        losses = _host_epoch(multi_step, state, _augmented(), put, depth, _steps_per_call(args),
                             weights, lr, 0.1, gen)
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
            _save(ctx, ckpt, epoch + 1, state, inst_acc)
    events.close()
    tb.close()
    log.info("best instance accuracy %.4f", best_acc)
    return state, best_acc


def partseg_lr(epoch: int, *, base: float = 0.001) -> float:
    """The upstream part-seg schedule: ×0.5 every 20 epochs, floor 1e-5."""
    return max(base * (0.5 ** (epoch // 20)), 1e-5)


def train_partseg(args, device: torch.device, ctx=None):
    """Train the part-seg net ``args.model`` (pointnet2_part_seg,
    pointnet2_part_seg_msg or pointnet_part_seg) on the ShapeNetPart tree
    under ``args.data_root``; returns ``(state, best instance mIoU)`` (JAX
    `train/loops.py:818-971`). The train and val splits, each shape
    resampled to ``npoint`` points with replacement, the random scale and
    shift of each batch; NLL over the 50 parts (PointNet: plus its aux
    loss), Adam at ``args.learning_rate`` (0 → 1e-3) with weight decay 1e-4
    and ×0.5 every 20 epochs, the BatchNorm momentum annealed ×0.5 every 20
    epochs (floor 0.01); the instance mIoU on the test split every
    ``args.eval_every`` epochs and after the last, each saved as a
    checkpoint with it as its metric. The category one-hot rides as 16
    trailing channels of the points (``trainer._unpack``). ``args`` carries
    ``cli.train``'s flags (npoint: 0 → 2048, batch_size: 0 → 16,
    no_normals, steps_per_call)."""
    from pointsecguard_tpu_torch.data import augment
    from pointsecguard_tpu_torch.data.loader import make_batch_put
    from pointsecguard_tpu_torch.data.shapenet_part import (
        NUM_OBJECT_CLASSES,
        NUM_PART_CLASSES,
        ShapeNetPartDataset,
    )
    from pointsecguard_tpu_torch.models import init_parameters, weighted_nll_loss
    from pointsecguard_tpu_torch.train.object_eval import evaluate_partseg
    from pointsecguard_tpu_torch.train.schedules import pointnet2_bn_momentum
    from pointsecguard_tpu_torch.train.trainer import (
        TrainState,
        cls_model,
        make_logp_step,
        make_multi_train_step,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

    npoint = args.npoint or 2048
    use_normals = not args.no_normals
    train_ds, test_ds = (ShapeNetPartDataset(args.data_root, split, num_point=npoint,
                                             use_normals=use_normals)
                         for split in ("trainval", "test"))
    batch_size = args.batch_size or 16
    depth = getattr(args, "prefetch", 2)
    eye = np.eye(NUM_OBJECT_CLASSES, dtype=np.float32)

    def pack(pts, onehot):
        return np.concatenate(
            [pts, np.broadcast_to(onehot[:, None], (*pts.shape[:2], NUM_OBJECT_CLASSES))], axis=2)

    def packed(batches):
        for pts, cls, seg in batches:
            yield pack(pts, eye[cls]), seg

    rng = np.random.default_rng(args.seed)
    # the JAX loop shapes its initial state on one batch: spent here too
    next(packed(train_ds.batches(rng, batch_size)))
    model, family = cls_model(args.model, NUM_PART_CLASSES, use_normals, _dtype(args))
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    multi_step = make_multi_train_step(model, weighted_nll_loss, family=family, ctx=ctx)
    weights = torch.ones(NUM_PART_CLASSES, device=device)
    ckpt = CheckpointManager(f"{args.log_dir}/checkpoints")
    resumed = ckpt.restore_latest()
    start_epoch = 0
    if resumed:
        state.load_payload(resumed)
        start_epoch = resumed["epoch"]
        log.info("resumed from epoch %d", start_epoch)

    logp_fn = dp_map(make_logp_step(model, device, family), ctx)
    # FPS starts and dropout masks of every step, drawn on the device
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    events, tb = _writers(args, ctx)
    put = _rank_setup(args, ctx, state, make_batch_put(device, depth), batch_size)
    best_miou = 0.0
    for epoch in range(start_epoch, args.epochs):
        lr = partseg_lr(epoch, base=args.learning_rate or 0.001)
        bn_m = pointnet2_bn_momentum(epoch, step_size=20)
        t0 = time.time()

        def _augmented():  # on the prefetch thread, which alone reads the RNG
            for pts, seg in packed(train_ds.batches(rng, batch_size)):
                pts[:, :, :3] = augment.random_scale_point_cloud(pts[:, :, :3], rng)
                pts[:, :, :3] = augment.shift_point_cloud(pts[:, :, :3], rng)
                yield pts, seg

        losses = _host_epoch(multi_step, state, _augmented(), put, depth, _steps_per_call(args),
                             weights, lr, bn_m, gen)
        mean_loss, n_batches, nan_batches = _epoch_losses(losses)
        seconds = time.time() - t0
        log.info("epoch %d lr %.2g loss %.4f (%.1fs, %d batches, %d skipped)",
                 epoch, lr, mean_loss, seconds, n_batches, nan_batches)
        events.write("epoch", epoch=epoch, lr=lr, bn_momentum=bn_m, loss=mean_loss,
                     batches=n_batches, nan_batches=nan_batches, seconds=seconds)
        tb.scalars(epoch, loss=mean_loss, learning_rate=lr)
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            metrics = evaluate_partseg(lambda p, oh: logp_fn(pack(p, oh)), test_ds,
                                       batch_size=batch_size)
            log.info("epoch %d eval instance mIoU %.4f class mIoU %.4f acc %.4f", epoch,
                     metrics["instance_miou"], metrics["class_avg_miou"], metrics["accuracy"])
            events.write("eval", epoch=epoch, **{k: v for k, v in metrics.items()
                                                 if k != "category_miou"})
            tb.scalars(epoch, instance_miou=metrics["instance_miou"],
                       accuracy=metrics["accuracy"])
            best_miou = max(best_miou, metrics["instance_miou"])
            _save(ctx, ckpt, epoch + 1, state, metrics["instance_miou"])
    events.close()
    tb.close()
    log.info("best instance mIoU %.4f", best_miou)
    return state, best_miou


def train_randla(args, device: torch.device, ctx=None):
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
    SemanticKITTI. ``--steps_per_call`` and ``--adv_train nb`` (S3DIS and
    Semantic3D: SemanticKITTI has no colours to perturb, and
    ``cli.train`` refuses it there) as in the JAX loop."""
    from functools import partial

    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.data.loader import make_batch_put
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
        make_multi_train_step,
        randla_family,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager
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
                      d_in=6 if preset.has_colors else 3, dtype=_dtype(args))
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    family = randla_family(cfg, sp=ctx if getattr(args, "shard_points", 1) > 1 else None)
    # the label table goes to the device once, so that no step waits on a copy
    loss_fn = (partial(weighted_softmax_ce_loss,
                       label_table=torch.from_numpy(preset.label_table()).to(device))
               if preset.ignored_labels else weighted_softmax_ce_loss)
    # tf.train.AdamOptimizer has no weight decay (`RandLANet.py:127`)
    adv_fn = _maybe_adv_fn(args, model, family, ignored_labels=preset.ignored_labels,
                           num_classes=num_classes)
    multi_step = make_multi_train_step(model, loss_fn, weight_decay=0.0, family=family,
                                       adv_fn=adv_fn, ctx=ctx)
    eval_fn = dp_map(make_eval_step(model, device, family), ctx)
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
    events, tb = _writers(args, ctx)
    put = _rank_setup(args, ctx, state, make_batch_put(device, depth), batch_size)
    best_miou = 0.0
    for epoch in range(start_epoch, args.epochs):
        lr = randla_lr(epoch, base=base_lr, decay=cfg.lr_decay)
        t0 = time.time()

        def _pairs():  # sampled on the prefetch thread, which alone reads its RNG
            for _, feats, labels, _, _ in train_sampler.batches(batch_size, train_steps):
                yield feats, labels

        # RandLA's BatchNorm keep is fixed: no momentum is passed
        losses = _host_epoch(multi_step, state, _pairs(), put, depth, _steps_per_call(args),
                             weights, lr, None, gen)
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
        _save(ctx, ckpt, epoch + 1, state, m.miou)
    events.close()
    tb.close()
    log.info("best mIoU %.4f", best_miou)
    return state, best_miou


def train_resgcn(args, device: torch.device, ctx=None):
    """Train ResGCN-28 on the rooms under ``args.data_root``; returns
    ``(state, None)`` (the loop does not evaluate, as in the JAX package).
    ``args`` carries ``cli.train``'s flags (data_root, log_dir, test_area,
    npoint, min_block_points, batch_size, learning_rate, seed, prefetch,
    epochs and the ``--resgcn_*`` overrides, steps_per_call,
    device_sampler[_exact] (no z-rotation: the host loop feeds raw blocks),
    adv_train and the adv_* budget, remat); 0 means the config's value
    (``configs.ResgcnConfig``: 4096 points, lr 1e-3) or batch 8."""
    from pointsecguard_tpu_torch.configs import ResgcnConfig, resgcn_overrides
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler
    from pointsecguard_tpu_torch.data.loader import make_batch_put
    from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters
    from pointsecguard_tpu_torch.models.resgcn import ce_loss
    from pointsecguard_tpu_torch.train.schedules import resgcn_lr
    from pointsecguard_tpu_torch.train.trainer import (
        TrainState,
        make_multi_train_step,
        resgcn_family,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

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
    model = DenseDeepGCN(**model_kwargs, remat=getattr(args, "remat", False),
                         dtype=_dtype(args))
    # every BasicConv Dense takes flax's kaiming_normal (variance 2 / fan_in)
    init_parameters(model, torch.Generator().manual_seed(args.seed), scale=2.0)
    state = TrainState(model.to(device))
    # torch.optim.Adam without weight decay (`sem_seg_dense/train.py:31`)
    family = resgcn_family()
    multi_step = make_multi_train_step(model, ce_loss, weight_decay=0.0, family=family,
                                       adv_fn=_maybe_adv_fn(args, model, family), ctx=ctx)
    device_epoch = _device_epoch_fn(args, rooms, len(sampler), device, batch_size,
                                    args.npoint or cfg.num_point, multi_step.step,
                                    augment_z=False, ctx=ctx)
    spc = _steps_per_call(args)
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
    events, tb = _writers(args, ctx)
    put = _rank_setup(args, ctx, state, make_batch_put(device, depth), batch_size)
    for epoch in range(start_epoch, args.epochs):
        lr = resgcn_lr(epoch, base=args.learning_rate or cfg.lr)
        t0 = time.time()
        # ResGCN's BatchNorm keep is fixed: no momentum is passed
        if device_epoch is not None:
            losses = device_epoch(state, ones, lr, None, gen)
        else:
            losses = _host_epoch(multi_step, state, sampler.batches(rng, batch_size), put,
                                 depth, spc, ones, lr, None, gen)
        mean_loss, n_batches, nan_batches = _epoch_losses(losses)
        seconds = time.time() - t0
        log.info("epoch %d lr %.3g loss %.4f (%.1fs, %d batches, %d skipped)",
                 epoch, lr, mean_loss, seconds, n_batches, nan_batches)
        events.write("epoch", epoch=epoch, lr=lr, loss=mean_loss,
                     nan_batches=nan_batches, batches=n_batches, seconds=seconds)
        tb.scalars(epoch, loss=mean_loss, learning_rate=lr)
        _save(ctx, ckpt, epoch + 1, state, -mean_loss)
    events.close()
    tb.close()
    return state, None
