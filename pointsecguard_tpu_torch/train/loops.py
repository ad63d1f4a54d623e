"""Training loop of the PointNet family behind ``cli.train`` (port of
``pointsecguard_tpu/train/loops.py:71-285`` for ``--model pointnet2`` on
the host sampler).

Semantics of the reference script `train_semseg.py:148-265`: z-rotation
augmentation, weighted NLL, Adam with step decay and the BatchNorm
momentum anneal, whole-scene eval, best-mIoU checkpointing, auto-resume.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def train_pointnet_family(args, device: torch.device):
    """Train ``args.model`` (pointnet2) on the rooms under
    ``args.data_root``; returns ``(state, best mIoU)``. ``args`` carries
    ``cli.train``'s flags (data_root, log_dir, test_area, npoint,
    min_block_points, batch_size, learning_rate, seed, prefetch, epochs,
    eval_every)."""
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, augment
    from pointsecguard_tpu_torch.data.loader import make_batch_put, prefetch, wait_batch
    from pointsecguard_tpu_torch.models import (
        PointNet2SemSegSSG,
        init_parameters,
        weighted_nll_loss,
    )
    from pointsecguard_tpu_torch.train.evaluator import evaluate_whole_scenes
    from pointsecguard_tpu_torch.train.schedules import (
        pointnet2_bn_momentum,
        pointnet2_lr,
    )
    from pointsecguard_tpu_torch.train.trainer import (
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
    model = PointNet2SemSegSSG()
    init_parameters(model, torch.Generator().manual_seed(args.seed))
    state = TrainState(model.to(device))
    step_fn = make_train_step(model, weighted_nll_loss)
    eval_fn = make_eval_step(model, device)
    weights = torch.from_numpy(
        np.asarray(rooms.label_weights, np.float32)).to(device)
    ckpt = CheckpointManager(f"{args.log_dir}/checkpoints")
    resumed = ckpt.restore_latest()
    start_epoch = 0
    if resumed:
        state.load_payload(resumed)
        start_epoch = resumed["epoch"]
        log.info("resumed from epoch %d", start_epoch)

    # FPS starts and dropout masks of every step, drawn on the device
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
        losses_np = (
            torch.stack(losses).cpu().numpy() if losses
            else np.zeros(0, np.float32)
        )
        finite = np.isfinite(losses_np)
        nan_batches = int((~finite).sum())  # updates skipped by the NaN guard
        n_batches = int(losses_np.size)
        loss_sum = float(losses_np[finite].sum())
        mean_loss = loss_sum / max(n_batches - nan_batches, 1)
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
