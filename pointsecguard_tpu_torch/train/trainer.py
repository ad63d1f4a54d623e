"""Training step of the segmentation and object-task models (port of
``pointsecguard_tpu/train/trainer.py:31-331``).

One step is: the family's neighbour plan (PointNet++ SSG and MSG, their
classifiers and part-seg nets: train-mode geometry with random FPS
starts; RandLA-Net: the kNN pyramid; ResGCN: none, its graphs are built
inside the forward; PointNet: none, it has no neighbourhoods), train-mode
forward, loss (with PointNet's
feature-transform term), backward, Adam update and the BatchNorm running
statistics. A ``Family`` says how a model family is called, as the JAX
step's ``model_args`` / ``output_head`` do. The lr and the BatchNorm
momentum are call arguments, so the per-epoch annealing of the reference
(`train_semseg.py:136-159`) needs no rebuild. ``make_multi_train_step``
runs K such steps a call (``--steps_per_call``), ``make_adv_train_fn``
crafts each step's batch first (``--adv_train nb``).

Nothing in a step reads the device: the loss stays a device tensor (the
epoch loop reads all of an epoch's losses at once), and the guard that
skips a batch with a non-finite loss selects old or new state on the
device. For that the state is kept flat: the model's parameters are views
into one buffer, their gradients views into a second, the BatchNorm
statistics views into a third, and Adam's moments are two more buffers of
the parameters' size. The update and the guard are then a dozen
elementwise kernels whatever the number of layers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from pointsecguard_tpu_torch.configs import RandlaConfig
from pointsecguard_tpu_torch.models import registry
from pointsecguard_tpu_torch.models.pointnet import PointNetSemSeg, pointnet_aux_loss
from pointsecguard_tpu_torch.models.pointnet2 import (
    PointNet2SemSegMSG,
    PointNet2SemSegSSG,
    build_geometry,
    build_geometry_msg,
)
from pointsecguard_tpu_torch.models.pointnet2_cls import (
    NUM_OBJECT_CLASSES,
    build_geometry_cls,
    build_geometry_cls_msg,
    build_geometry_partseg,
    build_geometry_partseg_msg,
)
from pointsecguard_tpu_torch.models.randlanet import build_pyramid

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Family(NamedTuple):
    """How the step calls one model family.

    ``plan(points, generator=None, start_idx=None)`` builds the neighbour
    plan from the points' xyz; ``apply(model, points, plan, bn_momentum,
    generator=, dropout_mask=)`` runs the forward (``bn_momentum`` is
    torch's share of the batch statistic, None in evaluation); ``head``
    picks the per-point scores that the loss and the argmax read;
    ``aux_loss(out)``, where there is one, is the JAX step's hook of the
    same name (`trainer.py:166-188`): a training loss added to the
    head's."""

    plan: Callable
    apply: Callable
    head: Callable
    aux_loss: Callable | None = None


def _pointnet2_apply(model, points, plan, bn_momentum=None, **kw):
    # the model takes BatchNorm's keep fraction 1 − m
    keep = 0.9 if bn_momentum is None else 1.0 - bn_momentum
    return model(points, geometry=plan, momentum=keep, **kw)


POINTNET2 = Family(
    plan=lambda points, generator=None, start_idx=None: build_geometry(
        points[..., :3], generator=generator, start_idx=start_idx),
    apply=_pointnet2_apply,
    head=lambda out: out[0],  # log-probabilities
)
# MSG: the same draws of the generator (four FPS starts of [B], then the
# dropout mask) over one ball query per radius
POINTNET2_MSG = POINTNET2._replace(
    plan=lambda points, generator=None, start_idx=None: build_geometry_msg(
        points[..., :3], generator=generator, start_idx=start_idx))


def _pointnet_apply(model, points, plan, bn_momentum=None, **kw):
    # no neighbourhood and no dropout: the plan and the draws go unread
    return model(points, momentum=0.9 if bn_momentum is None else 1.0 - bn_momentum)


POINTNET = Family(plan=lambda points, generator=None, start_idx=None: None,
                  apply=_pointnet_apply, head=lambda out: out[0],
                  aux_loss=pointnet_aux_loss)
# the block models of the PointNet family by their ``--model`` name: the
# model class and its family
POINTNET_MODELS = {
    "pointnet2": (PointNet2SemSegSSG, POINTNET2),
    "pointnet2_msg": (PointNet2SemSegMSG, POINTNET2_MSG),
    "pointnet": (PointNetSemSeg, POINTNET),
}


def _pointnet2_cls_apply(model, points, plan, bn_momentum=None, *, generator=None,
                        dropout_mask=None):
    keep = 0.9 if bn_momentum is None else 1.0 - bn_momentum
    return model(points, geometry=plan, momentum=keep, generator=generator,
                 dropout_masks=dropout_mask)


# the classifiers: the plan is the two SA levels' geometry (training: one
# random FPS start per cloud and level, two draws of [B], then the head's
# two dropout masks); the head is the log-probabilities [B, K]
POINTNET2_CLS = Family(
    plan=lambda points, generator=None, start_idx=None: build_geometry_cls(
        points[..., :3], generator=generator, start_idx=start_idx),
    apply=_pointnet2_cls_apply, head=lambda out: out[0])
POINTNET2_CLS_MSG = POINTNET2_CLS._replace(
    plan=lambda points, generator=None, start_idx=None: build_geometry_cls_msg(
        points[..., :3], generator=generator, start_idx=start_idx))


def _pointnet_cls_apply(model, points, plan, bn_momentum=None, *, generator=None,
                        dropout_mask=None):
    keep = 0.9 if bn_momentum is None else 1.0 - bn_momentum
    return model(points, momentum=keep, generator=generator, dropout_mask=dropout_mask)


POINTNET_CLS = Family(plan=lambda points, generator=None, start_idx=None: None,
                      apply=_pointnet_cls_apply, head=lambda out: out[0],
                      aux_loss=pointnet_aux_loss)
# the classifiers by their ``--model`` name: the registry's name and the family
CLS_MODELS = {
    "pointnet2_cls": ("pointnet2_cls_ssg", POINTNET2_CLS),
    "pointnet2_cls_msg": ("pointnet2_cls_msg", POINTNET2_CLS_MSG),
    "pointnet_cls": ("pointnet_cls", POINTNET_CLS),
}


def _unpack(points):
    """A part-seg batch's points [B, N, C + 16] → (points [B, N, C], the
    category one-hot [B, 16]): the one-hot rides as 16 constant trailing
    channels, as in the JAX loop (`train/loops.py:875-885`), so that the
    step's (points, labels) contract and the plan's ``points[..., :3]``
    hold."""
    return points[..., :-NUM_OBJECT_CLASSES], points[:, 0, -NUM_OBJECT_CLASSES:]


def _partseg_apply(model, points, plan, bn_momentum=None, *, generator=None,
                   dropout_mask=None):
    keep = 0.9 if bn_momentum is None else 1.0 - bn_momentum
    return model(*_unpack(points), geometry=plan, momentum=keep, generator=generator,
                 dropout_mask=dropout_mask)


# the PointNet++ part-seg nets: the plan is the two SA levels and the two
# 3-NN hops (training: one random FPS start per shape and level, two draws
# of [B], then the head's dropout mask [B, N, 128]); the head the per-point
# log-probabilities [B, N, 50]
POINTNET2_PARTSEG = Family(
    plan=lambda points, generator=None, start_idx=None: build_geometry_partseg(
        points[..., :3], generator=generator, start_idx=start_idx),
    apply=_partseg_apply, head=lambda out: out[0])
POINTNET2_PARTSEG_MSG = POINTNET2_PARTSEG._replace(
    plan=lambda points, generator=None, start_idx=None: build_geometry_partseg_msg(
        points[..., :3], generator=generator, start_idx=start_idx))


def _pointnet_partseg_apply(model, points, plan, bn_momentum=None, **kw):
    # no neighbourhood and no dropout: the plan and the draws go unread
    return model(*_unpack(points), momentum=0.9 if bn_momentum is None else 1.0 - bn_momentum)


POINTNET_PARTSEG = Family(plan=lambda points, generator=None, start_idx=None: None,
                          apply=_pointnet_partseg_apply, head=lambda out: out[0],
                          aux_loss=pointnet_aux_loss)
# the part-seg nets by their ``--model`` name: the registry's name and the family
PARTSEG_MODELS = {
    "pointnet2_part_seg": ("pointnet2_part_seg_ssg", POINTNET2_PARTSEG),
    "pointnet2_part_seg_msg": ("pointnet2_part_seg_msg", POINTNET2_PARTSEG_MSG),
    "pointnet_part_seg": ("pointnet_part_seg", POINTNET_PARTSEG),
}


def cls_model(name: str, num_classes: int, use_normals: bool = True,
              dtype: torch.dtype | None = None):
    """(model, family) of the object-task model ``--model name``, a
    classifier or a part-seg net (the JAX ``_cls_partseg_model``,
    `train/loops.py:613-671`): the loss is NLL, PointNet's plus 0.001 times
    the feature-transform regularizer (its family's ``aux_loss``). A
    part-seg family's points carry the category one-hot as 16 trailing
    channels (``_unpack``). ``dtype``: the model's (``models/common.py``)."""
    registered, family = {**CLS_MODELS, **PARTSEG_MODELS}[name]
    # PointNetPartSeg keeps the reference's name for its width
    width = {"part_num" if name == "pointnet_part_seg" else "num_classes": num_classes}
    return (registry.create(registered, normal_channel=use_normals, dtype=dtype, **width),
            family)


def randla_family(cfg: RandlaConfig | None = None, sp=None) -> Family:
    """RandLA-Net: the plan is ``build_pyramid`` of the config's depth,
    the head the logits. Its BatchNorm keep fraction is fixed at 0.99, as
    the JAX model's (`pointsecguard_tpu/models/randlanet.py:321-328`
    drops the trainer's momentum), so ``apply`` reads no ``bn_momentum``.
    ``sp``: the rank context of a ``--shard_points`` run, whose pyramid
    runs the points-sharded kNN (``build_pyramid(sp=...)``)."""
    cfg = cfg or RandlaConfig()

    def plan(points, generator=None, start_idx=None):
        return build_pyramid(points[..., :3], num_layers=cfg.num_layers, k=cfg.k_n,
                             sub_ratios=cfg.sub_sampling_ratio, sp=sp)

    def apply(model, points, pyramid, bn_momentum=None, **kw):
        return model(points, pyramid, **kw)

    return Family(plan=plan, apply=apply, head=lambda out: out)


def resgcn_family() -> Family:
    """ResGCN-28: the kNN graphs are built inside the forward from the
    features of each block, so the plan is None (a plan given to the step
    as ``geometry=`` is the graphs, pinned); ``apply`` passes the
    generator of the stochastic dilation and dropout; the head is the
    logits. Its BatchNorm keep is fixed at 0.9 (the JAX model drops the
    trainer's momentum, `pointsecguard_tpu/models/resgcn.py:210-212`)."""

    def apply(model, points, graphs, bn_momentum=None, **kw):
        return model(points, graphs=graphs, **kw)

    return Family(plan=lambda points, generator=None, start_idx=None: None,
                  apply=apply, head=lambda out: out)


def _flatten(tensors: list[torch.Tensor]) -> torch.Tensor:
    """One buffer holding ``tensors``; each tensor becomes a view into it."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    offset = 0
    for t in tensors:
        t.data = flat[offset : offset + t.numel()].view_as(t)
        offset += t.numel()
    return flat


class TrainState:
    """Model, Adam moments and step counts of one training run.

    Build it after the model is on its device; ``model.to(...)`` afterwards
    would separate the parameters from the flat buffers. ``count`` is
    Adam's number of updates (a device tensor: a skipped batch leaves it
    as it was); ``step`` counts every batch, skipped or not, as the JAX
    ``TrainState.step`` does.
    """

    def __init__(self, model: nn.Module):
        self.model = model
        params = [p for p in model.parameters()]
        self.params = _flatten(params)
        self.grads = torch.zeros_like(self.params)
        offset = 0
        for p in params:
            p.grad = self.grads[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        self.stats = _flatten([b for b in model.buffers()])
        self.mu = torch.zeros_like(self.params)
        self.nu = torch.zeros_like(self.params)
        self.count = torch.zeros((), dtype=torch.float64, device=self.params.device)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.params.device

    def payload(self) -> dict:
        """What a checkpoint holds (``utils.checkpoint.CheckpointManager``)."""
        return {"model": self.model.state_dict(), "mu": self.mu, "nu": self.nu,
                "count": self.count, "step": self.step}

    def load_payload(self, payload: dict) -> None:
        self.model.load_state_dict(payload["model"])  # in place: views stay
        self.mu.copy_(payload["mu"])
        self.nu.copy_(payload["nu"])
        self.count.copy_(payload["count"])
        self.step = int(payload["step"])


@torch.no_grad()
def adam_update(state: TrainState, lr: float, *, weight_decay: float = 1e-4) -> None:
    """One update of ``state.params`` from ``state.grads``, in place: the
    JAX package's ``make_optimizer`` followed by ``p − lr·u``
    (`trainer.py:38-45, 126-131`). L2 of ``weight_decay`` is added to the
    gradient *before* the moments (torch ``Adam(weight_decay=...)``,
    `train_semseg.py:126-132`), β 0.9 / 0.999, ε 1e-8 outside the root."""
    g = torch.add(state.grads, state.params, alpha=weight_decay)
    state.mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
    state.nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
    state.count.add_(1.0)
    mu_hat = state.mu / (1.0 - ADAM_B1 ** state.count)
    nu_hat = state.nu / (1.0 - ADAM_B2 ** state.count)
    state.params.sub_(mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS), alpha=lr)


def make_train_step(
    model: nn.Module,
    loss_fn: Callable,
    *,
    weight_decay: float = 1e-4,
    family: Family = POINTNET2,
    adv_fn: Callable | None = None,
    ctx=None,
) -> Callable:
    """Build ``train_step(state, points, labels, class_weights, lr,
    bn_momentum, generator=None, *, start_idx=None, dropout_mask=None,
    geometry=None) → loss`` (a device tensor).

    ``bn_momentum`` is torch's (the share of the batch statistic); a
    PointNet++ model takes the keep fraction ``1 − bn_momentum``, a RandLA
    model none (see ``randla_family``). ``generator`` (on the model's
    device) gives PointNet++'s FPS starts, four draws of [B], and then the
    dropout mask; ``start_idx`` and ``dropout_mask`` fix them instead, and
    ``geometry`` (a plan of ``family.plan``) replaces the step's own, so
    that two devices can be held against each other on one plan.
    ``weight_decay`` is the L2 term of ``adam_update`` (RandLA: 0,
    ``tf.train.AdamOptimizer`` has none). The family's ``aux_loss``
    adds to the loss before the backward (PointNet's
    ``0.001 · feature_transform_regularizer``). ``adv_fn(points, labels,
    generator) → points`` (``make_adv_train_fn``) first replaces the batch
    by one crafted against the current parameters, drawing its random
    start from ``generator`` before the step's own draws.

    NaN guard: on a non-finite loss (the sum, where there is an aux term)
    the step keeps the previous parameters, Adam moments and count, and
    BatchNorm statistics (the reference's only failure handling was
    RandLA's NaN catch that ended the run, `RandLANet.py:237-247`). The
    returned loss still reports the bad value, so that the epoch loop can
    count it.

    ``ctx`` (a ``parallel.RankContext``): one rank of a data-parallel step.
    ``points`` and ``labels`` are the rank's rows of the global batch (and
    under ``--shard_points`` its shard of their points axis, which is
    all-gathered over the points group first: the whole clouds run on every
    rank of the group). The head — under ``--shard_points`` the rank's
    points shard of it — and the labels are gathered into the global batch
    (``parallel.gather_for_loss``), so that every rank computes the one
    global loss, whose class-weight sum or point count is the global one,
    and its backward reaches the rank's parameters through its own rows
    only; the gradient is then summed over the ranks before the update.
    BatchNorm takes global statistics (``parallel.sync_batchnorm``). So
    every rank applies the same update to the same parameters, and the
    step equals the one-process step on the whole batch.
    """
    from pointsecguard_tpu_torch.parallel.spmd_ops import (
        all_gather,
        all_reduce_sum,
        gather_for_loss,
        points_shard,
        sync_batchnorm,
    )

    sp = ctx is not None and ctx.points_size > 1
    if ctx is not None:
        sync_batchnorm(model, ctx)

    def global_loss(out, labels, class_weights):
        # without a ctx every gather is the tensor itself: the one-process loss
        head = gather_for_loss(points_shard(family.head(out), ctx) if sp else family.head(out),
                               ctx, per_point=sp)
        loss = loss_fn(head, gather_for_loss(labels, ctx), class_weights)
        if family.aux_loss is not None:  # per-sample outputs, replicated over points
            loss = loss + family.aux_loss((head, *(gather_for_loss(o, ctx) for o in out[1:])))
        return loss

    def train_step(state: TrainState, points, labels, class_weights, lr,
                   bn_momentum, generator=None, *, start_idx=None,
                   dropout_mask=None, geometry=None):
        if sp:
            points = all_gather(points, ctx.points_group, dim=1)
            labels = all_gather(labels, ctx.points_group, dim=1)
        if adv_fn is not None:
            points = adv_fn(points, labels, generator)
        model.train()
        if geometry is None:
            geometry = family.plan(points, generator=generator, start_idx=start_idx)
        old = (state.params.clone(), state.mu.clone(), state.nu.clone(),
               state.count.clone(), state.stats.clone())
        state.grads.zero_()
        out = family.apply(model, points, geometry, bn_momentum,
                           generator=generator, dropout_mask=dropout_mask)
        loss = global_loss(out, labels, class_weights)
        loss.backward()
        all_reduce_sum(state.grads, ctx)
        adam_update(state, lr, weight_decay=weight_decay)
        ok = torch.isfinite(loss.detach())
        with torch.no_grad():
            for new, kept in zip((state.params, state.mu, state.nu, state.count,
                                  state.stats), old):
                new.copy_(torch.where(ok, new, kept))
        state.step += 1
        return loss.detach()

    return train_step


def make_multi_train_step(model: nn.Module, loss_fn: Callable, **kw) -> Callable:
    """``--steps_per_call K`` (JAX `train/trainer.py:192-238`): build
    ``multi_step(state, points [K, B, ...], labels [K, B, ...],
    class_weights, lr, bn_momentum, generator=None) → losses [K]``, K
    steps of ``make_train_step(model, loss_fn, **kw)`` on the stacks of
    ``data.loader.stack_batches``. The steps and their draws from
    ``generator`` are those of K single calls, in order, each with its NaN
    guard; the losses stay on the device. The single step it runs is its
    ``step`` attribute, which the device-sampled epoch calls."""
    step = make_train_step(model, loss_fn, **kw)

    def multi_step(state: TrainState, points, labels, class_weights, lr, bn_momentum,
                   generator=None):
        return torch.stack([step(state, points[i], labels[i], class_weights, lr,
                                 bn_momentum, generator)
                            for i in range(points.shape[0])])

    multi_step.step = step
    return multi_step


def make_adv_train_fn(model: nn.Module, family: Family, cfg, *,
                      ignored_labels: tuple = (), num_classes: int | None = None) -> Callable:
    """``--adv_train nb`` (JAX `train/trainer.py:241-312`): build
    ``adv_fn(points, labels, generator=None) → points``, the batch crafted
    by ``attacks.pgd.pgd_color_attack`` under ``cfg`` (a ``PGDConfig``)
    against the model's current parameters in evaluation mode (running
    BatchNorm statistics, none of them updated; no dropout; PointNet++'s
    FPS from index 0, as the JAX model's forward without a ``sample``
    RNG), then the model is back in training mode.

    The attack never moves xyz, so the family's evaluation plan is built
    once from the clean batch (PointNet++'s geometry, RandLA's
    ``build_pyramid``), as the JAX hook hoists ``model_args``; ResGCN's
    graphs are over features and stay inside its forward, as in JAX.
    ``cfg.rand_init_eps`` > 0 draws the random start from ``generator``.

    ``ignored_labels`` (with ``num_classes``, the valid classes) is the
    reduced class space of Semantic3D and SemanticKITTI: raw labels are
    mapped onto the valid classes for the attack's loss, and the ignored
    points are masked out of the perturbation and of the loss."""
    from pointsecguard_tpu_torch.attacks.pgd import pgd_color_attack
    from pointsecguard_tpu_torch.data.randla import label_reduce_lut, reduce_labels

    table, tables = None, {}
    if ignored_labels:
        if num_classes is None:
            raise ValueError("ignored_labels requires num_classes")
        lut = label_reduce_lut(num_classes, tuple(ignored_labels))
        lut[list(ignored_labels)] = -1
        table = torch.from_numpy(lut)

    def adv_fn(points, labels, generator=None):
        params = list(model.parameters())
        wanted = [p.requires_grad for p in params]
        model.eval()
        for p in params:
            p.requires_grad_(False)
        try:
            with torch.no_grad():
                plan = family.plan(points)

            def outputs_fn(p):
                return family.head(family.apply(model, p, plan))

            ys, mask = labels, None
            if table is not None:
                # copied to the labels' device once: a copy a step would
                # make the host wait for the device
                if labels.device not in tables:
                    tables[labels.device] = table.to(labels.device)
                mask, ys = reduce_labels(tables[labels.device], labels)
            return pgd_color_attack(outputs_fn, points, ys, cfg, mask=mask,
                                    generator=generator, evaluate=False)
        finally:
            for p, w in zip(params, wanted):
                p.requires_grad_(w)
            model.train()

    return adv_fn


def make_logp_step(model: nn.Module, device: torch.device, family: Family) -> Callable:
    """``logp(points [B, N, C] numpy) → [B, K] numpy``: a classifier's
    evaluation-mode log-probabilities (FPS from index 0), for
    ``evaluate_cls``; a part-seg net's [B, N, 50] from points that carry
    the one-hot (``_unpack``)."""

    @torch.no_grad()
    def logp(points: np.ndarray) -> np.ndarray:
        model.eval()
        pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
        return family.head(family.apply(model, pts, family.plan(pts))).cpu().numpy()

    return logp


def make_eval_step(model: nn.Module, device: torch.device,
                   family: Family = POINTNET2) -> Callable:
    """``predict(points [B, P, C] numpy) → labels [B, P] numpy``: the
    evaluation-mode forward of any family (PointNet++: FPS from index 0;
    running statistics, no dropout) and the argmax, for ``evaluate_whole_scenes``
    and RandLA's validation."""

    @torch.no_grad()
    def predict(points: np.ndarray) -> np.ndarray:
        model.eval()
        pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
        out = family.apply(model, pts, family.plan(pts))
        return torch.argmax(family.head(out), dim=-1).cpu().numpy()

    return predict
