"""Block attack loop of the port (port of
``pointsecguard_tpu/cli/_attack_blocks.py:18-511`` for PointNet++ SSG and
MSG, PointNet and ResGCN-28).

Per batch of blocks: for PointNet++ build the xyz-only geometry once (FPS
and bottom-k kernels; ResGCN builds its graphs in every forward, four of
them on the kNN kernel; PointNet has none), clean forward, PGD (nb /
tar_nb) or C&W (nu / tar_nu) attack, or with ``--attack random`` noise of
``--noise_norm`` and no engine, then the adversarial forward; per-block
TSV rows in the JAX CLI's format, with ``--save_adv`` the adversarial
blocks as an ``.npz``; per room and per dataset, clean-vs-adversarial IoU
from pooled votes (`NB_nontarget_test_semseg.py:64-294` protocol).
ResGCN's targeted runs (batch 1) skip a cloud with ≤ 500 origin points or
a masked clean accuracy below 0.5 (`sem_seg_dense/attacks.py:204-207`);
the clean forward of that gate is the run's clean prediction.

The protocol flags: ``--defense`` / ``--eot`` wrap the model
(``cli/_attack_common.py:defense_wrapper``), and every reported prediction
(clean, adversarial, control) is the deployed defense's forward, while the
attacker differentiates ``attack_wrap``; ``--control`` adds the
equal-norm random control at each block's measured L2 (``rand_acc``);
``--log_steps`` writes ``<model>_<attack>_area<k>_steps.tsv``;
``--visual`` the room's ``.xyzrgb`` dumps and HTML viewers (the room's
adversarial colours are gathered on the device and read once a room);
``--resgcn_fixed_graphs`` gives ResGCN's attacker a surrogate on the
graphs of the clean input. ``--ensemble`` adds block models to the victim
(``ensemble_closures``): every reported prediction is the weighted softmax
mixture's, and each PointNet++ member builds its geometry once a batch.
"""

from __future__ import annotations

import os
import time

BLOCK_FAMILY = ("pointnet2", "pointnet2_msg", "pointnet", "resgcn")


def load_block_model(name, log_dir, args, device):
    """(model, family) of a block model with the port checkpoint of
    ``log_dir``, on ``device`` for inference only: the attacks need input
    gradients, never parameter ones. ResGCN takes the ``--resgcn_*`` flags."""
    from pointsecguard_tpu_torch.configs import resgcn_overrides
    from pointsecguard_tpu_torch.models import DenseDeepGCN
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS, resgcn_family
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    if name == "resgcn":
        model, family = DenseDeepGCN(**resgcn_overrides(args)), resgcn_family()
    else:
        model_cls, family = POINTNET_MODELS[name]
        model = model_cls()
    model.load_state_dict(load_checkpoint(log_dir))
    model.to(device).eval().requires_grad_(False)
    return model, family


def member_factory(model, family):
    """``make(pts) → outputs_fn`` of one batch: the family's plan is built
    once from the batch's xyz (PointNet++: the geometry, FPS and bottom-k
    kernels; colour attacks never move xyz), and every forward of the batch
    reuses it. ResGCN rebuilds its graphs in every forward and PointNet has
    no neighbourhoods, so their plan is None."""

    def make(pts):
        plan = family.plan(pts)
        return lambda p: family.head(family.apply(model, p, plan))

    return make


def parse_ensemble(specs) -> list[tuple[str, str, float]]:
    """``--ensemble MODEL:LOG_DIR[:WEIGHT]`` specs → (model, log_dir,
    weight); SystemExit on a malformed spec or a member outside the block
    family (the JAX driver's messages)."""
    members = []
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise SystemExit(f"--ensemble expects MODEL:LOG_DIR[:WEIGHT], got '{spec}'")
        if parts[0] not in BLOCK_FAMILY:
            raise SystemExit(
                f"--ensemble member '{parts[0]}' is not a block-family "
                "model (pointnet2/pointnet2_msg/pointnet/resgcn)")
        members.append((parts[0], parts[1], float(parts[2]) if len(parts) == 3 else 1.0))
    return members


def ensemble_closures(args, device, make_closures, log):
    """``--ensemble`` / ``--ensemble_mode``: the weighted ensemble victim
    (JAX `_attack_blocks.py:122-205`; ares `model/ensemble.py:9-25`). The
    primary model has weight 1, every member its spec's; each member loads
    its own checkpoint and builds its plan once per batch, shared by the
    eval and attack closures. Returns ``make_closures(pts, attack)`` of the
    ensemble: the eval closure is the ``probs`` mixture, which every
    reported metric reads; the attack closure is the ``--ensemble_mode``
    objective over the primary's attack closure (the ``--resgcn_fixed_graphs``
    surrogate where given) and the members. ``--defense`` wraps the
    mixture, not its members."""
    from pointsecguard_tpu_torch.models.registry import ensemble_outputs_fn

    specs = parse_ensemble(args.ensemble)
    member_makes = [member_factory(*load_block_model(name, path, args, device))
                    for name, path, _ in specs]
    weights = [1.0] + [w for _, _, w in specs]
    log.info("ensemble victim: %s + %s (weights %s, attack mode %s)", args.model,
             [name for name, _, _ in specs], weights, args.ensemble_mode)

    def closures(pts, attack):
        prim_eval, prim_atk = make_closures(pts, attack)
        fns = [make(pts) for make in member_makes]
        f_eval = ensemble_outputs_fn([prim_eval] + fns, weights, mode="probs")
        if not attack:
            return f_eval, None
        return f_eval, ensemble_outputs_fn([prim_atk] + fns, weights, mode=args.ensemble_mode)

    return closures


def run_blocks(args, log):
    import numpy as np
    import torch

    from pointsecguard_tpu_torch.attacks import (
        PGDConfig,
        attack_preset,
        cw_color_attack,
        equal_norm_color_noise,
        make_target_labels,
        pgd_color_attack,
    )
    from pointsecguard_tpu_torch.cli._attack_common import defense_wrapper, write_room_visuals
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks
    from pointsecguard_tpu_torch.train.evaluator import add_votes
    from pointsecguard_tpu_torch.utils.metrics import metrics_from_confusion
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    parse_ensemble(args.ensemble)  # a malformed spec stops before any checkpoint work
    device = resolve_device(args.device)
    # the JAX driver's model table (`_attack_blocks.py:51-98`): every model
    # of the PointNet family takes the "pointnet2" presets
    resgcn = args.model == "resgcn"
    model, family = load_block_model(args.model, args.log_dir, args, device)

    make_outputs_fn = member_factory(model, family)
    if resgcn and args.resgcn_fixed_graphs:
        # the attacker's surrogate: edge graphs frozen at the clean input
        # (no kNN in the attack's forwards); every reported metric still
        # evaluates the dynamic model, which rebuilds its graphs
        # (`torch_vertex.py:69-71`; JAX `_attack_blocks.py:100-115`)
        def make_attack_outputs(pts):
            with torch.no_grad():
                _, graphs = model(pts, collect_graphs=True)
            return lambda p: model(p, graphs=graphs)
    else:
        make_attack_outputs = None  # the attacker differentiates the victim

    def make_closures(pts, attack):
        """The batch's (eval, attack) closures; the attack's is None
        without an attack engine."""
        f = make_outputs_fn(pts)
        if not attack:
            return f, None
        return f, f if make_attack_outputs is None else make_attack_outputs(pts)

    if args.ensemble:
        make_closures = ensemble_closures(args, device, make_closures, log)

    wraps = defense_wrapper(args)
    eval_wrap, attack_wrap = wraps if wraps is not None else (None, None)

    rooms = RoomSet.load(args.data_root, "test", args.test_area)
    B = args.batch_size
    targeted = args.attack.startswith("tar_")
    # ResGCN's targeted protocol gates clouds one by one (batch 1)
    resgcn_gates = resgcn and targeted
    gate_skips = {"origin": 0, "accuracy": 0}
    if args.attack == "random":
        attack_cfg = None
        if args.control:  # the "attack" is the equal-norm noise itself
            log.info("--control is a no-op with --attack random; ignoring")
            args.control = False
    else:
        overrides = {"targeted": True, "target": args.target} if targeted else {}
        attack_cfg = attack_preset("resgcn" if resgcn else "pointnet2", args.attack,
                                   **overrides)
    # the random noise of --attack random and of --control
    gen = torch.Generator(device=device).manual_seed(args.seed)

    os.makedirs(args.log_dir, exist_ok=True)
    tsv_path = os.path.join(
        args.log_dir, f"{args.model}_{args.attack}_area{args.test_area}.tsv"
    )
    steps_tsv = None
    if args.log_steps and attack_cfg is not None:
        steps_tsv = open(tsv_path.replace(".tsv", "_steps.tsv"), "w")
        steps_tsv.write("room\tblock\titer\tacc\tsr\tl2\n")
    with open(tsv_path, "w") as tsv:
        header = "room\tblock\tclean_acc\tadv_acc\tl2\tsr\tother_acc\tsteps\ttime_s"
        if args.control:
            header += "\trand_acc"
        tsv.write(header + "\n")

        ws = WholeSceneBlocks(rooms, block_points=args.num_point)
        rng = np.random.default_rng(args.seed)
        clean_cm = np.zeros((13, 13))
        adv_cm = np.zeros((13, 13))
        n_blocks_done = 0
        adv_saved, adv_saved_labels = [], []  # --save_adv: per kept block
        for room_idx, room_name in enumerate(rooms.names):
            data, labels, weights, pidx = ws.room_blocks(room_idx, rng)
            labels_room = rooms.labels[room_idx]
            clean_pool = np.zeros((len(labels_room), 13))
            adv_pool = np.zeros((len(labels_room), 13))
            # --visual: the room's adversarial colours, gathered on the device
            room_colors = (torch.from_numpy(rooms.points[room_idx][:, 3:6] / 255.0).to(device)
                           if args.visual else None)
            nb = data.shape[0]
            for start in range(0, nb, B):
                valid = min(B, nb - start)  # keep the room tail; pad the batch
                t0 = time.time()  # to B rows and drop the padded outputs
                pts_np = data[start : start + valid]
                labs_np = labels[start : start + valid].astype(np.int32)
                if valid < B:
                    reps = [1] * (valid - 1) + [B - valid + 1]
                    pts_np = np.repeat(pts_np, reps, axis=0)
                    labs_np = np.repeat(labs_np, reps, axis=0)
                pts = torch.from_numpy(pts_np).to(device)
                labs = torch.from_numpy(labs_np).to(device).long()
                outputs_fn, attack_fn = make_closures(pts, attack_cfg is not None)
                f_eval = eval_wrap(outputs_fn) if eval_wrap else outputs_fn

                @torch.no_grad()
                def predict(p):  # every reported prediction: the deployed model
                    return torch.argmax(f_eval(p), dim=-1)

                clean_pred_d = None
                if targeted:
                    _, mask = make_target_labels(labs, args.origin, args.target)
                    mask_np = mask.cpu().numpy()[:valid]
                    if resgcn_gates:
                        # `attacks.py:204-205`: skip clouds with ≤ 500 origin points
                        if int(mask_np.sum()) <= 500:
                            gate_skips["origin"] += 1
                            continue
                        # `attacks.py:206-207`: skip if masked clean accuracy < 0.5
                        clean_pred_d = predict(pts)
                        cp = clean_pred_d.cpu().numpy()[:valid]
                        if (cp[mask_np] == labs_np[:valid][mask_np]).mean() < 0.5:
                            gate_skips["accuracy"] += 1
                            continue
                        keep = np.ones(valid, bool)  # the cloud is kept whole
                    elif not mask_np.any():
                        continue  # skip blocks without origin points (`:174`)
                    else:
                        # per-row gate: origin-free blocks of a mixed batch
                        # are dropped from the TSV and both vote pools
                        keep = mask_np.any(axis=1)
                else:
                    mask = None
                    keep = np.ones(valid, bool)

                if clean_pred_d is None:
                    clean_pred_d = predict(pts)
                traj = rand_pred_d = None
                if attack_cfg is None:  # --attack random
                    adv_pts = equal_norm_color_noise(
                        pts, torch.full((B,), args.noise_norm, device=device), mask=mask,
                        generator=gen)
                    steps_row = np.zeros(valid, np.int64)
                    l2_b = np.full(valid, float(args.noise_norm))
                else:
                    f_atk = attack_wrap(attack_fn) if attack_wrap else attack_fn
                    engine = pgd_color_attack if isinstance(attack_cfg, PGDConfig) \
                        else cw_color_attack
                    res = engine(f_atk, pts, labs, attack_cfg, mask=mask,
                                 trajectory=args.log_steps, valid_rows=valid)
                    res, traj = res if args.log_steps else (res, None)
                    adv_pts = res.points_adv
                    if args.control:
                        # equal-norm random control at the attack's *measured*
                        # L2 (`NUattack.py:236-254`), under the deployed defense
                        rand_pred_d = predict(equal_norm_color_noise(
                            pts, res.l2_dist, mask=mask, generator=gen))
                    steps_row = res.steps_b.cpu().numpy()[:valid]
                    l2_b = res.l2_dist.cpu().numpy()[:valid]
                # scored under the deployed defense, never the attack's closure
                adv_pred_d = predict(adv_pts)
                clean_pred = clean_pred_d.cpu().numpy()[:valid]
                adv_pred = adv_pred_d.cpu().numpy()[:valid]
                rand_pred = None if rand_pred_d is None else rand_pred_d.cpu().numpy()[:valid]
                if targeted:
                    # the protocol's success rate from the deployed predictions
                    sr_b = np.array([
                        float((adv_pred[b][mask_np[b]] == args.target).mean())
                        if mask_np[b].any() else 0.0
                        for b in range(valid)
                    ])
                else:
                    sr_b = np.zeros(valid)
                if args.save_adv:
                    adv_saved.append(adv_pts.cpu().numpy()[:valid][keep].astype(np.float32))
                    adv_saved_labels.append(labs_np[:valid][keep].astype(np.int32))
                pi = pidx[start : start + valid]
                if room_colors is not None:
                    # the last copy of a point sampled twice wins, as numpy's
                    # assignment gives it
                    flat = pi[keep].reshape(-1)
                    _, first_rev = np.unique(flat[::-1], return_index=True)
                    last = len(flat) - 1 - first_rev
                    adv_c = adv_pts[:valid][torch.from_numpy(keep).to(device)][..., 3:6]
                    room_colors[torch.from_numpy(flat[last]).to(device)] = \
                        adv_c.reshape(-1, 3)[torch.from_numpy(last).to(device)].to(room_colors)
                traj_np = (None if traj is None
                           else {k: v.cpu().numpy() for k, v in traj.items()})
                dt = time.time() - t0

                lab_np = labs_np[:valid]
                w = weights[start : start + valid]
                add_votes(clean_pool, pi[keep], clean_pred[keep], w[keep])
                add_votes(adv_pool, pi[keep], adv_pred[keep], w[keep])
                # one protocol row per block (`NB_nontarget_test_semseg.py:213-215`)
                for b in range(valid):
                    if not keep[b]:
                        continue
                    clean_acc = float((clean_pred[b] == lab_np[b]).mean())
                    adv_acc = float((adv_pred[b] == lab_np[b]).mean())
                    if targeted:
                        # accuracy on the untouched points (`target.py:110`)
                        inv = ~mask_np[b]
                        other_acc = (
                            float((adv_pred[b][inv] == lab_np[b][inv]).mean())
                            if inv.any() else 1.0
                        )
                    else:
                        other_acc = adv_acc
                    row = (f"{room_name}\t{start + b}\t{clean_acc:.4f}"
                           f"\t{adv_acc:.4f}\t{l2_b[b]:.4f}\t{sr_b[b]:.4f}"
                           f"\t{other_acc:.4f}\t{int(steps_row[b])}"
                           f"\t{dt / valid:.4f}")
                    if args.control:
                        row += f"\t{float((rand_pred[b] == lab_np[b]).mean()):.4f}"
                    tsv.write(row + "\n")
                tsv.flush()
                if steps_tsv is not None:
                    # acc / sr pooled over the batch's real blocks, l2 their mean
                    t_l2 = traj_np["l2"][:, :valid].mean(axis=1)
                    for it in range(len(t_l2)):
                        steps_tsv.write(
                            f"{room_name}\t{start}\t{it}\t{traj_np['acc'][it]:.4f}"
                            f"\t{traj_np['sr'][it]:.4f}\t{t_l2[it]:.4f}\n")
                    steps_tsv.flush()
                n_blocks_done += int(keep.sum())
                if args.max_blocks and n_blocks_done >= args.max_blocks:
                    break
            clean_room = np.argmax(clean_pool, 1)
            adv_room = np.argmax(adv_pool, 1)
            if room_colors is not None:
                write_room_visuals(os.path.join(args.log_dir, "visual"), room_name,
                                   args.attack, rooms.points[room_idx],
                                   room_colors.cpu().numpy(), adv_room, labels_room)
            seen = clean_pool.sum(1) > 0
            np.add.at(clean_cm, (labels_room[seen], clean_room[seen]), 1)
            np.add.at(adv_cm, (labels_room[seen], adv_room[seen]), 1)
            log.info(
                "%s done: clean mIoU %.4f adv mIoU %.4f", room_name,
                metrics_from_confusion(clean_cm).miou,
                metrics_from_confusion(adv_cm).miou,
            )
            if args.max_blocks and n_blocks_done >= args.max_blocks:
                break
    if steps_tsv is not None:
        steps_tsv.close()
    if resgcn_gates:
        log.info("resgcn gates: %d clouds attacked, %d skipped with <= 500 origin "
                 "points, %d with masked clean accuracy < 0.5", n_blocks_done,
                 gate_skips["origin"], gate_skips["accuracy"])
    clean_m = metrics_from_confusion(clean_cm)
    adv_m = metrics_from_confusion(adv_cm)
    log.info(
        "DATASET clean: mIoU %.4f acc %.4f | adv: mIoU %.4f acc %.4f",
        clean_m.miou, clean_m.accuracy, adv_m.miou, adv_m.accuracy,
    )
    log.info("per-block TSV: %s", tsv_path)
    if args.save_adv and adv_saved:
        adv_path = os.path.join(
            args.log_dir,
            f"{args.model}_{args.attack}_adv_area{args.test_area}.npz",
        )
        np.savez_compressed(
            adv_path,
            points=np.concatenate(adv_saved, axis=0),
            labels=np.concatenate(adv_saved_labels, axis=0),
        )
        log.info("adversarial set: %s (re-evaluate with cli.eval --adv_set)",
                 adv_path)
    return clean_m, adv_m
