"""RandLA-Net attack driver of the port (port of
``pointsecguard_tpu/cli/_attack_randla.py:14-406``; the reference
`tester_S3DIS.py:59-319`).

Samples spatially-regular clouds of the ``--randla_dataset`` preset
(S3DIS or Semantic3D; SemanticKITTI's clouds are xyz-only, so the colour
threat model does not apply and the run is refused), and per batch: builds the pyramid
(fused kNN kernel) and the position plan once under ``no_grad``, runs the
ares NB / tar_NB (PGD) or NU / tar_NU (C&W) attack reusing both, or with
``--attack random`` noise of ``--noise_norm`` and no engine, and writes one
TSV row per cloud in the JAX CLI's format. Targeted runs use batch 1 and
skip clouds with fewer than 500 origin points (`tester_S3DIS.py:253-258`).
``--fused_ap`` builds the model with ``ap_impl="fused"``. ``--save_adv``
writes the adversarial clouds and their labels to
``<log_dir>/randla_<attack>_adv_area<test_area>.npz`` for ``cli.eval
--model randla --adv_set``.

The protocol flags, as in the block loop: ``--defense`` / ``--eot``
transform the features before the model (the pyramid and the position
plan stay xyz-only: every defense leaves xyz alone), and every reported
prediction is the deployed defense's; ``--control`` adds ``rand_acc``;
``--log_steps`` writes ``randla_<attack>_area<k>_steps.tsv``; ``--visual``
the per-cloud ``.xyzrgb`` dumps and HTML viewer.

On a preset with ignored labels (Semantic3D's label 0) the model predicts
the valid classes only: raw labels are reduced to them, ignored points are
masked out of the attack objective (so their colours never move), of the
random noise and of every metric, and ``--origin`` / ``--target`` stay raw
dataset labels. ``--save_adv`` keeps the raw labels.

On a rank of ``--devices N`` (``ctx``) each batch is split by rows as in
the block driver (``--log_steps`` too: the trajectory's counts summed
over the ranks, its per-cloud L2 gathered), the per-cloud results
gathered and written by rank 0.
With ``--shard_points P`` the ranks of a points group attack the same
clouds whole, and only the pyramid's kNN is divided among them
(``build_pyramid(sp=...)``: each rank's query shard, the index tables
all-gathered), before the attack loop, which so holds no collective of the points group.
"""

from __future__ import annotations

import os
import time


def _write_cloud_visuals(vis_dir, cloud, attack, xyz, feats, adv_feats, adv_pred, labels):
    """Per-cloud visual artifacts (JAX `_attack_randla.py:318-360`);
    ``labels`` in the predictions' class space."""
    from pointsecguard_tpu_torch.utils.logging import write_label_cloud, write_xyzrgb
    from pointsecguard_tpu_torch.utils.viz import export_html_viewer

    os.makedirs(vis_dir, exist_ok=True)
    base = os.path.join(vis_dir, f"cloud{cloud}_{attack}")
    write_xyzrgb(base + "_raw.xyzrgb", xyz, feats[:, 3:6])
    write_xyzrgb(base + "_adv_raw.xyzrgb", xyz, adv_feats[:, 3:6])
    write_label_cloud(base + "_pred.xyzrgb", xyz, adv_pred)
    write_label_cloud(base + "_gt.xyzrgb", xyz, labels)
    export_html_viewer(base + "_adv.html", xyz, colors=adv_feats[:, 3:6],
                       title=f"cloud {cloud} {attack} adversarial")


def run_randla(args, log, ctx=None):
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
    from pointsecguard_tpu_torch.cli._attack_common import defense_wrapper
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid
    from pointsecguard_tpu_torch.parallel import gather_rows, is_main, make_batch_put, sum_rows
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.metrics import metrics_from_confusion
    from pointsecguard_tpu_torch.utils.runtime import model_dtype, resolve_device

    preset = randla_dataset_preset(args.randla_dataset)
    if not preset.has_colors:
        raise SystemExit(
            f"--randla_dataset {preset.name} clouds are xyz-only; the "
            "paper's color threat model (and the equal-norm noise "
            "control) does not apply")
    cfg, K, ignored = preset.cfg, preset.num_classes, preset.ignored_labels
    num_points = args.randla_points or cfg.num_points
    targeted = args.attack.startswith("tar_")
    # targeted runs keep B=1: the <500-origin skip gate is a per-cloud
    # decision (`tester_S3DIS.py:253-258`)
    B = args.batch_size or (1 if targeted else cfg.val_batch_size)
    if targeted and B != 1:
        raise SystemExit("randla targeted attacks use --batch_size 1 (per-cloud "
                         "skip gates, `tester_S3DIS.py:253-258`)")
    if targeted and ignored:
        n_raw = K + len(ignored)
        if args.origin in ignored or args.target in ignored \
                or not (0 <= args.origin < n_raw and 0 <= args.target < n_raw):
            raise SystemExit(
                f"--origin/--target must be valid raw {preset.name} labels "
                f"(1..{n_raw - 1}; label(s) {set(ignored)} are ignored)")
    # the attack's labels live in the valid class space
    target_v = (int(preset.reduce(np.asarray(args.target))[1]) if (targeted and ignored)
                else args.target)
    device = ctx.device if ctx is not None else resolve_device(args.device)
    rows = make_batch_put(ctx, batch_size=B)  # this rank's rows of a host batch
    writes = is_main(ctx)  # rank 0 writes the run's files
    sp = ctx if args.shard_points > 1 else None

    def whole(t):  # the ranks' rows of a device result → the whole batch, on the host
        return gather_rows(t, ctx).cpu().numpy()

    def local(x):  # this rank's rows of a host array, on the device
        return torch.from_numpy(np.ascontiguousarray(rows(x))).to(device)

    ranks_sum = None if ctx is None else (lambda t: sum_rows(t, ctx))

    sampler = preset.make_sampler(args.randla_dir, "test", num_points,
                                  np.random.default_rng(args.seed),
                                  test_area=args.test_area)
    model = RandLANet(num_classes=K, d_out=cfg.d_out,
                      ap_impl="fused" if args.fused_ap else "reference",
                      dtype=model_dtype(args.precision))
    model.load_state_dict(load_checkpoint(args.log_dir))
    # inference only: the attack needs input gradients, never parameter ones
    model.to(device).eval().requires_grad_(False)
    wraps = defense_wrapper(args)
    eval_wrap, attack_wrap = wraps if wraps is not None else (None, None)
    if args.attack == "random":
        # fixed-norm noise as its own run (`sem_seg_dense/test.py:47-109`
        # at the cloud level; the NB preset's magnitude is 17)
        attack_cfg = None
        if args.control:  # the "attack" is the equal-norm noise itself
            log.info("--control is a no-op with --attack random; ignoring")
            args.control = False
    else:
        overrides = {"targeted": True, "target": target_v} if targeted else {}
        if K != 13:
            overrides["num_classes"] = K
            if args.attack in ("nu", "tar_nu"):
                overrides["success_acc"] = 1.0 / K
        attack_cfg = attack_preset("randla", args.attack, **overrides)
    # the ares random start and the noise of --attack random / --control;
    # torch's generator cannot give jax.random's bits
    gen = torch.Generator(device=device).manual_seed(args.seed)

    os.makedirs(args.log_dir, exist_ok=True)
    tsv_path = os.path.join(args.log_dir, f"randla_{args.attack}_area{args.test_area}.tsv")
    steps_tsv = None
    if args.log_steps and attack_cfg is not None and writes:
        steps_tsv = open(tsv_path.replace(".tsv", "_steps.tsv"), "w")
        steps_tsv.write("cloud\titer\tacc\tsr\tl2\n")
    clean_cm = np.zeros((K, K))
    adv_cm = np.zeros((K, K))
    n_done = 0
    adv_saved, adv_saved_labels = [], []
    with open(tsv_path if writes else os.devnull, "w") as tsv:
        header = "cloud\tclean_acc\tadv_acc\tl2\tsr\tsteps\ttime_s"
        tsv.write(header + ("\trand_acc" if args.control else "") + "\n")
        for xyz, feats, labels, _, cloud_idx in sampler.batches(B, -(-args.num_clouds // B)):
            feats_t = local(feats)
            # ignored points leave the objective and every score below
            valid_np, labels_v = preset.reduce(labels)
            labels_t = local(labels_v).long()
            if targeted:
                # the origin mask reads the raw labels (a validated origin
                # is never ignored); the gate reads the whole batch
                _, mask = make_target_labels(torch.from_numpy(labels), args.origin,
                                             args.target)
                if int(mask.sum()) < 500:  # `tester_S3DIS.py:253-258`
                    continue
                mask = local(mask.numpy())
            elif ignored:
                mask = local(valid_np)
            else:
                mask = None
            t0 = time.time()
            with torch.no_grad():
                pyr = build_pyramid(feats_t[..., :3], num_layers=cfg.num_layers,
                                    k=cfg.k_n, sub_ratios=cfg.sub_sampling_ratio, sp=sp)
                # position encodings depend only on xyz + parameters: computed
                # once here; without a defense this forward's logits are the
                # clean prediction
                clean_logits, pos = model(feats_t, pyr, collect_pos=True)

            def outputs_fn(f, pyr=pyr, pos=pos):
                return model(f, pyr, pos_plan=pos)

            f_eval = eval_wrap(outputs_fn) if eval_wrap else outputs_fn

            @torch.no_grad()
            def predict(f):  # every reported prediction: the deployed model
                return torch.argmax(f_eval(f), dim=-1)

            clean_pred_d = (predict(feats_t) if eval_wrap
                            else torch.argmax(clean_logits, dim=-1))
            traj = rand_pred_d = None
            if attack_cfg is None:  # --attack random
                adv_t = equal_norm_color_noise(
                    feats_t, torch.full((feats_t.shape[0],), args.noise_norm, device=device),
                    mask=mask, generator=gen)
                l2_np = np.full(B, float(args.noise_norm))
                steps_row = np.zeros(B, np.int64)
                sr_global = 0.0
            else:
                f_atk = attack_wrap(outputs_fn) if attack_wrap else outputs_fn
                if isinstance(attack_cfg, PGDConfig):
                    res = pgd_color_attack(f_atk, feats_t, labels_t, attack_cfg, mask=mask,
                                           generator=gen, trajectory=args.log_steps,
                                           ranks_sum=ranks_sum)
                else:
                    res = cw_color_attack(f_atk, feats_t, labels_t, attack_cfg, mask=mask,
                                          trajectory=args.log_steps, ranks_sum=ranks_sum)
                res, traj = res if args.log_steps else (res, None)
                adv_t = res.points_adv
                if args.control:
                    # ares runs the control at the *found* distortion norm
                    # (`NUattack.py:236-254`), under the deployed defense
                    rand_pred_d = predict(equal_norm_color_noise(
                        feats_t, res.l2_dist, mask=mask, generator=gen))
                l2_np = whole(res.l2_dist)
                steps_row = whole(res.steps_b)
                # targeted runs are one cloud a batch, so no rank splits one
                sr_global = float(res.success_rate)
            # scored under the deployed defense, never the attack's closure
            adv_pred = whole(predict(adv_t))
            clean_pred = whole(clean_pred_d)
            rand_pred = None if rand_pred_d is None else whole(rand_pred_d)
            traj_np = (None if traj is None else
                       {"acc": traj["acc"].cpu().numpy(), "sr": traj["sr"].cpu().numpy(),
                        "l2": whole(traj["l2"].T.contiguous()).T})
            mask_np = None if mask is None else whole(mask)
            adv_np = whole(adv_t) if (args.save_adv or args.visual) else None
            if args.save_adv and writes:
                adv_saved.append(adv_np.astype(np.float32))
                adv_saved_labels.append(labels.astype(np.int32))
            dt = time.time() - t0
            vv = valid_np.reshape(-1)
            np.add.at(clean_cm, (labels_v.reshape(-1)[vv], clean_pred.reshape(-1)[vv]), 1)
            np.add.at(adv_cm, (labels_v.reshape(-1)[vv], adv_pred.reshape(-1)[vv]), 1)
            for b in range(B):  # one protocol row per cloud
                vb, yb = valid_np[b], labels_v[b][valid_np[b]]
                clean_acc = float((clean_pred[b][vb] == yb).mean())
                adv_acc = float((adv_pred[b][vb] == yb).mean())
                if targeted and mask_np[b].any():
                    sr_b = float((adv_pred[b][mask_np[b]] == target_v).mean())
                else:
                    sr_b = sr_global
                row = (f"{int(cloud_idx[b])}\t{clean_acc:.4f}\t{adv_acc:.4f}"
                       f"\t{float(l2_np[b]):.4f}\t{sr_b:.4f}"
                       f"\t{int(steps_row[b])}\t{dt / B:.4f}")
                if args.control:
                    row += f"\t{float((rand_pred[b][vb] == yb).mean()):.4f}"
                tsv.write(row + "\n")
            tsv.flush()
            if args.visual and writes:
                for b in range(B):
                    # gt in the predictions' reduced class space; ignored
                    # points take the palette's slot K
                    gt_disp = np.where(valid_np[b], labels_v[b], K)
                    _write_cloud_visuals(os.path.join(args.log_dir, "visual"),
                                         int(cloud_idx[b]), args.attack, xyz[b],
                                         feats[b], adv_np[b], adv_pred[b], gt_disp)
            if steps_tsv is not None:
                # acc / sr pooled over the batch's clouds; l2 per cloud
                for b in range(B):
                    for it in range(len(traj_np["acc"])):
                        steps_tsv.write(
                            f"{int(cloud_idx[b])}\t{it}\t{traj_np['acc'][it]:.4f}"
                            f"\t{traj_np['sr'][it]:.4f}\t{traj_np['l2'][it, b]:.4f}\n")
                steps_tsv.flush()
            n_done += B
            if n_done % 10 == 0:
                log.info("%d clouds: clean mIoU %.4f adv mIoU %.4f", n_done,
                         metrics_from_confusion(clean_cm).miou,
                         metrics_from_confusion(adv_cm).miou)
    if steps_tsv is not None:
        steps_tsv.close()
    cm = metrics_from_confusion(clean_cm)
    am = metrics_from_confusion(adv_cm)
    log.info("RANDLA %s: clean mIoU %.4f acc %.4f | adv mIoU %.4f acc %.4f (%d clouds)",
             args.attack, cm.miou, cm.accuracy, am.miou, am.accuracy, n_done)
    log.info("per-cloud TSV: %s", tsv_path)
    if args.save_adv and adv_saved:  # rank 0 only
        adv_path = os.path.join(args.log_dir,
                                f"randla_{args.attack}_adv_area{args.test_area}.npz")
        np.savez_compressed(adv_path, points=np.concatenate(adv_saved, axis=0),
                            labels=np.concatenate(adv_saved_labels, axis=0))
        log.info("adversarial set: %s (re-evaluate with cli.eval --model randla "
                 "--adv_set)", adv_path)
    return cm, am
