"""RandLA-Net attack driver of the port (port of
``pointsecguard_tpu/cli/_attack_randla.py:14-406``; the reference
`tester_S3DIS.py:59-319`).

Samples spatially-regular clouds, and per batch: builds the pyramid
(fused kNN kernel) and the position plan once under ``no_grad``, takes
the clean prediction from that same forward, runs the ares NB / tar_NB
(PGD) or NU / tar_NU (C&W) attack reusing both, and writes one TSV row
per cloud in the JAX CLI's format. Targeted runs use batch 1 and skip
clouds with fewer than 500 origin points (`tester_S3DIS.py:253-258`).
``--fused_ap`` builds the model with ``ap_impl="fused"``. ``--save_adv``
writes the adversarial clouds and their labels to
``<log_dir>/randla_<attack>_adv_area<test_area>.npz`` for ``cli.eval
--model randla --adv_set``.
"""

from __future__ import annotations

import os
import time


def run_randla(args, log):
    import numpy as np
    import torch

    from pointsecguard_tpu_torch.attacks import (
        PGDConfig,
        attack_preset,
        cw_color_attack,
        make_target_labels,
        pgd_color_attack,
    )
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.metrics import metrics_from_confusion
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    preset = randla_dataset_preset(args.randla_dataset)
    cfg, K = preset.cfg, preset.num_classes
    num_points = args.randla_points or cfg.num_points
    targeted = args.attack.startswith("tar_")
    # targeted runs keep B=1: the <500-origin skip gate is a per-cloud
    # decision (`tester_S3DIS.py:253-258`)
    B = args.batch_size or (1 if targeted else cfg.val_batch_size)
    if targeted and B != 1:
        raise SystemExit("randla targeted attacks use --batch_size 1 (per-cloud "
                         "skip gates, `tester_S3DIS.py:253-258`)")
    device = resolve_device(args.device)
    sampler = preset.make_sampler(args.randla_dir, "test", num_points,
                                  np.random.default_rng(args.seed),
                                  test_area=args.test_area)
    model = RandLANet(num_classes=K, d_out=cfg.d_out,
                      ap_impl="fused" if args.fused_ap else "reference")
    model.load_state_dict(load_checkpoint(args.log_dir))
    # inference only: the attack needs input gradients, never parameter ones
    model.to(device).eval().requires_grad_(False)
    overrides = {"targeted": True, "target": args.target} if targeted else {}
    attack_cfg = attack_preset("randla", args.attack, **overrides)
    # the ares random start; torch's generator cannot give jax.random's bits
    gen = torch.Generator(device=device).manual_seed(args.seed)

    os.makedirs(args.log_dir, exist_ok=True)
    tsv_path = os.path.join(args.log_dir, f"randla_{args.attack}_area{args.test_area}.tsv")
    clean_cm = np.zeros((K, K))
    adv_cm = np.zeros((K, K))
    n_done = 0
    adv_saved, adv_saved_labels = [], []
    with open(tsv_path, "w") as tsv:
        tsv.write("cloud\tclean_acc\tadv_acc\tl2\tsr\tsteps\ttime_s\n")
        for _, feats, labels, _, cloud_idx in sampler.batches(B, -(-args.num_clouds // B)):
            feats_t = torch.from_numpy(feats).to(device)
            labels_t = torch.from_numpy(labels).to(device).long()
            if targeted:
                _, mask = make_target_labels(labels_t, args.origin, args.target)
                if int(mask.sum()) < 500:  # `tester_S3DIS.py:253-258`
                    continue
            else:
                mask = None
            t0 = time.time()
            with torch.no_grad():
                pyr = build_pyramid(feats_t[..., :3], num_layers=cfg.num_layers,
                                    k=cfg.k_n, sub_ratios=cfg.sub_sampling_ratio)
                # position encodings depend only on xyz + parameters: computed
                # once here; this forward's logits are the clean prediction
                clean_logits, pos = model(feats_t, pyr, collect_pos=True)
                clean_pred_d = torch.argmax(clean_logits, dim=-1)

            def outputs_fn(f, pyr=pyr, pos=pos):
                return model(f, pyr, pos_plan=pos)

            if isinstance(attack_cfg, PGDConfig):
                res = pgd_color_attack(outputs_fn, feats_t, labels_t, attack_cfg,
                                       mask=mask, generator=gen)
            else:
                res = cw_color_attack(outputs_fn, feats_t, labels_t, attack_cfg, mask=mask)
            clean_pred = clean_pred_d.cpu().numpy()
            adv_pred = res.adv_pred.cpu().numpy()
            l2_np = res.l2_dist.cpu().numpy()
            steps_row = res.steps_b.cpu().numpy()
            sr_global = float(res.success_rate)
            mask_np = None if mask is None else mask.cpu().numpy()
            if args.save_adv:
                adv_saved.append(res.points_adv.cpu().numpy().astype(np.float32))
                adv_saved_labels.append(labels.astype(np.int32))
            dt = time.time() - t0
            np.add.at(clean_cm, (labels.reshape(-1), clean_pred.reshape(-1)), 1)
            np.add.at(adv_cm, (labels.reshape(-1), adv_pred.reshape(-1)), 1)
            for b in range(B):  # one protocol row per cloud
                clean_acc = float((clean_pred[b] == labels[b]).mean())
                adv_acc = float((adv_pred[b] == labels[b]).mean())
                if targeted and mask_np[b].any():
                    sr_b = float((adv_pred[b][mask_np[b]] == args.target).mean())
                else:
                    sr_b = sr_global
                tsv.write(f"{int(cloud_idx[b])}\t{clean_acc:.4f}\t{adv_acc:.4f}"
                          f"\t{float(l2_np[b]):.4f}\t{sr_b:.4f}"
                          f"\t{int(steps_row[b])}\t{dt / B:.4f}\n")
            tsv.flush()
            n_done += B
            if n_done % 10 == 0:
                log.info("%d clouds: clean mIoU %.4f adv mIoU %.4f", n_done,
                         metrics_from_confusion(clean_cm).miou,
                         metrics_from_confusion(adv_cm).miou)
    cm = metrics_from_confusion(clean_cm)
    am = metrics_from_confusion(adv_cm)
    log.info("RANDLA %s: clean mIoU %.4f acc %.4f | adv mIoU %.4f acc %.4f (%d clouds)",
             args.attack, cm.miou, cm.accuracy, am.miou, am.accuracy, n_done)
    log.info("per-cloud TSV: %s", tsv_path)
    if args.save_adv and adv_saved:
        adv_path = os.path.join(args.log_dir,
                                f"randla_{args.attack}_adv_area{args.test_area}.npz")
        np.savez_compressed(adv_path, points=np.concatenate(adv_saved, axis=0),
                            labels=np.concatenate(adv_saved_labels, axis=0))
        log.info("adversarial set: %s (re-evaluate with cli.eval --model randla "
                 "--adv_set)", adv_path)
    return cm, am
