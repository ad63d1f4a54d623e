"""What the two attack loops of the port share (port of
``pointsecguard_tpu/cli/_attack_common.py``): the ``--defense`` / ``--eot``
model wrapping and the per-room visual artifacts."""

from __future__ import annotations

import os


def write_room_visuals(vis_dir, room_name, attack, room_points, adv_colors, adv_pred,
                       labels):
    """Per-room visual artifacts (`NB_nontarget_test_semseg.py:131-136`):
    clean and adversarial ``.xyzrgb`` dumps, predicted and ground-truth
    label clouds, and the two interactive HTML viewers."""
    from pointsecguard_tpu_torch.utils.logging import write_label_cloud, write_xyzrgb
    from pointsecguard_tpu_torch.utils.viz import export_html_viewer

    os.makedirs(vis_dir, exist_ok=True)
    room_xyz = room_points[:, :3]
    base = os.path.join(vis_dir, f"{room_name}_{attack}")
    write_xyzrgb(base + "_adv_raw.xyzrgb", room_xyz, adv_colors)
    write_xyzrgb(base + "_raw.xyzrgb", room_xyz, room_points[:, 3:6] / 255.0)
    write_label_cloud(base + "_pred.xyzrgb", room_xyz, adv_pred)
    write_label_cloud(base + "_gt.xyzrgb", room_xyz, labels)
    export_html_viewer(base + "_adv.html", room_xyz, colors=adv_colors,
                       title=f"{room_name} {attack} adversarial")
    export_html_viewer(base + "_pred.html", room_xyz, labels=adv_pred,
                       title=f"{room_name} {attack} predictions")


def defense_wrapper(args):
    """``--defense`` / ``--eot``: None (no defense) or ``(eval_wrap,
    attack_wrap)``, each wrapping an outputs closure with the input
    transformation (BPDA-style; the ares `defense/input_transformation.py`
    decorator pattern). ``eval_wrap`` is the DEPLOYED defense (one fixed
    draw, from ``--seed`` + 99, for jitter and resample), which every
    reported clean, adversarial and control prediction goes through;
    ``attack_wrap`` is what the ATTACKER differentiates, with ``--eot K``
    the mean of K fixed draws (Athalye et al. 2018)."""
    import torch

    from pointsecguard_tpu_torch.attacks import (
        apply_color_defense,
        bit_depth_reduction,
        jpeg_color_compression,
        random_color_jitter,
        random_color_resample,
        randomized_defense_wraps,
        seeded_draws,
    )

    randomized = ("jitter", "resample")
    if args.eot > 1 and args.defense not in randomized:
        raise SystemExit(
            "--eot requires a randomized defense (jitter or resample); "
            "it averages attack gradients over the defense's noise draws"
        )
    if args.defense == "none":
        return None
    if args.defense == "bit_depth":
        wrap = lambda f: apply_color_defense(f, bit_depth_reduction, args.defense_bits)
        return wrap, wrap
    if args.defense == "jpeg":
        wrap = lambda f: apply_color_defense(f, jpeg_color_compression,
                                             args.defense_quality)
        return wrap, wrap
    if args.defense == "jitter":
        sigma = args.defense_sigma
        transform = lambda p, d: random_color_jitter(p, sigma, noise=d)
        sample = lambda shape, g: torch.randn(shape[:-1] + (3,), generator=g)
    else:  # resample
        k = args.defense_knn
        transform = lambda p, d: random_color_resample(p, k, choice=d)
        sample = lambda shape, g: torch.randint(0, min(k, shape[1]), shape[:2] + (1,),
                                                generator=g)
    return randomized_defense_wraps(transform, seeded_draws(sample, args.seed + 99),
                                    args.eot)
