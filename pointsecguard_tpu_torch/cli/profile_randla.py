"""Breakdown of one RandLA NB batch (4 × 40960 points) or, with
``--train``, of one RandLA optimizer step (6 × 40960 points) on the card.

    python -m pointsecguard_tpu_torch.cli.profile_randla [--fused_ap] [--train] \
        [--randla_dataset s3dis|semantic3d|semantickitti] [--out FILE]

Run from the root of a checkout: the set-up is ``chip_smoke.py``'s own
(its synthetic rooms prepared at 0.04 m, one sampler batch, its
calibrated full-width checkpoint), so the numbers describe the batch the
smoke run attacks. Prints, as JSON, the median CUDA-event time of each
part of a batch, the host-clock wall of 10 whole batches, the peak
device memory, and from 3 batches under ``torch.profiler`` the device
busy time, the kernels launched per batch and the device idle share
(1 − busy / host wall median); then the profiler's operator table by
self CUDA time. ``--fused_ap`` profiles the model with
``ap_impl="fused"``. ``--train`` profiles the trainer's step instead, on
one batch of the train cloud's sampler and the flax-style initial weights:
the pyramid, pyramid + forward + backward, the whole step (the Adam
update and the NaN guard included). ``--out`` also writes the JSON and the
table to FILE. ``--randla_dataset semantic3d|semantickitti`` profiles
that preset instead, at its config's batch and points, on the clouds of
``chip_smoke.py`` phase 52 (Semantic3D's NB batch of 4 × 65536 on a
calibrated 8-class model; the steps with the preset's class weights and
ignored-label loss); SemanticKITTI's xyz-only clouds take ``--train``
only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _busy_ms(prof, batches: int) -> tuple[float, float]:
    """(device busy ms, kernels) per batch: the union of the intervals of
    the profiled device events, so overlapping kernels count once."""
    import torch

    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.time_range.elapsed_us() > 0]
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in ev):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / batches / 1e3, len(ev) / batches


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fused_ap", action="store_true",
                    help="the fused attentive-pooling kernels (ap_impl='fused')")
    ap.add_argument("--train", action="store_true",
                    help="one optimizer step of 6 clouds instead of one NB batch of 4")
    ap.add_argument("--randla_dataset", default="s3dis",
                    choices=["s3dis", "semantickitti", "semantic3d"],
                    help="the preset profiled, at its config's batch and points")
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)
    if args.randla_dataset == "semantickitti" and not args.train:
        ap.error("semantickitti clouds are xyz-only: no colour attack to profile "
                 "(use --train)")

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from pointsecguard_tpu_torch.attacks import attack_preset, pgd_color_attack
    from functools import partial

    from pointsecguard_tpu_torch.data import make_synthetic_rooms
    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import (
        RandLANet,
        build_pyramid,
        init_parameters,
        weighted_softmax_ce_loss,
    )
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, randla_family
    from pointsecguard_tpu_torch.utils.runtime import require_cuda

    dev = require_cuda()
    card = cs.card_line()
    print(card, flush=True)
    cs.WORK = os.path.join("build", "profile_randla")
    os.makedirs(cs.WORK, exist_ok=True)
    data = os.path.join(cs.WORK, "data")
    make_synthetic_rooms(data, points_per_room=cs.ROOM_POINTS, seed=0)
    preset = randla_dataset_preset(args.randla_dataset)
    cfg, K = preset.cfg, preset.num_classes
    outdoor = args.randla_dataset != "s3dis"
    if outdoor:
        prep = cs.phase_prepare_outdoor(data)[args.randla_dataset]
    else:
        prep = cs.prepare_randla(data)
    ap_impl = "fused" if args.fused_ap else "reference"
    model = RandLANet(num_classes=K, d_out=cfg.d_out, d_in=6 if preset.has_colors else 3,
                      ap_impl=ap_impl)
    res = {"card": card, "ap_impl": ap_impl, "randla_dataset": preset.name}

    def build_pyramid_cfg(xyz):
        return build_pyramid(xyz, num_layers=cfg.num_layers, k=cfg.k_n,
                             sub_ratios=cfg.sub_sampling_ratio)

    if args.train:
        if outdoor:
            feats, labels = cs.outdoor_batch(prep, preset.name, "train", dev, seed=0)
        else:
            feats, labels = cs.randla_train_batch(prep, dev, cs.RANDLA_TRAIN_BATCH,
                                                  cs.RANDLA_POINTS, 0)
        res["what"] = f"train step, {feats.shape[0]} x {feats.shape[1]} points"
        init_parameters(model, torch.Generator().manual_seed(0))
        state = TrainState(model.to(dev))
        family = randla_family(cfg)
        loss_fn = (partial(weighted_softmax_ce_loss,
                           label_table=torch.from_numpy(preset.label_table()).to(dev))
                   if preset.ignored_labels else weighted_softmax_ce_loss)
        step = make_train_step(model, loss_fn, weight_decay=0.0, family=family)
        weights = torch.from_numpy(get_class_weights(preset.weights_key)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def batch():
            return step(state, feats, labels, weights, 1e-4, None, gen)

        def forward_backward():
            model.train()
            state.grads.zero_()
            pyr = family.plan(feats)
            out = model(feats, pyr, generator=gen)
            loss_fn(out, labels, weights).backward()

        parts = (
            ("build_pyramid", lambda: build_pyramid_cfg(feats[..., :3]), 10),
            ("pyramid + forward + backward", forward_backward, 10),
            ("whole step, CUDA events", batch, 10),
        )
    else:
        if outdoor:
            feats, _ = cs.outdoor_batch(prep, preset.name, "test", dev, seed=7)
            sd = cs.randla_state_dict(0, dev, feats, floats=cs.SEM3D_STATE_FLOATS,
                                      num_classes=K)
        else:
            feats = cs.randla_batch(prep, dev)
            sd = cs.randla_state_dict(0, dev, feats)
        labels = torch.randint(0, K, feats.shape[:2], device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
        res["what"] = f"NB batch, {feats.shape[0]} x {feats.shape[1]} points"
        model.load_state_dict(sd)
        model.to(dev).eval().requires_grad_(False)
        attack_cfg = attack_preset("randla", "nb", **({"num_classes": K} if K != 13 else {}))
        gen = torch.Generator(device=dev).manual_seed(0)
        pyr = build_pyramid_cfg(feats[..., :3])
        with torch.no_grad():
            _, pos = model(feats, pyr, collect_pos=True)

        def collect():
            with torch.no_grad():
                return model(feats, pyr, collect_pos=True)

        def fwd_bwd():
            c = feats[..., 3:6].detach().requires_grad_(True)
            out = model(torch.cat([feats[..., :3], c], -1), pyr, pos_plan=pos)
            return torch.autograd.grad(out.sum(), c)

        def attack():
            return pgd_color_attack(lambda f: model(f, pyr, pos_plan=pos), feats,
                                    labels, attack_cfg, generator=gen)

        def batch():  # what the driver does per batch, transfers included
            with torch.no_grad():
                p = build_pyramid_cfg(feats[..., :3])
                logits, ps = model(feats, p, collect_pos=True)
            r = pgd_color_attack(lambda f: model(f, p, pos_plan=ps), feats, labels,
                                 attack_cfg, generator=gen)
            return r.adv_pred.cpu(), logits.argmax(-1).cpu()

        parts = (
            ("build_pyramid", lambda: build_pyramid_cfg(feats[..., :3]), 10),
            ("collect forward (clean pred + pos plan)", collect, 10),
            ("one forward + input backward", fwd_bwd, 10),
            ("attack: 10 iterations + final forward", attack, 5),
            ("whole batch, CUDA events", batch, 5),
        )
    for name, fn, reps in parts:
        res[name + " ms"] = cs.cuda_ms(fn, reps=reps)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    res["whole batch, host clock median of 10 ms"] = statistics.median(walls)
    res["host clock min, max ms"] = [min(walls), max(walls)]
    torch.cuda.reset_peak_memory_stats()
    batch()
    torch.cuda.synchronize()
    res["peak device memory GB"] = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            batch()
        torch.cuda.synchronize()
    busy, kernels = _busy_ms(prof, 3)
    res["profiled: device busy per batch ms"] = busy
    res["profiled: kernels per batch"] = kernels
    res["device idle share vs unprofiled host median"] = (
        1 - busy / res["whole batch, host clock median of 10 ms"])
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    print(json.dumps(res, indent=1))
    print(table)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(res, indent=1) + "\n" + table + "\n")
    return res


if __name__ == "__main__":
    main()
