"""Breakdown of one NB batch (8 × 4096 points) or, with ``--train``, of
one train step (32 × 4096 points) on the card, for PointNet++ SSG
(``--model pointnet2``, the default), MSG or PointNet.

    python -m pointsecguard_tpu_torch.cli.profile_pointnet2 \
        [--model pointnet2|pointnet2_msg|pointnet] [--train] [--out FILE]

Run from the root of a checkout: the set-up is ``chip_smoke.py``'s own
(its synthetic room at 25k points/m², its calibrated full-width
checkpoint for the attack, the trainer's initialisation for the step), so
the numbers describe what the smoke run drives. PointNet builds no
geometry: its "geometry" part times the family's plan, which is None. Prints, as JSON, the
median CUDA-event time of each part, the host-clock wall of 10 whole
batches or steps, the peak device memory, and from 3 of them under
``torch.profiler`` the device busy time, the kernels launched and the
device idle share (1 − busy / host wall median); then the profiler's
operator table by self CUDA time. ``--out`` also writes both to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="pointnet2",
                    choices=["pointnet2", "pointnet2_msg", "pointnet"])
    ap.add_argument("--train", action="store_true",
                    help="one train step of 32 blocks instead of one NB batch of 8")
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from pointsecguard_tpu_torch.attacks import attack_preset, pgd_color_attack
    from pointsecguard_tpu_torch.cli.profile_randla import _busy_ms
    from pointsecguard_tpu_torch.models import init_parameters, weighted_nll_loss
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET_MODELS,
        TrainState,
        make_train_step,
    )
    from pointsecguard_tpu_torch.utils.runtime import require_cuda

    dev = require_cuda()
    card = cs.card_line()
    print(card, flush=True)
    n = cs.TRAIN_BATCH if args.train else cs.BATCH
    blocks = cs.train_blocks(dev, n)
    labels = torch.randint(0, 13, blocks.shape[:2], device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    model_cls, family = POINTNET_MODELS[args.model]
    model = model_cls()
    res = {"card": card, "model": args.model,
           "what": f"train step, {n} blocks" if args.train else f"NB batch, {n} blocks"}

    if args.train:
        init_parameters(model, torch.Generator().manual_seed(0))
        state = TrainState(model.to(dev))
        step = make_train_step(model, weighted_nll_loss, family=family)
        weights = torch.ones(13, device=dev)

        def whole():
            return step(state, blocks, labels, weights, 1e-4, 0.1, gen)

        def forward_backward():
            model.train()
            state.grads.zero_()
            plan = family.plan(blocks, generator=gen)
            out = family.apply(model, blocks, plan, 0.1, generator=gen)
            loss = weighted_nll_loss(family.head(out), labels, weights)
            if family.aux_loss is not None:
                loss = loss + family.aux_loss(out)
            loss.backward()

        parts = (
            ("geometry, random starts", lambda: family.plan(blocks, generator=gen), 10),
            ("geometry + forward + backward", forward_backward, 10),
            ("whole step, CUDA events", whole, 10),
        )
    else:
        model.load_state_dict(cs.calibrated_state_dict(0, dev, args.model))
        model.to(dev).eval().requires_grad_(False)
        cfg = attack_preset("pointnet2", "nb")
        plan = family.plan(blocks)

        def outputs(p, g=plan):
            return family.head(family.apply(model, p, g))

        def clean():
            with torch.no_grad():
                return outputs(blocks)

        def fwd_bwd():
            c = blocks[..., 3:6].detach().requires_grad_(True)
            out = outputs(torch.cat([blocks[..., :3], c, blocks[..., 6:]], -1))
            return torch.autograd.grad(out.sum(), c)

        def whole():  # what the attack CLI does per batch, transfers included
            g = family.plan(blocks)
            with torch.no_grad():
                pred = torch.argmax(outputs(blocks, g), dim=-1)
            r = pgd_color_attack(lambda p: outputs(p, g), blocks, labels, cfg)
            return r.adv_pred.cpu(), pred.cpu()

        parts = (
            ("geometry", lambda: family.plan(blocks), 10),
            ("clean forward", clean, 10),
            ("one forward + input backward", fwd_bwd, 10),
            ("whole batch, CUDA events", whole, 5),
        )

    for name, fn, reps in parts:
        res[name + " ms"] = cs.cuda_ms(fn, reps=reps)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    res["whole, host clock median of 10 ms"] = statistics.median(walls)
    res["host clock min, max ms"] = [min(walls), max(walls)]
    torch.cuda.reset_peak_memory_stats()
    whole()
    torch.cuda.synchronize()
    res["peak device memory GB"] = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            whole()
        torch.cuda.synchronize()
    busy, kernels = _busy_ms(prof, 3)
    res["profiled: device busy ms"] = busy
    res["profiled: kernels launched"] = kernels
    res["device idle share vs unprofiled host median"] = (
        1 - busy / res["whole, host clock median of 10 ms"])
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
