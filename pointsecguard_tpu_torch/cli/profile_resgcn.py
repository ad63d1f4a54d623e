"""Breakdown of one ResGCN-28 NB batch (8 × 4096 points, 50 iterations)
or, with ``--train``, of one train step (8 × 4096 points) on the card.

    python -m pointsecguard_tpu_torch.cli.profile_resgcn [--train] [--out FILE]

Run from the root of a checkout: the set-up is ``chip_smoke.py``'s own
(the first 8 whole-scene blocks of its synthetic room at 25k points/m²,
its full-width checkpoint with calibrated BatchNorm statistics for the
attack, the trainer's initialisation for the step), so the numbers
describe what the smoke run drives. Prints, as JSON, the median
CUDA-event time of each part — the graph builds of one forward (the 4 kNN
kernel calls and the 24 large-k sorts apart), the forward, the forward +
input backward (or + parameter backward) and the whole batch or step —
the host-clock wall of whole batches or steps, the peak device memory,
and from one of them under ``torch.profiler`` the device busy time, the
kernels launched and the device idle share (1 − busy / host wall
median); then the profiler's operator table by self CUDA time. A whole
NB batch takes ~16 s, so it is timed once by CUDA events and twice by
the host's clock. ``--out`` also writes both to FILE.
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
    ap.add_argument("--train", action="store_true",
                    help="one train step of 8 blocks instead of one NB batch of 8")
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.attacks import attack_preset, pgd_color_attack
    from pointsecguard_tpu_torch.cli.profile_randla import _busy_ms
    from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters
    from pointsecguard_tpu_torch.models.resgcn import ce_loss
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, resgcn_family
    from pointsecguard_tpu_torch.utils.runtime import require_cuda

    dev = require_cuda()
    card = cs.card_line()
    print(card, flush=True)
    blocks = cs.train_blocks(dev, cs.RESGCN_BATCH)
    labels = torch.randint(0, 13, blocks.shape[:2], device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    res = {"card": card, "what": (f"train step, {cs.RESGCN_BATCH} blocks" if args.train
                                  else f"NB batch, {cs.RESGCN_BATCH} blocks")}
    model = DenseDeepGCN()
    if args.train:
        init_parameters(model, torch.Generator().manual_seed(0), scale=2.0)
        state = TrainState(model.to(dev))
    else:
        model.load_state_dict(cs.resgcn_state_dict(0, blocks))
        model.to(dev).eval().requires_grad_(False)
    inputs, _ = cs.block_inputs(model, blocks)
    feats = [blocks[..., :3]] + [inputs[i] for i in range(len(model.backbone))]
    dilations = [1] + [1 + i for i in range(len(model.backbone))]
    kernel_calls = [(x, d) for x, d in zip(feats, dilations) if model.k * d <= 48]
    sort_calls = [(x, d) for x, d in zip(feats, dilations) if model.k * d > 48]

    def graphs(calls):
        return lambda: [ops.dilate_neighbors(ops.dense_knn_graph(x, model.k * d), d)
                        for x, d in calls]

    parts = [(f"graph builds, {len(kernel_calls)} on the kNN kernel", graphs(kernel_calls), 10),
             (f"graph builds, {len(sort_calls)} large-k sorts", graphs(sort_calls), 5)]
    if args.train:
        step = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family())

        def whole():
            return step(state, blocks, labels, None, 1e-5, None)

        def forward():
            model.train()
            with torch.no_grad():
                return model(blocks)

        def forward_backward():
            model.train()
            state.grads.zero_()
            ce_loss(model(blocks), labels).backward()

        parts += [("forward, train mode", forward, 5),
                  ("forward + backward", forward_backward, 5),
                  ("whole step, CUDA events", whole, 5)]
        host_runs, profiled = 10, 3
    else:
        cfg = attack_preset("resgcn", "nb")

        def forward():
            with torch.no_grad():
                return model(blocks)

        def forward_backward():
            c = blocks[..., 3:6].detach().requires_grad_(True)
            out = model(torch.cat([blocks[..., :3], c, blocks[..., 6:]], -1))
            return torch.autograd.grad(out.sum(), c)

        def whole():  # what the attack CLI does per batch, transfers included
            with torch.no_grad():
                pred = torch.argmax(model(blocks), dim=-1)
            r = pgd_color_attack(model, blocks, labels, cfg)
            return r.adv_pred.cpu(), pred.cpu()

        parts += [("forward", forward, 5), ("forward + input backward", forward_backward, 5),
                  ("whole batch, CUDA events", whole, 1)]
        host_runs, profiled = 2, 1

    for name, fn, reps in parts:
        res[name + " ms"] = cs.cuda_ms(fn, reps=reps, warmup=1)
    walls = []
    for _ in range(host_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    res[f"whole, host clock median of {host_runs} ms"] = statistics.median(walls)
    res["host clock min, max ms"] = [min(walls), max(walls)]
    torch.cuda.reset_peak_memory_stats()
    whole()
    torch.cuda.synchronize()
    res["peak device memory GB"] = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            whole()
        torch.cuda.synchronize()
    busy, kernels = _busy_ms(prof, profiled)
    res["profiled: device busy ms"] = busy
    res["profiled: kernels launched"] = kernels
    res["device idle share vs unprofiled host median"] = (
        1 - busy / statistics.median(walls))
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
