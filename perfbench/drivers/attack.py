"""Attack cells: the per-batch path of the port's block attack driver
(``cli/_attack_blocks.py:run_blocks``) on batches of the cell's pool.

A batch: the host arrays copied to the device, the closure of
``member_factory`` (the family's plan, then the forward; PointNet++ builds
its geometry there, ResGCN inside every forward), the clean prediction,
``attacks/pgd.py:pgd_color_attack`` under the workload's preset, the
per-block step counts and distortions read back, the prediction on the
adversarial points, and both predictions read back to the host.

Workload keys: ``attack`` (the preset's attack name), ``batch``,
``points``, ``pool`` (``core/traffic.make_pool``), ``calibrate_blocks``
(blocks of the first batch whose train-mode statistics become the
BatchNorm running statistics; 0 keeps the initial ones), ``warmup_iters``
(two iteration counts whose batches time the estimate), ``check``
(``batches`` compared, ``limits`` of each number) and ``profile``
(``units`` under the device profiler, then one under the host profiler;
or with ``forwards`` three forward calls of one batch: the device
segment runs from the first to the second, the host one to the third).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch

from perfbench.core import run as runlib
from perfbench.core import trace, traffic, weights
from perfbench.reference.attack import COLORS, nb_step
from perfbench.reference.layers import set_statistics


def run(cell, r: runlib.Run) -> dict:
    from pointsecguard_tpu_torch.attacks import attack_preset, pgd_color_attack
    from pointsecguard_tpu_torch.cli._attack_blocks import member_factory

    cfg, wl = cell.config, cell.workload
    ref, port = cell.reference, cell.port
    dev = r.device
    B, P = wl["batch"], wl["points"]
    marks = runlib.Marks(r.started)
    marks("imports")
    state = weights.make_state(ref.param_spec(cfg), cfg["init"], r.seed, dev)
    marks("weights")
    pool = traffic.make_pool(wl["pool"], B, P, r.seed)
    marks("inputs")
    if wl.get("calibrate_blocks"):
        stats = {}
        with torch.no_grad():
            ref.forward(state, torch.from_numpy(pool[0][0][:wl["calibrate_blocks"]]).to(dev),
                        cfg, stats=stats)
        set_statistics(state, stats)
    marks("calibration")
    model, family = port.build(cfg, dev, r.precision or cfg["precision"])
    model.load_state_dict(state)
    model.eval().requires_grad_(False)
    marks("model")
    preset = attack_preset(port.PRESET, wl["attack"])
    attack = r.hook("attack", pgd_color_attack)
    predict = r.hook("predict", lambda out: torch.argmax(out, dim=-1))

    spans = {"plan": [], "attack": []}
    current = {}

    def span():
        """CUDA events around a call in a traced run; none otherwise."""
        return runlib.Span(dev) if r.trace else contextlib.nullcontext()

    def plan(points, generator=None, start_idx=None):
        with span() as s:
            current["plan"] = family.plan(points, generator=generator, start_idx=start_idx)
        current["plan_span"] = s
        return current["plan"]

    live = {"make": member_factory(model, family._replace(plan=plan))}
    kept = {}

    def one(j: int, cfg_attack, make=None, keep: bool = False, timed: bool = False):
        """Batch ``j`` of the pool, as ``run_blocks`` runs a batch; a kept
        batch also hands out its graphs and every colour the attack's
        forward is given."""
        pts_np, labs_np = pool[j % len(pool)]
        with torch.profiler.record_function("perfbench.h2d"):
            pts = torch.from_numpy(pts_np).to(dev)
            labs = torch.from_numpy(labs_np).to(dev).long()
        f = (make or live["make"])(pts)
        graphs = port.graphs(model) if keep and port.graphs else contextlib.nullcontext()
        with torch.no_grad(), graphs as got:
            clean_d = torch.argmax(f(pts), dim=-1)
        iterates = []
        with span() as s:
            res = attack(recording(f, iterates) if keep else f, pts, labs, cfg_attack)
        with torch.profiler.record_function("perfbench.host_read"):
            res.steps_b.cpu(), res.l2_dist.cpu()
        with torch.no_grad():
            adv_d = predict(f(res.points_adv))
        with torch.profiler.record_function("perfbench.host_read"):
            clean, adv = clean_d.cpu().numpy(), adv_d.cpu().numpy()
        if timed and r.trace:
            spans["plan"].append(current.pop("plan_span"))
            spans["attack"].append(s)
        if keep:
            kept[j] = {"plan": current["plan"], "graphs": got, "clean": clean,
                       "iterates": iterates, "adv_points": runlib.to_host(res.points_adv),
                       "adv": adv}
        current.pop("plan", None)

    # warm-up at the cell's shapes, and the estimate of one batch
    lo, hi = wl["warmup_iters"]
    one(0, dataclasses.replace(preset, iters=lo), keep=True)
    marks("first batch")
    times = []
    for n in (lo, hi):
        t = time.perf_counter()
        one(0, dataclasses.replace(preset, iters=n))
        times.append(time.perf_counter() - t)
    per_iter = max((times[1] - times[0]) / (hi - lo), 0.0)
    estimate = max(times[0] - lo * per_iter, 0.0) + preset.iters * per_iter
    marks("warm-up")
    if r.trace:
        trace.warm_profiler(dev)
        marks("profiler")
    sampled = set(runlib.sample_units(r, max(1, int(r.seconds / max(estimate, 1e-9))),
                                      wl["check"]["batches"]))
    # the host memory of the window's kept batches, taken now
    first = kept.pop(0)
    runlib.reserve_host(len(sampled) * ((first["graphs"] or []) + [first["adv_points"]]
                                        + (preset.iters + 1) * first["iterates"][:1]))
    del first
    rec = {"setup_s": time.perf_counter() - r.started, "setup_parts": marks.parts}

    units = runlib.window(r, lambda j: one(j, preset, keep=j in sampled, timed=True), estimate)
    r.sync()
    rec.update(units=units, samples_per_unit=B, iters=preset.iters,
               window_s=units[-1][1] - units[0][0],
               spans_ms={k: [s.ms for s in v] for k, v in spans.items()})
    forward = cfg["flops"]["forward_per_block"] if cfg["flops"]["points"] == P \
        else ref.forward_flops(cfg, P)
    # a clean forward, an input-gradient backward (one forward's worth) and
    # a forward a step, the attack's scoring forward and the adversarial one
    rec["flops_per_unit"] = B * forward * (2 * preset.iters + 3)

    if r.trace:
        prof, tr = wl["profile"], trace.Traced(dev)
        start = len(units)
        if "forwards" in prof:
            # forward calls of one batch: the device segment from the first
            # to the second, the host segment from the second to the third
            marks_at = dict(zip(prof["forwards"], ((None, "device"), ("device", "host"),
                                                   ("host", None))))
            calls = [0]

            def make_counted(pts):
                f = live["make"](pts)

                def counted(p):
                    calls[0] += 1
                    stop, begin = marks_at.get(calls[0], (None, None))
                    if stop:
                        tr.stop(stop)
                    if begin:
                        tr.start(begin)
                    return f(p)

                return counted

            one(start, preset, make=make_counted)
        else:
            tr.start("device")
            for u in range(prof["units"]):
                one(start + u, preset)
            tr.stop("device")
            tr.start("host")
            one(start + prof["units"], preset)
            tr.stop("host")
        rec["trace"] = tr.summary()
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec["attempted"], rec["failed"] = len(units) * B, 0

    live.clear()
    current.clear()
    del model, family
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["checks"], rec["look"] = check(cell, r, state, pool, kept, preset, port, ref)
    return rec


def recording(f, colours: list):
    """``f``, which also keeps the colours of every input it is given."""
    lo, hi = COLORS

    def forward(p):
        colours.append(runlib.to_host(p[..., lo:hi]))
        return f(p)

    return forward


def check(cell, r, state, pool, kept, preset, port, ref) -> tuple[dict, dict]:
    """The sampled batches' outputs against the reference: the geometry
    (the port's plan, or the graphs its clean forward built) exactly; the
    clean and the adversarial predictions under the reference's forward;
    and every step of the attack, followed from the port's own state: the
    reference's step from each colours the port's attack handed its
    forward (the clean ones first) against the port's next ones (its
    output last), as the largest share of a step's colour entries half a
    step or more apart. The port's own runs do not repeat a trajectory
    (a gather's atomic backward flips the sign of an entry that rounding
    leaves at nought, and the flip carries on), so each step starts from
    the port's colours, not the reference's. → (the compared numbers, each
    batch's share of every step)."""
    cfg, limits = cell.config, cell.workload["check"]["limits"]
    dev = r.device
    lo, hi = COLORS
    geo_port, geo_ref = [], []
    clean_gap = adv_gap = step_gap = 0.0
    steps = []
    for j in sorted(kept):
        out = kept[j]
        pts_np, labs_np = pool[j % len(pool)]
        pts = torch.from_numpy(pts_np).to(dev)
        labs = torch.from_numpy(labs_np).to(dev).long()
        graphs = []
        adv_points = out["adv_points"].to(dev)
        with torch.no_grad():
            plan = ref.plan(pts, cfg)
            clean_out = ref.forward(state, pts, cfg, plan,
                                    **({"graphs": graphs} if port.graphs else {}))
            if port.geometry_arrays is not None:
                geo_port += port.geometry_arrays(out["plan"])
                geo_ref += ref.geometry_arrays(plan)
            else:
                geo_port += out["graphs"]
                geo_ref += graphs
            clean_gap = max(clean_gap, runlib.pred_gap(clean_out, torch.from_numpy(out["clean"])))
            adv_gap = max(adv_gap, runlib.pred_gap(ref.forward(state, adv_points, cfg, plan),
                                                   torch.from_numpy(out["adv"])))
        iterates = [c.to(dev) for c in out["iterates"][1:preset.iters]]
        starts = [pts[..., lo:hi]] + iterates
        ends = iterates + [adv_points[..., lo:hi]]
        shares = []
        for start, end in zip(starts, ends):
            want = nb_step(lambda p: ref.forward(state, p, cfg, plan), pts, labs, start,
                           eps=preset.eps, alpha=preset.alpha)
            shares.append(float(((end - want).abs() >= 0.5 * preset.alpha).float().mean()))
        if len(shares) < preset.iters:  # the attack ran fewer steps than its budget
            shares.append(1.0)
        step_gap = max(step_gap, *shares)
        steps.append(shares)
    numbers = {"geometry_mismatch": runlib.mismatch_share(geo_port, geo_ref),
               "clean_pred_gap": clean_gap, "adv_pred_gap": adv_gap,
               "adv_step_mismatch": step_gap}
    return ({k: {"value": v, "limit": limits[k]} for k, v in numbers.items()},
            {"step_color_mismatch": steps})
