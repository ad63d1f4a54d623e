"""Training cells: the port trainer's host-fed path, as ``cli.train``
takes it without ``--device_sampler``: ``train/loops.py:_host_epoch``
over batches of the cell's pool, copied to the device by
``data/loader.py:make_batch_put`` on the prefetch thread, each a call of
``train/trainer.py:make_multi_train_step`` (one step a call), the losses
read back once at the end as the epoch loop reads them.

Set-up makes one ``TrainState`` and drives it through its first three
steps on distinct batches of the pool, which the reference follows (the
last two also time the estimate); the window continues on the same
state.

Workload keys: ``batch``, ``points``, ``pool`` (``core/traffic.make_pool``),
``lr``, ``weight_decay``, ``prefetch`` (the loader's depth), ``check``
(``limits`` of each number) and ``profile`` (``units``: steps under the
device profiler, then one under the host profiler).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from perfbench.core import run as runlib
from perfbench.core import trace, traffic, weights
from perfbench.reference import adam
from perfbench.reference.adam import B1


def run(cell, r: runlib.Run) -> dict:
    from pointsecguard_tpu_torch.data.loader import make_batch_put
    from pointsecguard_tpu_torch.train.loops import _epoch_losses, _host_epoch
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_multi_train_step

    cfg, wl = cell.config, cell.workload
    ref, port = cell.reference, cell.port
    dev = r.device
    B, P = wl["batch"], wl["points"]
    marks = runlib.Marks(r.started)
    marks("imports")
    spec = ref.param_spec(cfg)
    init = weights.make_state(spec, cfg["init"], r.seed, dev)
    marks("weights")
    pool = traffic.make_pool(wl["pool"], B, P, r.seed)
    marks("inputs")
    model, family = port.build(cfg, dev, r.precision or cfg["precision"])
    model.load_state_dict(init)
    leaves = {}
    at = 0
    for name, p in model.named_parameters():
        leaves[name] = (at, p.shape)
        at += p.numel()
    ts = TrainState(model)
    captured = {}
    step = capture(r.hook("step", make_multi_train_step(model, port.loss(), family=family,
                                                        weight_decay=wl["weight_decay"])),
                   model, port, captured, CHECKED)
    put = make_batch_put(dev, wl["prefetch"])
    gen = torch.Generator(device=dev).manual_seed(r.seed + 1)
    ones = torch.ones(cfg["num_classes"], device=dev)
    marks("model")

    def epoch(first: int, n: int) -> list:
        batches = (pool[i % len(pool)] for i in range(first, first + n))
        return _host_epoch(step, ts, batches, put, wl["prefetch"], 1, ones, wl["lr"], None, gen)

    # the first step, on the window's own path
    _epoch_losses(epoch(0, 1))
    marks("first step")
    # two more steps time the estimate
    t = time.perf_counter()
    _epoch_losses(epoch(1, 2))
    estimate = (time.perf_counter() - t) / 2
    marks("warm-up")
    if r.trace:
        trace.warm_profiler(dev)
        marks("profiler")
    done = 3
    n = max(1, int(r.seconds / max(estimate, 1e-9)))
    rec = {"setup_s": time.perf_counter() - r.started, "setup_parts": marks.parts}

    t0 = time.perf_counter()
    _, n_steps, skipped = _epoch_losses(epoch(done, n))
    t1 = time.perf_counter()
    rec.update(units=[(t0, t1)], samples_per_unit=B * n_steps, window_s=t1 - t0,
               steps=n_steps)
    forward = cfg["flops"]["forward_per_block"] if cfg["flops"]["points"] == P \
        else ref.forward_flops(cfg, P)
    rec["flops_per_unit"] = 3 * forward * B * n_steps  # forward, and a backward of two
    if r.trace:
        tr, units = trace.Traced(dev), wl["profile"]["units"]
        tr.start("device")
        _epoch_losses(epoch(done + n, units))
        tr.stop("device")
        tr.start("host")
        _epoch_losses(epoch(done + n + units, 1))
        tr.stop("host")
        rec["trace"] = tr.summary()
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec["attempted"], rec["failed"] = B * n_steps, B * skipped

    del model, family, ts, step, put
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["checks"] = check(cell, r, spec, init, pool, captured, leaves)
    return rec


CHECKED = (1, 2, 3)  # the steps the reference follows


def capture(fn, model, port, captured: dict, which):
    """``fn``, which also keeps, for the calls numbered ``which`` (from
    1), the state before and after (parameters, moments, count), the
    losses and the graphs, in host memory."""
    calls = [0]

    def state_of(ts):
        return [runlib.to_host(t) for t in (ts.params, ts.mu, ts.nu, ts.count)]

    def step(state, *args, **kw):
        calls[0] += 1
        if calls[0] not in which:
            return fn(state, *args, **kw)
        before = state_of(state)
        graphs = port.graphs(model) if port.graphs else contextlib.nullcontext()
        with graphs as got:
            losses = fn(state, *args, **kw)
        captured[calls[0]] = {"before": before, "after": state_of(state),
                              "losses": runlib.to_host(losses),
                              "graphs": got or []}
        return losses

    return step


def check(cell, r, spec, init, pool, captured, leaves) -> dict:
    """The first three steps against the reference's, each from the
    batch the step took. The first from the same weights as the port's:
    its loss, its gradient as Adam receives it (the port's from its first
    moment, μ₁ / (1 − β₁)), and the parameters' change, both by the worst
    leaf. The two later ones from the port's own state before the step,
    since the port's runs do not repeat one another past the first (a
    gather's atomic backward leaves the first gradients a few 1e-7 apart,
    and Adam's sign-like first step sets the entries that rounding leaves
    at nought apart by the learning rate): the loss; the gradient, the
    port's from its moments before and after, (μₜ − β₁ μₜ₋₁) / (1 − β₁);
    and Adam's update from the port's moments before the step and that
    gradient, at the reference's own step count, against the port's
    second moment and change. The graphs of every step, exactly. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out of the gradients and the first change: Adam moves them
    by round-off alone."""
    cfg, wl = cell.config, cell.workload
    ref, dev = cell.reference, r.device
    names = [n for n, _, _, role in spec if role in ("weight", "bias", "bn_scale", "bn_bias")]
    buffers = {k: v for k, v in init.items() if k not in names}

    def unflatten(flat):
        flat = flat.to(dev, torch.float32)
        return {k: flat[o:o + math.prod(s)].view(s) for k, (o, s) in leaves.items()}

    def reference_step(params: dict, t: int):
        """→ (loss, gradients with the weight decay, graphs) at ``params``
        on the batch of step ``t``."""
        params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        pts_np, labs_np = pool[(t - 1) % len(pool)]
        graphs = []
        out = ref.forward({**params, **buffers}, torch.from_numpy(pts_np).to(dev), cfg,
                          stats={}, **({"graphs": graphs} if cell.port.graphs else {}))
        loss = ref.loss(out, torch.from_numpy(labs_np).to(dev))
        grads = dict(zip(names, torch.autograd.grad(loss, list(params.values()))))
        grads = {k: g + wl["weight_decay"] * params[k].detach() for k, g in grads.items()}
        return float(loss.detach()), grads, graphs

    def counted(grads):
        norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}
        median = sorted(norms.values())[len(norms) // 2]
        return [k for k in names if norms[k] >= 1e-3 * median]

    numbers = {}
    geo_port, geo_ref = [], []
    for t in CHECKED:
        got = captured[t]
        p0, mu0, nu0 = (unflatten(x) for x in got["before"][:3])
        p1, mu1, nu1 = (unflatten(x) for x in got["after"][:3])
        start = {k: init[k] for k in names} if t == 1 else p0
        loss, g, graphs = reference_step(start, t)
        geo_port += got["graphs"]
        geo_ref += graphs
        keep = counted(g)
        port_loss = float(got["losses"].reshape(-1)[0])
        port_g = {k: (mu1[k] - B1 * mu0[k]) / (1.0 - B1) for k in names}
        gaps = {"loss_gap": abs(port_loss - loss) / abs(loss),
                "grad_norm_gap": runlib.worst_leaf_gap({k: port_g[k] for k in keep},
                                                       {k: g[k] for k in keep})}
        if t == 1:
            gaps["update_norm_gap"] = runlib.worst_leaf_gap(
                {k: p0[k] - p1[k] for k in keep},
                {k: adam.update(mu0[k], nu0[k], 1, g[k], wl["lr"])[2] for k in keep})
            numbers.update(gaps)
            continue
        want = {k: adam.update(mu0[k], nu0[k], t, port_g[k], wl["lr"]) for k in names}
        gaps["moment_gap"] = runlib.worst_leaf_gap(nu1, {k: want[k][1] for k in names})
        gaps["update_norm_gap"] = runlib.worst_leaf_gap(
            {k: p0[k] - p1[k] for k in names}, {k: want[k][2] for k in names})
        for k, v in gaps.items():
            numbers[f"later_{k}"] = max(numbers.get(f"later_{k}", 0.0), v)
    numbers["geometry_mismatch"] = runlib.mismatch_share(geo_port, geo_ref)
    limits = wl["check"]["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
