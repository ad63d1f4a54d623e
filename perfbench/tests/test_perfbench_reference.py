"""The plain references against the port on the CPU at a small size, on
the benchmark's own weights and blocks: the geometry, the forward, the NB
attack, and a training step's loss and gradients. The references import
nothing of the port, of JAX or of the JAX package."""

from __future__ import annotations

import subprocess
import sys

import torch

from perfbench.core import traffic, weights
from perfbench.reference import adam as ref_adam
from perfbench.reference import attack as ref_attack
from perfbench.reference import pointnet2_ssg, resgcn
from perfbench.reference.layers import set_statistics
from perfbench.tests.small import small_cell

CPU = torch.device("cpu")


def _setup(name, seed=5):
    cell = small_cell(name)
    cfg, wl = cell.config, cell.workload
    ref, port = cell.reference, cell.port
    state = weights.make_state(ref.param_spec(cfg), cfg["init"], seed, CPU)
    pts, labs = traffic.make_pool(wl["pool"], wl["batch"], wl["points"], seed)[0]
    pts, labs = torch.from_numpy(pts), torch.from_numpy(labs)
    stats = {}
    with torch.no_grad():
        ref.forward(state, pts, cfg, stats=stats)
    set_statistics(state, stats)
    model, family = port.build(cfg, CPU, "float32")
    model.load_state_dict(state)
    return cell, state, pts, labs, model, family


def test_ssg_geometry_and_forward():
    cell, state, pts, labs, model, family = _setup("ssg-nb")
    cfg = cell.config
    model.eval()
    with torch.no_grad():
        plan = family.plan(pts)
        rplan = pointnet2_ssg.plan(pts, cfg)
        for a, b in zip(cell.port.geometry_arrays(plan), pointnet2_ssg.geometry_arrays(rplan)):
            assert torch.equal(a.to(b.dtype), b)
        out = family.head(family.apply(model, pts, plan))
        ref = pointnet2_ssg.forward(state, pts, cfg, rplan)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def test_resgcn_forward():
    cell, state, pts, labs, model, family = _setup("resgcn-nb")
    model.eval()
    with torch.no_grad():
        out = family.head(family.apply(model, pts, None))
        ref = resgcn.forward(state, pts, cell.config)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def test_resgcn_graphs():
    cell, state, pts, labs, model, family = _setup("resgcn-nb")
    model.eval()
    graphs = []
    with torch.no_grad(), cell.port.graphs(model) as got:
        family.apply(model, pts, None)
        resgcn.forward(state, pts, cell.config, graphs=graphs)
    assert len(got) == len(graphs) == cell.config["n_blocks"]
    for a, b in zip(got, graphs):
        assert torch.equal(a, b)


def test_adam_update_at_a_later_step():
    from pointsecguard_tpu_torch.train.trainer import TrainState, adam_update

    model = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.BatchNorm1d(3))
    ts = TrainState(model)
    gen = torch.Generator().manual_seed(3)
    mu, nu = torch.zeros_like(ts.params), torch.zeros_like(ts.params)
    for t in (1, 2, 3):
        g = torch.randn(ts.params.shape, generator=gen)
        before = ts.params.clone()
        ts.grads.copy_(g)
        adam_update(ts, 1e-3, weight_decay=0.0)
        mu, nu, step = ref_adam.update(mu, nu, t, g, 1e-3)
        assert torch.equal(ts.mu, mu) and torch.equal(ts.nu, nu)
        torch.testing.assert_close(ts.params, before - step, rtol=0, atol=1e-7)


def test_nb_attack():
    from pointsecguard_tpu_torch.attacks import attack_preset, pgd_color_attack

    cell, state, pts, labs, model, family = _setup("ssg-nb")
    cfg = cell.config
    model.eval().requires_grad_(False)
    preset = attack_preset("pointnet2", "nb")
    plan = family.plan(pts)
    res = pgd_color_attack(lambda p: family.head(family.apply(model, p, plan)), pts, labs.long(),
                           preset)
    rplan = pointnet2_ssg.plan(pts, cfg)
    adv = ref_attack.nb_attack(lambda p: pointnet2_ssg.forward(state, p, cfg, rplan), pts, labs,
                               eps=preset.eps, alpha=preset.alpha, iters=preset.iters)
    assert torch.equal(res.points_adv, adv)
    assert not torch.equal(adv, pts)


def test_resgcn_train_step():
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step

    cell, state, pts, labs, model, family = _setup("resgcn-train")
    names = [n for n, _ in model.named_parameters()]
    ts = TrainState(model)
    step = make_train_step(model, cell.port.loss(), weight_decay=0.0, family=family)
    loss = step(ts, pts, labs.long(), torch.ones(13), 1e-3, None)
    params = {k: state[k].clone().requires_grad_(True) for k in names}
    buffers = {k: v for k, v in state.items() if k not in params}
    ref_loss = resgcn.loss(resgcn.forward({**params, **buffers}, pts, cell.config, stats={}), labs)
    grads = torch.autograd.grad(ref_loss, list(params.values()))
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(ts.grads, torch.cat([g.reshape(-1) for g in grads]),
                               rtol=1e-5, atol=1e-7)


def test_references_import_nothing_of_the_port():
    code = ("import sys\n"
            "import perfbench.reference.pointnet2_ssg, perfbench.reference.resgcn\n"
            "import perfbench.reference.attack, perfbench.reference.adam\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'pointsecguard_tpu', 'pointsecguard_tpu_torch'})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(__import__("perfbench").__path__[0] + "/.."), check=True)
    assert out.stdout.strip() == "[]"
