"""``--remat`` in the port: ResGCN with each backbone block recomputed in
the backward (``DenseDeepGCN(remat=True)``), on the CPU. One training step
of a 3-block, 16-filter ResGCN with the stochastic dilation on (ε > 0)
and the head's dropout, with and without remat, from one seed: the same
loss, gradients, parameters, Adam moments and running statistics, exactly
(the graph and its draws are built outside the recomputed function, and
the recompute's statistics update is undone), and the same state-dict
keys; the recompute does run in the backward."""

import pytest
import torch

from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters
from pointsecguard_tpu_torch.models.resgcn import EdgeConv, ce_loss
from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, resgcn_family

B, N = 2, 96


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(remat, block="res"):
    model = DenseDeepGCN(n_blocks=3, n_filters=16, k=4, epsilon=0.2, dropout=0.3,
                         block=block, remat=remat)
    init_parameters(model, torch.Generator().manual_seed(0), scale=2.0)
    return model


def _batch():
    g = torch.Generator().manual_seed(1)
    return torch.rand((B, N, 9), generator=g), torch.randint(0, 13, (B, N), generator=g)


@pytest.mark.parametrize("block", ["res", "dense"])
def test_one_step_with_remat_equals_one_without(block, monkeypatch):
    pts, labels = _batch()
    convs = []
    real = EdgeConv.forward

    def counted(self, x, idx):
        convs.append(torch.is_grad_enabled())
        return real(self, x, idx)

    monkeypatch.setattr(EdgeConv, "forward", counted)
    runs = {}
    for remat in (False, True):
        convs.clear()
        model = _model(remat, block)
        state = TrainState(model)
        step = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family())
        loss = step(state, pts, labels, None, 1e-3, None, torch.Generator().manual_seed(2))
        runs[remat] = (loss, state, model, len(convs))
    (l0, s0, m0, c0), (l1, s1, m1, c1) = runs[False], runs[True]
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    for name in ("grads", "params", "mu", "nu", "stats"):
        assert torch.equal(getattr(s0, name), getattr(s1, name)), name
    assert list(m0.state_dict()) == list(m1.state_dict())
    # the head and 2 blocks forward; the 2 blocks once more in the backward
    assert c0 == 3 and c1 == 5
    # the running statistics did move (once)
    assert not torch.equal(s0.stats, TrainState(_model(False, block)).stats)


def test_remat_changes_nothing_outside_training():
    """Evaluation mode and ``no_grad`` take the plain path: the same logits."""
    pts, _ = _batch()
    outs = []
    for remat in (False, True):
        model = _model(remat).eval()
        with torch.no_grad():
            outs.append(model(pts))
    assert torch.equal(outs[0], outs[1])
