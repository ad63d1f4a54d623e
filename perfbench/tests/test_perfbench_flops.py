"""Each configuration's FLOP count: the file's number is the reference's
count at the published sizes, and the count is a hand count at a small
width and the sum over the Linear calls a forward makes."""

from __future__ import annotations

import pytest
import torch

from perfbench.core import weights
from perfbench.core.cell import BENCH_DIR, load_json
from perfbench.reference import pointnet2_ssg, resgcn

SSG_SMALL = {"in_channels": 9, "num_classes": 3, "sa_npoints": [8, 4], "sa_radii": [0.5, 1.0],
             "sa_nsamples": [4, 4], "sa_mlps": [[4, 8], [8, 8]], "fp_mlps": [[8], [6]],
             "head": [5]}
RESGCN_SMALL = {"in_channels": 9, "num_classes": 2, "n_blocks": 3, "n_filters": 4, "k": 2,
                "fusion": 6, "pred": [5, 3]}
# by hand: SSG 2·(32·80 + 16·152 + 8·128 + 16·48 + 16·30 + 16·15);
# ResGCN 2·(16·72 + 2·16·32 + 8·72 + 8·90 + 8·15 + 8·6)
HAND = {"ssg": (pointnet2_ssg, SSG_SMALL, 16, 15008), "resgcn": (resgcn, RESGCN_SMALL, 8, 7280)}


@pytest.mark.parametrize("name", ["pointnet2-ssg", "resgcn-28"])
def test_file_count_is_the_reference_count(name):
    cfg = load_json(BENCH_DIR / "configs" / f"{name}.json")
    ref = {"pointnet2_ssg": pointnet2_ssg, "resgcn": resgcn}[cfg["model"]]
    assert cfg["flops"]["forward_per_block"] == ref.forward_flops(cfg, cfg["flops"]["points"])


@pytest.mark.parametrize("which", sorted(HAND))
def test_count_is_the_hand_count(which):
    ref, cfg, points, hand = HAND[which]
    assert ref.forward_flops(cfg, points) == hand


@pytest.mark.parametrize("which", sorted(HAND))
def test_count_is_the_linear_calls(which, monkeypatch):
    ref, cfg, points, hand = HAND[which]
    state = weights.make_state(ref.param_spec(cfg), "uniform_fan_in", 0, torch.device("cpu"))
    done = []
    inner = ref.linear

    def counting(x, st, name):
        w = st[name + ".weight"]
        done.append(2 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1])
        return inner(x, st, name)

    monkeypatch.setattr(ref, "linear", counting)
    pts = torch.rand(1, points, 9, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref.forward(state, pts, cfg)
    assert sum(done) == hand
