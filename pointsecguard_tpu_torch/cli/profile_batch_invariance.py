"""Whether PointNet++ SSG's NB colour gradient on the card is reproducible
and independent of how a batch is split, as ``cli.benchmark --devices 2``
splits one batch of 8 × 4096 over two ranks of 4.

    python -m pointsecguard_tpu_torch.cli.profile_batch_invariance [--deterministic]

Seeded weights (the trainer's initialisation) and a random batch of 8 ×
4096 points with random labels: the log-probabilities and the colour
gradient of the attack's loss (summed cross-entropy over the points / N)
at batch 8 twice, and at batch 8 against its halves at batch 4 each;
then one GEMM of the first level's width and one ``torch.gather``
backward twice. ``--deterministic`` runs it all under
``torch.use_deterministic_algorithms``. Prints, as JSON, for each pair
whether it is bit-equal, the entries apart and the largest difference.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deterministic", action="store_true",
                    help="under torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from pointsecguard_tpu_torch.attacks.common import per_point_ce
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, init_parameters
    from pointsecguard_tpu_torch.models.pointnet2 import build_geometry

    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    model = PointNet2SemSegSSG(13)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(1)
    B, N = 8, 4096
    pts = torch.rand((B, N, 9), generator=g, device=dev)
    labels = torch.randint(0, 13, (B, N), generator=g, device=dev)

    def forward_and_grad(rows: slice):
        x = pts[rows]
        color = x[..., 3:6].clone().requires_grad_(True)
        out, _ = model(torch.cat([x[..., :3], color, x[..., 6:]], dim=-1),
                       build_geometry(x[..., :3].contiguous()))
        (grad,) = torch.autograd.grad(per_point_ce(out, labels[rows]).sum() / N, color)
        return out.detach(), grad

    def apart(a, b) -> dict:
        return {"bit_equal": bool(torch.equal(a, b)), "entries_apart": int((a != b).sum()),
                "max_abs": float((a - b).abs().max())}

    out8, grad8 = forward_and_grad(slice(0, B))
    out8b, grad8b = forward_and_grad(slice(0, B))
    halves = [forward_and_grad(slice(0, B // 2)), forward_and_grad(slice(B // 2, B))]
    out4, grad4 = (torch.cat(t) for t in zip(*halves))

    rows = B * 1024 * 32  # the first level's grouped points
    a = torch.randn((rows, 64), generator=g, device=dev)
    w = torch.randn((128, 64), generator=g, device=dev)
    dy = torch.randn((rows, 128), generator=g, device=dev)
    src = torch.randn((B, N, 64), generator=g, device=dev, requires_grad=True)
    idx = torch.randint(0, N, (B, rows // B, 1), generator=g, device=dev).expand(-1, -1, 64)
    cot = torch.randn((B, rows // B, 64), generator=g, device=dev)
    gathered = [torch.autograd.grad((torch.gather(src, 1, idx) * cot).sum(), src)[0]
                for _ in range(2)]
    res = {"deterministic_algorithms": args.deterministic,
           "forward 8 vs 8": apart(out8, out8b), "grad 8 vs 8": apart(grad8, grad8b),
           "forward 8 vs 4 + 4": apart(out8, out4), "grad 8 vs 4 + 4": apart(grad8, grad4),
           "linear rows 8 vs 4": apart(torch.nn.functional.linear(a, w)[: rows // 2],
                                       torch.nn.functional.linear(a[: rows // 2], w)),
           "linear input grad rows 8 vs 4": apart((dy @ w)[: rows // 2],
                                                  dy[: rows // 2] @ w),
           "gather backward twice": apart(*gathered)}
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
