"""The port's kernels as ``torch.library`` custom ops (``ops/cuda/library.py``).

On the CPU each op runs its plain version; these tests hold what the
CPU can see of the binding: ``torch.library.opcheck`` of the six ops
(schema, autograd registration, fake against real, AOT dispatch), the fake
functions' shapes and dtypes against the CPU's outputs, the registered
gradients (the bottom-k values' scatter, the attentive backward's plain
version bit for bit against autograd through the plain forward), the
wrappers' refusals through the ops, that tracing counts no launch, and
that nothing outside the ops' CUDA implementations calls the kernel
library.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import pointsecguard_tpu_torch
from pointsecguard_tpu_torch.ops.attentive import (
    attentive_pool_fused_bwd_plain,
    attentive_pool_fused_plain,
)
from pointsecguard_tpu_torch.ops.cuda import (
    attentive,
    bottomk,
    bottomk_chunked,
    fps,
    knn,
    launch_counts,
)
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices

OPS = ("fps", "bottom_k", "bottom_k_chunked", "knn", "attentive_fwd", "attentive_bwd")


def _cases(seed: int = 0) -> dict:
    """Small CPU arguments of each op (float32, as the kernels take)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    D = 5
    return {
        "fps": (t(2, 100, 3), 10, torch.tensor([0, 7], dtype=torch.int32)),
        "bottom_k": (t(2, 5, 64), 4),
        "bottom_k_chunked": (t(2, 300), 8),
        "knn": (t(2, 20, 3), t(2, 40, 3), 5),
        "attentive_fwd": (t(4, 9, D), t(4, 9, D), t(2 * D, 2 * D)),
        "attentive_bwd": (t(16, 9, D), t(16, 9, D), t(2 * D, 2 * D), t(9, D), t(9, D), True),
    }


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    args = _cases()[name]
    before = launch_counts()
    torch.library.opcheck(getattr(torch.ops.psg, name).default, args)
    assert launch_counts() == before


@pytest.mark.parametrize("name", ["bottom_k", "bottom_k_chunked", "attentive_fwd"])
def test_opcheck_with_gradients(name):
    """The ops with a registered gradient, on inputs that require one."""
    args = [a.requires_grad_(True) if isinstance(a, torch.Tensor) and a.is_floating_point()
            else a for a in _cases(1)[name]]
    torch.library.opcheck(getattr(torch.ops.psg, name).default, args)


def test_attentive_bwd_without_dw_opcheck():
    args = list(_cases(2)["attentive_bwd"])
    args[-1] = False
    torch.library.opcheck(torch.ops.psg.attentive_bwd.default, tuple(args))


@pytest.mark.parametrize("name", OPS)
def test_fake_shapes_and_dtypes_match_the_cpu(name):
    args = _cases(3)[name]
    real = getattr(torch.ops.psg, name)(*args)
    real = real if isinstance(real, tuple) else (real,)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = getattr(torch.ops.psg, name)(*fake_args)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(f.shape), f.dtype) for f in fake] == [(tuple(r.shape), r.dtype) for r in real]
    if name in ("fps", "bottom_k", "bottom_k_chunked", "knn"):
        assert real[-1].dtype == torch.int32  # indices


def test_attentive_bwd_gives_dw_only_when_asked():
    fn, fx, w, g1, g2, _ = _cases(4)["attentive_bwd"]
    dfn, dfx, dw = torch.ops.psg.attentive_bwd(fn, fx, w, g1, g2, False)
    assert dw.numel() == 0 and dfn.shape == fn.shape and dfx.shape == fx.shape
    with FakeTensorMode() as mode:
        fake = torch.ops.psg.attentive_bwd(*(mode.from_tensor(a) for a in (fn, fx, w, g1, g2)),
                                           True)
    assert tuple(fake[2].shape) == tuple(w.shape)


@pytest.mark.parametrize("K,M,D,dtype,need_w", [
    (16, 37, 8, torch.float32, True),
    (4, 100, 32, torch.float32, False),
    (16, 513, 5, torch.float64, True),
    (4, 9, 63, torch.float32, True),
    (16, 0, 8, torch.float32, True),
])
def test_attentive_gradient_equals_autograd_of_the_plain_forward(K, M, D, dtype, need_w):
    """``psg::attentive_bwd`` on the CPU (``attentive_pool_fused_bwd_plain``)
    gives, bit for bit, what autograd takes through the plain forward, as
    the CPU's gradients did before the binding; ``w`` enters transposed,
    as RandLA's pooling passes its Dense weight."""
    rng = np.random.default_rng(K * M + D)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    fn, fx, weight = t(K, M, D), t(K, M, D), t(2 * D, 2 * D) / np.sqrt(2 * D)
    g1, g2 = t(M, D), t(M, D)
    grads = []
    for pool in (attentive.attentive_pool_fused, attentive_pool_fused_plain):
        leaves = [fn.clone().requires_grad_(), fx.clone().requires_grad_(),
                  weight.clone().requires_grad_(need_w)]
        out = pool(leaves[0], leaves[1], leaves[2].t())
        grads.append(torch.autograd.grad(out, [x for x in leaves if x.requires_grad],
                                         (g1, g2)))
    assert len(grads[0]) == (3 if need_w else 2)
    for got, want in zip(*grads):
        assert got.dtype == dtype and torch.equal(got, want)
    direct = attentive_pool_fused_bwd_plain(fn, fx, weight.t(), g1, g2, need_w)
    assert torch.equal(direct[0], grads[1][0]) and torch.equal(direct[1], grads[1][1])
    assert (direct[2] is None) == (not need_w)


def test_bottom_k_value_gradient_through_the_ops():
    """Both kernels' ops carry the values' cotangent back to the selected
    entries (the k > 48 route is the stable sort's own gradient:
    tests/test_torch_selection_grad.py)."""
    rng = np.random.default_rng(5)
    for width, op in ((64, torch.ops.psg.bottom_k), (9000, torch.ops.psg.bottom_k_chunked)):
        vals = torch.from_numpy(rng.standard_normal((3, width)).astype(np.float32))
        vals.requires_grad_(True)
        v, i = op(vals, 6)
        assert not i.requires_grad
        cot = torch.from_numpy(rng.standard_normal((3, 6)).astype(np.float32))
        (grad,) = torch.autograd.grad((v * cot).sum(), vals)
        want = torch.zeros_like(vals).scatter_(-1, i.long(), cot)
        assert torch.equal(grad, want)
    v, _ = bottom_k_indices(torch.zeros(2, 9000, requires_grad=True), 3)
    assert v.requires_grad


def test_fps_and_knn_carry_no_gradient():
    """As JAX's ``stop_gradient`` in ``fps_pallas`` / ``knn_pallas``."""
    xyz = torch.rand(2, 50, 3, requires_grad=True)
    assert not fps.fps(xyz, 8, torch.zeros(2, dtype=torch.int32)).requires_grad
    d, i = knn.knn(xyz, xyz, 4)
    assert not d.requires_grad and not i.requires_grad


def test_knn_self_query_equals_a_distinct_copy():
    """``query`` and ``points`` the same tensor (the pyramid's self-search,
    which the CUDA implementation packs once) or an equal copy: one
    result."""
    pts = torch.from_numpy(np.random.default_rng(6).random((2, 64, 3)).astype(np.float32))
    same = knn.knn(pts, pts, 8)
    copy = knn.knn(pts.clone(), pts, 8)
    assert all(torch.equal(a, b) for a, b in zip(same, copy))


@pytest.mark.parametrize("call,match", [
    (lambda: fps.fps(torch.zeros(1, (1 << 22) + 1, 3), 4, torch.zeros(1, dtype=torch.int32)),
     "N=4194305 outside"),
    (lambda: fps.fps(torch.zeros(2, 16, 3, dtype=torch.float64), 4,
                     torch.zeros(2, dtype=torch.int32)), "want float32"),
    (lambda: knn.knn(torch.zeros(2, 8, 3), torch.zeros(2, 16, 3), 17), "k=17 outside"),
    (lambda: knn.knn(torch.zeros(2, 8, 3), torch.zeros(3, 16, 3), 4), "want query"),
    (lambda: bottomk.check_kernel_args(torch.zeros(2, 8193), 4), "N=8193 outside"),
    (lambda: bottomk_chunked.check_kernel_args(torch.zeros(2, 100), 49), "k=49 outside"),
    (lambda: bottomk_chunked.check_kernel_args(torch.zeros(2, 100, dtype=torch.float64), 4),
     "want float32"),
    (lambda: knn.check_kernel_args(torch.zeros(2, 8, 4097), torch.zeros(2, 16, 4097), 4),
     "D=4097 above"),
    (lambda: knn.check_kernel_args(torch.zeros(2, 8, 3, dtype=torch.float64),
                                   torch.zeros(2, 16, 3, dtype=torch.float64), 4),
     "want float32"),
    (lambda: attentive.attentive_pool_fused(torch.zeros(4, 8, 5), torch.zeros(4, 8, 5),
                                            torch.zeros(9, 9)), "want fn, fx"),
    (lambda: attentive.check_kernel_args(torch.zeros(8, 4, 5), torch.zeros(8, 4, 5),
                                         torch.zeros(10, 10)), "K=8"),
], ids=["fps N", "fps dtype", "knn k", "knn shapes", "bottom_k N", "chunked k",
        "chunked dtype", "knn D", "knn dtype", "attentive shapes", "attentive K"])
def test_wrappers_still_refuse(call, match):
    """What ``tests/test_torch_kernel_contracts.py`` holds the wrappers to,
    now in front of the ops (the CUDA implementations call the same
    checks), and no launch is counted."""
    before = launch_counts()
    with pytest.raises(ValueError, match=match):
        call()
    assert launch_counts() == before


def test_tracing_counts_no_launch():
    """A fake trace through every op (as ``torch.export`` makes) launches
    nothing and counts nothing."""
    before = launch_counts()
    with FakeTensorMode() as mode:
        for name, args in _cases(7).items():
            getattr(torch.ops.psg, name)(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                                           else a for a in args))
    assert launch_counts() == before


def test_cpu_calls_count_no_launch():
    before = launch_counts()
    for name, args in _cases(8).items():
        getattr(torch.ops.psg, name)(*args)
    assert launch_counts() == before


def test_only_the_ops_call_the_kernel_library():
    """No module of the port outside the ops' CUDA implementations
    (``ops/cuda/library.py``) calls ``lib.psg_*``; the library's entry
    points are the six ops' (plus the attentive backward's dW sizing and
    FPS's route and workspace sizing)."""
    pkg = Path(pointsecguard_tpu_torch.__file__).resolve().parent
    callers = {p.relative_to(pkg).as_posix()
               for p in pkg.rglob("*.py")
               if re.search(r"\blib\.psg_\w+\(|getattr\(lib, \w+\)\(", p.read_text())}
    assert callers == {"ops/cuda/library.py"}
    src = (pkg / "ops" / "cuda" / "library.py").read_text()
    ops = set(re.findall(r'custom_op\("psg::(\w+)"', src))
    assert ops == set(OPS)
    entries = set(re.findall(r"\blib\.(psg_\w+)", src)) | set(re.findall(r'"(psg_\w+)"', src))
    assert entries == {"psg_fps", "psg_bottom_k", "psg_bottom_k_chunked", "psg_knn",
                       "psg_attentive_fwd", "psg_attentive_bwd", "psg_attentive_dw_blocks",
                       "psg_fps_route", "psg_fps_workspace_floats"}
