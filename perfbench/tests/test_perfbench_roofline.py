"""The frozen roofline copy and the kernel table against the port: the
same bytes, operations and bound as ``ops/cuda/bounds.py`` at the shapes
the benchmark's cells launch, and a name in the table for every kernel of
the port's ``csrc/``."""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from perfbench.core import kernels, roofline
from pointsecguard_tpu_torch.ops.cuda import bounds

# (op, input shapes, scalar arguments) as the profiler records the calls
# of the cells: SSG's geometry of 32 blocks, ResGCN's graphs of 8, and the
# other ops at the port's RandLA shapes
CALLS = [
    ("psg::fps", [[32, 4096, 3], [], [32]], [None, 1024, None]),
    ("psg::fps", [[32, 16, 3], [], [32]], [None, 16, None]),
    ("psg::bottom_k", [[32, 1024, 4096], []], [None, 32]),
    ("psg::bottom_k", [[32, 4096, 1024], []], [None, 3]),
    ("psg::bottom_k_chunked", [[4, 4096, 40960], []], [None, 16]),
    ("psg::knn", [[8, 4096, 3], [8, 4096, 3], []], [None, None, 16]),
    ("psg::knn", [[8, 4096, 64], [8, 4096, 64], []], [None, None, 48]),
    ("psg::attentive_fwd", [[16, 40960, 32], [16, 40960, 32], [64, 64]], [None] * 3),
    ("psg::attentive_bwd", [[16, 40960, 32]] * 2 + [[64, 64]] + [[40960, 32]] * 2 + [[]],
     [None] * 5 + [True]),
]
PORT = {
    "psg::fps": lambda s, a: bounds.fps(s[0][0], s[0][1], a[1]),
    "psg::bottom_k": lambda s, a: bounds.bottom_k(s[0][0] * s[0][1], s[0][2], a[1]),
    "psg::bottom_k_chunked": lambda s, a: bounds.bottom_k_chunked(s[0][0] * s[0][1], s[0][2], a[1]),
    "psg::knn": lambda s, a: bounds.knn(s[0][0], s[0][1], s[1][1], s[0][2], a[2]),
    "psg::attentive_fwd": lambda s, a: bounds.attentive_fwd(*s[0]),
    "psg::attentive_bwd": lambda s, a: bounds.attentive_bwd(*s[0], dw=a[5]),
}


@pytest.mark.parametrize("op,shapes,args", CALLS)
def test_table_matches_the_port(op, shapes, args):
    ours, port = kernels.work(op, shapes, args), PORT[op](shapes, args)
    assert (ours.bytes_in, ours.bytes_out, ours.operations) == \
        (port.bytes_in, port.bytes_out, port.operations)
    assert ours.bound_ms == port.bound_ms and ours.bound_by == port.bound_by


def test_peaks_match_the_port():
    assert (roofline.PEAK_BYTES_PER_S, roofline.PEAK_FLOAT32_PER_S) == \
        (bounds.PEAK_BYTES_PER_S, bounds.PEAK_FLOAT32_PER_S)


def test_uncosted_call():
    assert kernels.work("psg::knn", [[8, 4096, 3], [8, 4096, 3], []], []) is None
    assert kernels.work("aten::sort", [[8, 8]], [None]) is None


def test_every_kernel_of_the_port_is_named():
    import pointsecguard_tpu_torch

    csrc = Path(pointsecguard_tpu_torch.__file__).parent / "csrc"
    found = set()
    for src in csrc.glob("*.cu"):
        found |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                src.read_text()))
    assert found == set(kernels.PORT_KERNELS)


@pytest.mark.parametrize("name,port", [
    ("void knn_tiled_kernel<16, 4>(float const*, float const*, float*, int*)", True),
    ("_Z10fps_kernelPK6float4PKiPiiii", True),
    ("void fps_cluster_kernel<8>(float const*)", True),
    ("void at::native::batch_norms_kernel(float*)", False),
    ("void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<...>", False),
])
def test_kernel_names(name, port):
    assert kernels.is_port_kernel(name) is port
    assert kernels.is_select_kernel(name) is ("Sort" in name)
