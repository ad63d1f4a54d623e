"""The benchmark's table of kernel names.

``WORK`` maps each of the port's custom ops (``psg::*``, as the profiler
names them) to its bytes and operations at the call's shapes, through the
frozen ``roofline`` copy; ``PORT_KERNELS`` lists the device kernels those
ops launch (the ``__global__`` functions of the port's ``csrc/*.cu``), whose
device time the roofline share divides; ``SELECT_KERNELS`` are the name
fragments of the library's sort and top-k kernels, the large-k graph
selections.
"""

from __future__ import annotations

import math
import re

from perfbench.core import roofline


def _rows(shape) -> int:
    return math.prod(shape[:-1])


def _fps(shapes, args):
    b, n, _ = shapes[0]
    return roofline.fps(b, n, args[1])


def _bottom_k(shapes, args):
    return roofline.bottom_k(_rows(shapes[0]), shapes[0][-1], args[1])


def _knn(shapes, args):
    b, s, d = shapes[0]
    return roofline.knn(b, s, shapes[1][1], d, args[2])


def _attentive_fwd(shapes, args):
    return roofline.attentive_fwd(*shapes[0])


def _attentive_bwd(shapes, args):
    return roofline.attentive_bwd(*shapes[0], dw=bool(args[5]))


# op → Work from (input shapes, scalar arguments), as the profiler records them
WORK = {
    "psg::fps": _fps,
    "psg::bottom_k": _bottom_k,
    "psg::bottom_k_chunked": _bottom_k,
    "psg::knn": _knn,
    "psg::attentive_fwd": _attentive_fwd,
    "psg::attentive_bwd": _attentive_bwd,
}

PORT_KERNELS = (
    "fps_kernel", "fps_cluster_kernel", "fps_stream_kernel",
    "bottom_k_warp_kernel", "bottom_k_sort_kernel", "bottom_k_chunked_kernel",
    "norms_kernel", "pack_xyz_kernel", "knn_xyz_kernel", "knn_tiled_kernel",
    "attentive_fwd_kernel", "attentive_bwd_kernel", "dw_reduce_kernel",
)

SELECT_KERNELS = ("sort", "topk", "radix")


def is_port_kernel(name: str) -> bool:
    """A device kernel of the port's ``csrc/`` (its name, demangled or
    mangled, holds one of ``PORT_KERNELS`` after a space, a digit or its
    start)."""
    return any(re.search(rf"(?<![A-Za-z_]){k}", name) for k in PORT_KERNELS)


def is_select_kernel(name: str) -> bool:
    low = name.lower()
    return not is_port_kernel(name) and any(s in low for s in SELECT_KERNELS)


def work(op: str, shapes, args) -> roofline.Work | None:
    """The call's Work, or None for an op outside the table or a call
    whose scalar arguments the profiler did not record."""
    fn = WORK.get(op)
    if fn is None:
        return None
    try:
        return fn([tuple(s) for s in shapes], list(args))
    except (TypeError, IndexError, ValueError):
        return None
