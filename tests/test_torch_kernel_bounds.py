"""`ops/cuda/bounds.py` against hand-worked byte and operation counts.

The bounds module is pure Python: bytes each call must move (inputs read
once, outputs written once) and its operations, from the shapes alone,
and the least time an H100 could take from the two published peaks
(3.35 TB/s, 67 TFLOP/s in float32). The expected values below were
worked out by hand from the slice shapes that `chip_smoke.py` times.
"""

import pytest

from pointsecguard_tpu_torch.ops.cuda import bounds

# one build_geometry of [8, 4096]: (rows, N, k) of its 8 bottom-k calls
GEOMETRY = [(8 * 1024, 4096, 32), (8 * 256, 1024, 32), (8 * 64, 256, 32), (8 * 16, 64, 32),
            (8 * 4096, 1024, 3), (8 * 1024, 256, 3), (8 * 256, 64, 3), (8 * 64, 16, 3)]
# the fused attentive poolings of one RandLA pass of [4, 40960]
PASS = [(16, 163840, 8), (16, 163840, 8), (16, 40960, 32), (16, 40960, 32)]


@pytest.mark.parametrize("call,bytes_in,bytes_out,operations", [
    # ball query at the first level: 8·1024 rows of 4096 floats, k = 32
    (lambda: bounds.bottom_k(8 * 1024, 4096, 32), 134_217_728, 2_097_152, 33_554_432),
    # 3-NN of the last feature-propagation level: 8·4096 rows of 1024
    (lambda: bounds.bottom_k(8 * 4096, 1024, 3), 134_217_728, 786_432, 33_554_432),
    # the C&W smooth term: colour distances [8, 4096, 4096], k = 10 and 5
    (lambda: bounds.bottom_k(8 * 4096, 4096, 10), 536_870_912, 2_621_440, 134_217_728),
    (lambda: bounds.bottom_k(8 * 4096, 4096, 5), 536_870_912, 1_310_720, 134_217_728),
    # one tile of the tiled kNN route: [4, 4096, 40960], k = 16
    (lambda: bounds.bottom_k_chunked(4 * 4096, 40960, 16), 2_684_354_560, 2_097_152,
     671_088_640),
    # FPS 4096 -> 1024 on 8 clouds: 10 operations per point and step
    (lambda: bounds.fps(8, 4096, 1024), 393_248, 32_768, 335_544_320),
    # the 40960² level of the pyramid: 9 flop a pair at D = 3
    (lambda: bounds.knn(4, 40960, 40960, 3, 16), 5_242_880, 20_971_520, 60_397_977_600),
    (lambda: bounds.knn(4, 40960, 10240, 3, 1), 3_276_800, 1_310_720, 15_099_494_400),
    # attentive forward: fn, fx and w in, two [M, D] out
    (lambda: bounds.attentive_fwd(16, 163840, 8), 167_773_184, 10_485_760, 1_635_778_560),
    (lambda: bounds.attentive_fwd(16, 40960, 32), 167_788_544, 10_485_760, 5_662_310_400),
    # attentive backward without dW: also g1, g2 in; dfn, dfx out
    (lambda: bounds.attentive_bwd(16, 163840, 8), 178_258_944, 167_772_160, 3_313_500_160),
    (lambda: bounds.attentive_bwd(16, 40960, 32), 178_274_304, 167_772_160, 11_366_563_840),
    # with dW: a third product and the [2D, 2D] output
    (lambda: bounds.attentive_bwd(16, 40960, 32, dw=True), 178_274_304, 167_788_544,
     16_735_272_960),
])
def test_work_of_one_call(call, bytes_in, bytes_out, operations):
    work = call()
    assert (work.bytes_in, work.bytes_out, work.operations) == (bytes_in, bytes_out, operations)
    assert work.bytes == bytes_in + bytes_out


@pytest.mark.parametrize("name,work,total_bytes,bound_ms,bound_by", [
    # 286,326,784 bytes of inputs + 3,829,760 of outputs, over 3.35 TB/s
    ("bottom_k per build_geometry",
     lambda: bounds.total(bounds.bottom_k(*c) for c in GEOMETRY),
     290_156_544, 0.08661389373134329, "bytes"),
    ("bottom_k per C&W step", lambda: bounds.bottom_k(8 * 4096, 4096, 10),
     539_492_352, 0.16104249313432836, "bytes"),
    ("bottom_k_chunked", lambda: bounds.bottom_k_chunked(4 * 4096, 40960, 16),
     2_686_451_712, 0.8019258841791045, "bytes"),
    # 671 MB in + 42 MB out is 0.2129 ms; 14.6 Gflop over 67 TFLOP/s is more
    ("attentive_fwd per RandLA pass",
     lambda: bounds.total(bounds.attentive_fwd(*c) for c in PASS),
     713_066_496, 0.2178534017910448, "operations"),
    ("attentive_bwd per RandLA pass",
     lambda: bounds.total(bounds.attentive_bwd(*c) for c in PASS),
     1_384_155_136, 0.4382108656716418, "operations"),
    ("attentive_fwd at D = 8", lambda: bounds.attentive_fwd(16, 163840, 8),
     178_258_944, 0.05321162507462687, "bytes"),
    ("knn at 40960²", lambda: bounds.knn(4, 40960, 40960, 3, 16),
     26_214_400, 0.9014623522388059, "operations"),
    ("fps 4096 -> 1024", lambda: bounds.fps(8, 4096, 1024),
     426_016, 0.005008124179104478, "operations"),
])
def test_bound_of_a_batch(name, work, total_bytes, bound_ms, bound_by):
    w = work()
    assert w.bytes == total_bytes, name
    assert w.bound_ms == pytest.approx(bound_ms, rel=1e-12), name
    assert w.bound_by == bound_by, name
    assert w.bound_ms == max(w.bytes_ms, w.operations_ms)


def test_peaks_are_the_published_ones_and_work_adds():
    assert bounds.PEAK_BYTES_PER_S == 3.35e12 and bounds.PEAK_FLOAT32_PER_S == 67e12
    a, b = bounds.bottom_k(4, 8, 2), bounds.fps(1, 8, 4)
    assert (a + b).bytes == a.bytes + b.bytes
    assert (a + b).operations == a.operations + b.operations
    assert bounds.total([]) == bounds.Work()


def test_bounds_module_needs_no_torch():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(bounds))
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module.split(".")[0]
             for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))}
    assert names <= {"__future__", "dataclasses"}
