"""benchmark/roofline.py against figures worked out by hand."""

import pytest

from benchmark.roofline import DenseWork


@pytest.mark.parametrize("work,ms,bound", [
    # 10M int8 rows with f32 scales, 127 queries: 10.2806 GB over 3.35 TB/s
    (DenseWork("int8", 127, 10_000_000, 1024, 30), 3.068821, "bytes"),
    # 1.5M bf16 rows: 3.0726 GB; 0.394 ms of products at 989 TFLOP/s
    (DenseWork("bf16", 127, 1_500_000, 1024, 30), 0.917179, "bytes"),
    # 1M f32 rows, f32 products on the CUDA cores: 2.6e14 / 67e12
    (DenseWork("float32", 127, 1_000_000, 1024, 30), 3.882030, "operations"),
    # a served int8 dispatch: 16 x 8 queries over 3 slots of 1,666,666 rows
    (DenseWork("int8", 128, 4_999_998, 1024, 30, 3), 1.534512, "bytes"),
])
def test_least_time(work, ms, bound):
    assert work.least_s() * 1e3 == pytest.approx(ms, rel=1e-6)
    assert work.bound() == bound


def test_bytes_and_operations_from_shapes():
    w = DenseWork("int8", 2, 10, 4, 3, 2)
    assert w.bytes == 10 * (4 + 4) + 2 * 4 * 4 + 2 * 2 * 3 * 8
    assert w.ops == 2 * 2 * 10 * 4
