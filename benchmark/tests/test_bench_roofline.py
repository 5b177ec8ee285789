"""benchmark/roofline.py against figures worked out by hand."""

import pytest

from benchmark.roofline import DenseWork, ModelWork, peak_key


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


@pytest.mark.parametrize("work,us", [
    # 127 texts of 32 tokens through the port's preset: operations bound
    (ModelWork(1.08e11, 5.3e7, "bf16"), 109.201213),
    # a light call: bytes bound (60 MB at 3.35 TB/s)
    (ModelWork(1e9, 6e7, "bf16"), 17.910448),
    # the same products in f32 (67 TFLOP/s) and in fp8 (1,979)
    (ModelWork(1.08e11, 5.3e7, "float32"), 1611.940299),
    (ModelWork(1.08e11, 5.3e7, "fp8"), 54.573017),
])
def test_a_models_least_time(work, us):
    assert work.least_s() * 1e6 == pytest.approx(us, rel=1e-6)


@pytest.mark.parametrize("torch_type,key,peak", [
    ("torch.bfloat16", "bf16", 989e12), ("torch.float16", "bf16", 989e12),
    ("torch.float32", "float32", 67e12), ("torch.float8_e4m3fn", "fp8", 1979e12),
])
def test_a_models_peak_is_its_configurations_type(torch_type, key, peak):
    work = ModelWork(2e12, 1.0, peak_key(torch_type))
    assert work.dtype == key and work.peak_s() == pytest.approx(2e12 / peak, rel=1e-12)
