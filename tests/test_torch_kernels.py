"""The hand-written CUDA kernels against their plain PyTorch versions.

These need the card: the kernels are CUDA C++ for sm_90a and have no
interpret mode.  They skip on a machine without CUDA; run them on the
H100 with ``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``
(the repository conftest imports jax, which that machine does not have).
K1 values agree with plain within 1e-4 (f32 FMAs in another order) with
identical rows wherever values are not tied; K2 is bitwise equal."""

import pytest
import torch

from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused, dense_topk_plain
from rag_challenge_2_tpu_torch.ops.span_gather import (
    gather_posting_spans, gather_posting_spans_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _untied_rows_equal(kv, ki, pv, pi, tol=1e-4):
    torch.testing.assert_close(kv, pv, rtol=0, atol=tol)
    step = (pv[:, 1:] - pv[:, :-1]).abs()
    inf = torch.full_like(pv[:, :1], float("inf"))
    gap = torch.minimum(torch.cat([inf, step], 1), torch.cat([step, inf], 1))
    untied = gap > 2 * tol
    assert torch.equal(ki[untied], pi[untied])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D,k", [
    (8, 10240, 1024, 30), (3, 1000, 64, 7), (8, 300, 20, 5), (1, 5, 32, 20),
    (9, 70 * 256 + 3, 32, 64),        # two merge levels, two query groups
    (2, 1_100_000, 16, 10),           # three merge levels
])
def test_k1_matches_plain(dev, dtype, B, N, D, k):
    g = torch.Generator(device="cpu").manual_seed(N + D)
    q = torch.randn(B, D, generator=g).to(dev)
    emb = torch.randn(N, D, generator=g).to(dev, dtype)
    mask = (torch.rand(N, generator=g) > 0.3).to(dev)
    kv, ki = dense_topk_fused(q, emb, k, mask)
    pv, pi = dense_topk_plain(q, emb, k, mask)
    torch.cuda.synchronize()
    assert kv.shape == (B, min(k, N))
    _untied_rows_equal(kv, ki, pv, pi)


def test_k1_ties_all_masked_and_launch_count(dev):
    g = torch.Generator(device="cpu").manual_seed(1)
    base = torch.randn(100, 48, generator=g)
    emb = torch.cat([base, base, base]).to(dev)           # every row 3x
    q = torch.randn(4, 48, generator=g).to(dev)
    before = dense_topk_fused.launches
    kv, ki = dense_topk_fused(q, emb, 9)
    pv, pi = dense_topk_plain(q, emb, 9)
    assert torch.equal(ki, pi) and dense_topk_fused.launches == before + 1
    mask = torch.zeros(300, dtype=torch.bool, device=dev)
    kv, ki = dense_topk_fused(q, emb, 9, mask)
    assert (kv == -3.0e38).all()
    assert torch.equal(ki, torch.arange(9, device=dev, dtype=torch.int32).expand(4, 9))


def test_k1_rejects_what_it_does_not_take(dev):
    q = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError):
        dense_topk_fused(q, torch.zeros(4, 8, device=dev, dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        dense_topk_fused(q, torch.zeros(4, 8, device=dev), 65)
    with pytest.raises(ValueError):
        dense_topk_fused(q.double(), torch.zeros(4, 8, device=dev), 2)


@pytest.mark.parametrize("with_dl", [False, True])
@pytest.mark.parametrize("window", [1, 7, 512])
def test_k2_bitwise_equals_plain(dev, with_dl, window):
    g = torch.Generator(device="cpu").manual_seed(window)
    n = 5003
    ids = torch.randint(0, 10**6, (n,), generator=g, dtype=torch.int32).to(dev)
    tf = torch.rand(n, generator=g).to(dev)
    dl = torch.rand(n, generator=g).to(dev) if with_dl else None
    starts = torch.randint(-3, n + 5, (333,), generator=g, dtype=torch.int32).to(dev)
    before = gather_posting_spans.launches
    out = gather_posting_spans(ids, tf, starts, window=window, dl=dl)
    ref = gather_posting_spans_plain(ids, tf, starts, window=window, dl=dl)
    torch.cuda.synchronize()
    assert gather_posting_spans.launches == before + 1
    assert len(out) == len(ref) == (3 if with_dl else 2)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # an unaligned view of the arrays takes the same path
    out = gather_posting_spans(ids[1:], tf[1:], starts.clamp(min=0) % (n - 1),
                               window=window)
    ref = gather_posting_spans_plain(ids[1:], tf[1:],
                                     starts.clamp(min=0) % (n - 1), window=window)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
