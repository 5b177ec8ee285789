"""The hand-written CUDA kernels against their plain PyTorch versions.

These need the card: the kernels are CUDA C++ for sm_90a and have no
interpret mode.  They skip on a machine without CUDA; run them on the
H100 with ``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``
(the repository conftest imports jax, which that machine does not have).
K1 values agree with plain within 1e-4 (f32 FMAs in another order) with
identical rows wherever values are not tied; K2 is bitwise equal.  K4 is
bitwise equal on int8 stores (exact int32 sums), within 1e-5 relative /
1e-4 absolute on f32 and within 1e-4 absolute on bf16 unit rows (f32 sums
in another order)."""

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


# ---- K4: IVF probe span scores, and K2 on the IVF arrays ----------------

K4_CASES = [
    (127 * 8, 20_000, 1024, 300),     # the probe's shape, W not a multiple of 32
    (1, 500, 64, 100),                # G = 1
    (33, 1000, 1000, 77),             # D = 1000: int8 rows take the element path
    (7, 64, 48, 130),                 # spans longer than the store: clamped
]


def _k4_inputs(G, N, D, dtype, g):
    base = torch.randn(N, D, generator=g)
    base = base / base.norm(dim=1, keepdim=True)
    qf = torch.randn(G, D, generator=g)
    qf = qf / qf.norm(dim=1, keepdim=True)
    if dtype == torch.int8:
        return (torch.randint(-127, 128, (N, D), generator=g, dtype=torch.int8),
                torch.randint(-127, 128, (G, D), generator=g, dtype=torch.int8))
    return base.to(dtype), qf.to(dtype)


def _k4_check(got, ref, dtype):
    assert got.dtype == torch.float32 and got.shape == ref.shape
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    elif dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("G,N,D,W", K4_CASES)
def test_k4_matches_plain(dev, dtype, G, N, D, W):
    from rag_challenge_2_tpu_torch.ops.probe_scores import (
        probe_span_scores, probe_span_scores_plain)

    g = torch.Generator(device="cpu").manual_seed(G + N + D)
    emb, q = _k4_inputs(G, N, D, dtype, g)
    # unaligned starts, some before row 0 and some running past the end
    starts = torch.randint(-5, N + 5, (G,), generator=g, dtype=torch.int32)
    emb, q, starts = emb.to(dev), q.to(dev), starts.to(dev)
    before = probe_span_scores.launches
    got = probe_span_scores(emb, q, starts, window=W)
    ref = probe_span_scores_plain(emb, q, starts, window=W)
    torch.cuda.synchronize()
    assert probe_span_scores.launches == before + 1
    _k4_check(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k4_unaligned_store_view(dev, dtype):
    """A store whose rows do not start on 16 bytes takes the element path."""
    from rag_challenge_2_tpu_torch.ops.probe_scores import (
        probe_span_scores, probe_span_scores_plain)

    g = torch.Generator(device="cpu").manual_seed(5)
    N, D, G = 600, 64, 12
    emb, q = _k4_inputs(G, N + 1, D, dtype, g)
    flat = emb.reshape(-1).to(dev)
    view = flat[1:1 + N * D].view(N, D)
    starts = torch.randint(0, N, (G,), generator=g, dtype=torch.int32).to(dev)
    got = probe_span_scores(view, q.to(dev), starts, window=50)
    ref = probe_span_scores_plain(view, q.to(dev), starts, window=50)
    torch.cuda.synchronize()
    _k4_check(got, ref, dtype)


def test_k4_rejects_what_it_does_not_take(dev):
    from rag_challenge_2_tpu_torch.ops.probe_scores import probe_span_scores

    emb = torch.zeros(10, 8, device=dev)
    st = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        probe_span_scores(emb, torch.zeros(2, 8, device=dev, dtype=torch.bfloat16),
                          st, window=4)
    with pytest.raises(ValueError):
        probe_span_scores(emb.half(), torch.zeros(2, 8, device=dev).half(), st,
                          window=4)
    with pytest.raises(ValueError):
        probe_span_scores(emb, torch.zeros(2, 8, device=dev), st.long(), window=4)
    with pytest.raises(ValueError):
        probe_span_scores(torch.zeros(10, 20000, device=dev),
                          torch.zeros(2, 20000, device=dev), st, window=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["mask", "win_start", "pair_doc"])
def test_ivf_search_on_the_card_equals_cpu(dev, dtype, mode):
    """The whole probe search (K4 + K2 + masks + top-k) on the card against
    the same IVFIndex on the CPU (plain versions).  K2 copies the IVF's
    row ids, doc ids and int8 row scales bitwise."""
    import dataclasses

    from rag_challenge_2_tpu_torch.index.ivf import (
        build_ivf, cluster_order_index, ivf_search, quantize_ivf)
    from rag_challenge_2_tpu_torch.index.schema import CorpusIndex
    from rag_challenge_2_tpu_torch.ops.span_gather import (
        gather_posting_spans, gather_posting_spans_plain)

    g = torch.Generator(device="cpu").manual_seed(3)
    N, D, B = 4096, 128, 6
    cent = torch.randn(16, D, generator=g)
    x = cent[torch.randint(0, 16, (N,), generator=g)] + 0.3 * torch.randn(N, D, generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    ivf = build_ivf(x, n_clusters=32, iters=5, max_list_size=256)
    if dtype == torch.bfloat16:
        ivf = dataclasses.replace(ivf, emb_perm=ivf.emb_perm.to(dtype))
    elif dtype == torch.int8:
        ivf = quantize_ivf(ivf)
    kw = {}
    if mode == "pair_doc":
        doc = (torch.arange(N) // 1024).to(torch.int32)
        idx = CorpusIndex(emb=x, doc_id=doc, page=doc, year=doc, company_id=doc,
                          kind=doc, page_seg=doc, chunk_in_doc=doc,
                          valid=torch.ones(N, dtype=torch.bool), sparse=None,
                          n_chunks=N, n_pages=N, n_docs=4, dim=D)
        idx, _, ivf = cluster_order_index(idx, None, ivf)
        kw = dict(pair_doc=torch.tensor([0, 1, 2, 3, 1, -1], dtype=torch.int32),
                  pos_doc=idx.doc_id)
    elif mode == "win_start":
        kw = dict(win_start=torch.tensor([0, 1024, 2048, 3072, 0, 0], dtype=torch.int32),
                  win_len=torch.tensor([1024] * 5 + [0], dtype=torch.int32))
    else:
        m = torch.zeros(B, N, dtype=torch.bool)
        for b in range(5):
            m[b, b * 700:(b + 1) * 700] = True
        kw = dict(mask=m)
    q = x[:B].clone()
    vc, rc = ivf_search(ivf, q, 30, nprobe=8, **kw)
    gpu = ivf.to(dev)
    before = gather_posting_spans.launches
    vg, rg = ivf_search(gpu, q.to(dev), 30, nprobe=8,
                        **{k: v.to(dev) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert gather_posting_spans.launches == before + 1
    _untied_rows_equal(vg.cpu(), rg.cpu(), vc, rc)
    starts = gpu.list_offsets[:-1].contiguous()
    arr = gpu.row_scale if gpu.row_scale is not None else gpu.zero_scales(gpu.row_ids.shape[0])
    got = gather_posting_spans(gpu.row_ids, arr, starts, window=gpu.max_list)
    ref = gather_posting_spans_plain(gpu.row_ids, arr, starts, window=gpu.max_list)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
