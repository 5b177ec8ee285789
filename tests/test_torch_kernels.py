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
    (9, 70 * 256 + 3, 32, 64),        # the 16-query tile, k = 64
    (2, 1_100_000, 16, 10),           # many tiles per block
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


def _k2_equal(arrays, starts, window):
    dl = arrays[2] if len(arrays) > 2 else None
    before = gather_posting_spans.launches
    out = gather_posting_spans(arrays[0], arrays[1], starts, window=window, dl=dl)
    ref = gather_posting_spans_plain(arrays[0], arrays[1], starts, window=window, dl=dl)
    torch.cuda.synchronize()
    assert gather_posting_spans.launches == before + 1
    assert len(out) == len(arrays)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("n_arrays", [2, 3])
@pytest.mark.parametrize("window", [1, 3, 4, 5, 512, 577, 4096, 10_000])
def test_k2_every_start_residue_view_and_grid(dev, window, n_arrays):
    """Every start residue mod 4, arrays viewed at +0 / +1 / +3 words (the
    bulk copies' 16-byte extension moves with the address), G that is not
    a multiple of the persistent grid, windows off the 16-byte grid and
    longer than one piece (4096 and 10,000 words are 2 and 5 pieces)."""
    g = torch.Generator(device="cpu").manual_seed(window * 10 + n_arrays)
    n = 60_001
    ids = torch.randint(0, 1 << 30, (n,), generator=g, dtype=torch.int32).to(dev)
    tf = torch.rand(n, generator=g).to(dev)
    dl = torch.rand(n, generator=g).to(dev)
    inner = torch.randint(0, n - window - 4, (1016,), generator=g)
    for r in range(4):
        starts = (inner - inner % 4 + r).to(torch.int32).to(dev)
        for view in (0, 1, 3):
            arrays = [ids[view:], tf[view:], dl[view:]][:n_arrays]
            for G in (1, 529, 1016):
                _k2_equal(arrays, starts[:G].contiguous(), window)


@pytest.mark.parametrize("window", [1, 5, 512, 4096])
def test_k2_spans_crossing_both_ends_take_the_word_path(dev, window):
    """Starts before 0 and spans past the end clamp like the reference's
    XLA path, on a CSR with no slack at all."""
    g = torch.Generator(device="cpu").manual_seed(window)
    n = 9_000
    ids = torch.randint(0, 1 << 30, (n,), generator=g, dtype=torch.int32).to(dev)
    tf = torch.rand(n, generator=g).to(dev)
    dl = torch.rand(n, generator=g).to(dev)
    starts = torch.tensor([-window - 5, -window, -3, -1, 0, 1, 2, n - window - 1, n - window,
                           n - 3, n - 1, n, n + 7, -(2 ** 31), 2 ** 31 - 1],
                          dtype=torch.int32, device=dev)
    _k2_equal([ids, tf, dl], starts, window)
    _k2_equal([ids[1:], tf[1:]], starts, window)


@pytest.mark.parametrize("window", [577, 600, 622])
def test_k2_ivf_arrays_on_the_list_grid(dev, window):
    """The IVF arm's call: row ids and scales, G = 127 x 8 starts on the
    32-row list grid, W = max_list (not a multiple of 4 in general)."""
    g = torch.Generator(device="cpu").manual_seed(window)
    n = 200_000 + 32 + window + 1024
    rid = torch.randint(-1, 10**6, (n,), generator=g, dtype=torch.int32).to(dev)
    scale = torch.rand(n, generator=g).to(dev)
    starts = (torch.randint(0, 200_000 // 32, (1016,), generator=g) * 32).to(torch.int32)
    _k2_equal([rid, scale], starts.to(dev), window)


def test_k2_is_one_device_kernel_and_mirrors_its_planner(dev):
    from torch.profiler import ProfilerActivity, profile

    from rag_challenge_2_tpu_torch.ops import span_gather

    assert span_gather.kernel_constants() == span_gather.SPAN_CONSTANTS
    n, W = 100_000, 4096
    ids = torch.zeros(n, dtype=torch.int32, device=dev)
    tf = torch.zeros(n, device=dev)
    starts = torch.arange(0, 512 * 64, 64, dtype=torch.int32, device=dev)
    gather_posting_spans(ids, tf, starts, window=W, dl=tf)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gather_posting_spans(ids, tf, starts, window=W, dl=tf)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()
             if getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)]
    assert len(names) == 1 and "gather_spans" in names[0]
    # no starts: nothing to launch, empty outputs
    before = gather_posting_spans.launches
    out = gather_posting_spans(ids, tf, starts[:0], window=W)
    assert [o.shape for o in out] == [(0, W), (0, W)] and gather_posting_spans.launches == before


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


# ---- K3: the streaming scan with a carried top-k -------------------------

K3_MODES = ["f32", "bf16", "int8", "int8_2pass", "resid", "resid_2pass"]


def _k3_args(mode, B, N, D, g, dev, n_codes=40):
    """Stream-scan operands on the card for one of K3's forms: unit rows
    (clustered, so near ties occur), and the kwargs of ``stream_topk``."""
    from rag_challenge_2_tpu_torch.ops.quant import (
        quantize_query_2pass, quantize_rows, quantize_rows_residual)

    cent = torch.randn(n_codes, D, generator=g)
    cent = cent / cent.norm(dim=1, keepdim=True)
    x = cent[torch.randint(0, n_codes, (N,), generator=g)] + 0.3 * torch.randn(N, D, generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    q = x[torch.randint(0, N, (B,), generator=g)] + 0.05 * torch.randn(B, D, generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    if mode in ("f32", "bf16"):
        emb = x if mode == "f32" else x.to(torch.bfloat16)
        return q.to(dev), emb.to(dev), {}
    if mode.startswith("resid"):
        emb, rs, assign = quantize_rows_residual(x, cent)
        kw = dict(row_scale=rs, assign=assign, qc=(q @ cent.T).contiguous())
    else:
        emb, rs = quantize_rows(x)
        kw = dict(row_scale=rs)
    if mode.endswith("2pass"):
        q8, s_hi, s_lo = quantize_query_2pass(q)
        kw.update(q_scale=s_hi, q_scale_lo=s_lo)
    else:
        q8, kw["q_scale"] = quantize_rows(q)
    return q8.to(dev), emb.to(dev), {n: t.to(dev) for n, t in kw.items()}


def _k3_check(mode, got, ref):
    """int8 forms: bitwise equal values and rows; f32 / bf16: values within
    1e-4, rows equal where untied."""
    (kv, ki), (pv, pi) = got, ref
    assert kv.shape == pv.shape and ki.dtype == torch.int32
    if mode.startswith(("int8", "resid")):
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
    else:
        _untied_rows_equal(kv, ki, pv, pi)


@pytest.mark.parametrize("mode", K3_MODES)
@pytest.mark.parametrize("B,N,D,k", [
    (127, 20_000, 1024, 30),         # the 10M scan's batch, at a small N
    (1, 3000, 1024, 10), (64, 5000, 256, 64), (65, 4097, 128, 48),
    (128, 1000, 96, 1),
    (5, 777, 100, 7),                # D = 100: int8 / bf16 rows take the element path
])
def test_k3_matches_plain(dev, mode, B, N, D, k):
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    g = torch.Generator(device="cpu").manual_seed(B + N + D + k)
    q, emb, kw = _k3_args(mode, B, N, D, g, dev)
    mask = (torch.rand(N, generator=g) > 0.2).to(dev)
    before = stream_topk.launches
    got = stream_topk(q, emb, k, mask, **kw)
    ref = stream_topk_plain(q, emb, k, mask, **kw)
    torch.cuda.synchronize()
    assert stream_topk.launches == before + 1
    _k3_check(mode, got, ref)
    got = stream_topk(q, emb, k, **kw)                  # no mask
    _k3_check(mode, got, stream_topk_plain(q, emb, k, **kw))


@pytest.mark.parametrize("mode", ["f32", "int8_2pass"])
def test_k3_overflow_all_masked_and_ties(dev, mode):
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    g = torch.Generator(device="cpu").manual_seed(7)
    q, emb, kw = _k3_args(mode, 9, 3000, 64, g, dev)
    few = torch.zeros(3000, dtype=torch.bool, device=dev)
    few[torch.tensor([5, 64, 2999], device=dev)] = True   # 3 eligible rows, k = 10
    kv, ki = stream_topk(q, emb, 10, few, **kw)
    _k3_check(mode, (kv, ki), stream_topk_plain(q, emb, 10, few, **kw))
    assert (ki[:, 3:] == -1).all() and (kv[:, 3:] == -3.0e38).all()
    assert set(ki[0, :3].tolist()) == {5, 64, 2999}
    kv, ki = stream_topk(q, emb, 10, torch.zeros_like(few), **kw)
    assert (ki == -1).all() and (kv == -3.0e38).all()
    if mode == "f32":                                      # every row three times
        emb3 = emb[:700].repeat(3, 1).contiguous()
        kv, ki = stream_topk(q, emb3, 30)
        pv, pi = stream_topk_plain(q, emb3, 30)
        assert torch.equal(ki, pi)
        same = kv[:, 1:] == kv[:, :-1]
        assert bool(same.any()) and bool((ki[:, 1:][same] > ki[:, :-1][same]).all())


def test_k3_rejects_what_it_does_not_take(dev):
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk

    q = torch.zeros(2, 8, device=dev)
    emb = torch.zeros(100, 8, device=dev)
    with pytest.raises(ValueError, match="mask"):
        stream_topk(q, emb, 2, torch.ones(2, 100, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="queries"):
        stream_topk(torch.zeros(129, 8, device=dev), emb, 2)
    with pytest.raises(ValueError, match="k <="):
        stream_topk(q, emb, 65)
    with pytest.raises(ValueError):
        stream_topk(q, emb.half(), 2)
    with pytest.raises(ValueError):                       # int8 store, no scales
        stream_topk(q.to(torch.int8), emb.to(torch.int8), 2)
    with pytest.raises(ValueError):                       # int8 rows wider than 1040
        stream_topk(torch.zeros(2, 1088, dtype=torch.int8, device=dev),
                    torch.zeros(10, 1088, dtype=torch.int8, device=dev), 2,
                    q_scale=torch.ones(2, device=dev), row_scale=torch.ones(10, device=dev))


def test_k3_on_the_scan_functions_equals_cpu(dev):
    """blocked_topk, int8_topk and the residual family on the card (K3)
    against the same calls on the CPU (plain versions)."""
    from rag_challenge_2_tpu_torch.ops import quant, topk
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk

    g = torch.Generator(device="cpu").manual_seed(11)
    N, D, B = 9000, 256, 130                                # B > 128: two K3 calls
    cent = torch.randn(32, D, generator=g)
    x = cent[torch.randint(0, 32, (N,), generator=g)] + 0.5 * torch.randn(N, D, generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    q = x[:B] + 0.1 * torch.randn(B, D, generator=g)
    mask = torch.rand(N, generator=g) > 0.5
    e8, rs = quant.quantize_rows(x)
    r8, rrs, ra = quant.quantize_rows_residual(x, cent)
    calls = {
        "blocked_f32": lambda d, m: topk.blocked_topk(q.to(d), x.to(d), 20, mask=m),
        "dense_b130": lambda d, m: topk.dense_topk(q.to(d), x.to(d), 20, mask=m),
        "int8_topk": lambda d, m: quant.int8_topk(q.to(d), e8.to(d), rs.to(d), 20, m),
        "resid": lambda d, m: quant.int8_residual_topk(
            q.to(d), r8.to(d), rrs.to(d), ra.to(d), cent.to(d), 20, m),
        "rescored": lambda d, m: quant.int8_residual_topk_rescored(
            q.to(d), r8.to(d), rrs.to(d), ra.to(d), cent.to(d), 10, k_cand=48, mask=m),
    }
    for name, fn in calls.items():
        before = stream_topk.launches
        gv, gi = fn(dev, mask.to(dev))
        cv, ci = fn("cpu", mask)
        torch.cuda.synchronize()
        assert stream_topk.launches == before + 2, name
        _untied_rows_equal(gv.cpu(), gi.cpu(), cv, ci)


def test_wide_int8_plain_products_on_the_card(dev):
    """int8 rows wider than K3 takes (D > 1040) still score exactly on
    the card in the plain functions (f64 products: CUDA has no integer
    matmul), equal to the CPU."""
    from rag_challenge_2_tpu_torch.ops import quant
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk_plain

    g = torch.Generator(device="cpu").manual_seed(12)
    a = torch.randint(-127, 128, (5, 1100), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (300, 1100), generator=g, dtype=torch.int8)
    a[0], b[0] = 127, 127                                   # the largest sum
    want = (a.long() @ b.long().T).float()
    assert torch.equal(quant.i8_dot(a.to(dev), b.to(dev)).cpu(), want)
    x = torch.randn(300, 1100, generator=g)
    q = torch.randn(5, 1100, generator=g)
    e8, rs = quant.quantize_rows(x)
    got = quant.int8_scores(q.to(dev), e8.to(dev), rs.to(dev)).cpu()
    assert torch.equal(got, quant.int8_scores(q, e8, rs))
    q8, qs = quant.quantize_rows(q)
    gv, gi = stream_topk_plain(q8.to(dev), e8.to(dev), 7, q_scale=qs.to(dev),
                               row_scale=rs.to(dev))
    cv, ci = stream_topk_plain(q8, e8, 7, q_scale=qs, row_scale=rs)
    assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu().long(), ci.long())


# ---- K3's int8 regimes (tensor-core products, one store pass) -------------

K3_INT8_MODES = ["int8", "int8_2pass", "resid", "resid_2pass"]


def _k3_int8_call(mode, B, N, D, k, g, dev, mask=None, store=None):
    """K3 and its plain version on one int8 form (``store`` may rewrite the
    store and its row arrays); both results bitwise equal, and the regime
    the planner picked for this batch ran."""
    from rag_challenge_2_tpu_torch.ops.stream_topk import (
        SMALL_CODE_ROWS, stream_topk, stream_topk_plain)

    q, e, kw = _k3_args(mode, B, N, D, g, dev)
    if store is not None:
        e, kw = store(e, kw)
    rows = 2 * B if mode.endswith("2pass") else B
    regime = "int8_small" if rows <= SMALL_CODE_ROWS else "int8_large"
    before = dict(stream_topk.regime_launches)
    got = stream_topk(q, e, k, mask, **kw)
    ref = stream_topk_plain(q, e, k, mask, **kw)
    torch.cuda.synchronize()
    assert stream_topk.regime_launches[regime] == before[regime] + 1
    _k3_check(mode, got, ref)
    return got


@pytest.mark.parametrize("mode", K3_INT8_MODES)
@pytest.mark.parametrize("B", [1, 8, 9, 16, 17, 127, 128])
def test_k3_int8_regime_boundaries(dev, mode, B):
    """Either side of the small regime's 16 code rows (B = 8 / 9 in 2-pass,
    16 / 17 in 1-pass) and the large tiles' edges; N not a multiple of the
    128-row tile."""
    g = torch.Generator(device="cpu").manual_seed(100 + B)
    mask = (torch.rand(5000, generator=g) > 0.2).to(dev)
    _k3_int8_call(mode, B, 5000, 256, 30, g, dev, mask)


@pytest.mark.parametrize("mode", K3_INT8_MODES)
@pytest.mark.parametrize("B", [4, 40])
@pytest.mark.parametrize("D", [32, 96, 1000, 1040])
def test_k3_int8_widths(dev, mode, B, D):
    """D below one 128-byte chunk, ragged last chunks, D = 1000 (rows not
    16-byte aligned: loaded by the threads) and the widest int8 row."""
    g = torch.Generator(device="cpu").manual_seed(D + B)
    _k3_int8_call(mode, B, 1500, D, 20, g, dev)


@pytest.mark.parametrize("mode", ["int8", "resid_2pass"])
@pytest.mark.parametrize("B", [3, 33])
@pytest.mark.parametrize("N,k", [(1, 1), (1, 64), (100, 64), (100, 1),
                                 (128 * 9 + 5, 64), (128 * 9 + 5, 1)])
def test_k3_int8_short_and_ragged_stores(dev, mode, B, N, k):
    """N smaller than one tile and N not a multiple of it, at k = 1 and 64."""
    g = torch.Generator(device="cpu").manual_seed(N * 7 + k + B)
    kv, ki = _k3_int8_call(mode, B, N, 64, k, g, dev)
    assert kv.shape == (B, min(k, N))


@pytest.mark.parametrize("mode", K3_INT8_MODES)
@pytest.mark.parametrize("B", [5, 40])
def test_k3_int8_masks_ties_and_misaligned_view(dev, mode, B):
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk

    g = torch.Generator(device="cpu").manual_seed(B + len(mode))
    N, D = 2001, 64
    kv, ki = _k3_int8_call(mode, B, N, D, 30, g, dev,
                           mask=torch.zeros(N, dtype=torch.bool, device=dev))
    assert (ki == -1).all() and (kv == -3.0e38).all()

    def thrice(e, kw):            # every row three times, with its row arrays
        def rep(t):
            return t[:N // 3].repeat(3, *([1] * (t.dim() - 1))).contiguous()
        kw = dict(kw, row_scale=rep(kw["row_scale"]))
        if "assign" in kw:
            kw["assign"] = rep(kw["assign"])
        return rep(e), kw

    # ties by value go to the lowest row
    kv, ki = _k3_int8_call(mode, B, N, D, 30, g, dev, store=thrice)
    same = kv[:, 1:] == kv[:, :-1]
    assert bool(same.any()) and bool((ki[:, 1:][same] > ki[:, :-1][same]).all())

    def misaligned(e, kw):        # rows that do not start on 16 bytes
        flat = torch.zeros(e.numel() + 1, dtype=e.dtype, device=dev)
        flat[1:] = e.reshape(-1)
        return flat[1:].view(e.shape), kw

    _k3_int8_call(mode, B, N, D, 30, g, dev, store=misaligned)
    assert stream_topk.launches > 0


def test_k3_planner_constants_match_the_library(dev):
    from rag_challenge_2_tpu_torch.ops import stream_topk as sk

    assert sk.library_constants() == sk.CONSTANTS
    lib = sk._lib()
    for n in (1, 63, 64, 65, 132, 264):
        assert lib.rc2_stream_topk_scratch_chunks(n) == sk.scratch_chunks(n)
    from rag_challenge_2_tpu_torch.ops import float_scan as fs

    for qt in (8, 64, 96, 128):
        for bf16 in (0, 1):
            rows = fs.tile_rows(qt)
            assert lib.rc2_stream_topk_float_stages(qt, fs.TILES[qt][0], rows, bf16, 30, 1) == \
                fs.stages_for(qt, rows, 2 if bf16 else 4, 30, 1)


# ---- scan_float: K1 and K3's f32 / bf16 forms (one kernel, two contracts) --

def test_k1_planner_constants_match_the_library(dev):
    from rag_challenge_2_tpu_torch.ops import float_scan as fs
    from rag_challenge_2_tpu_torch.ops.dense_topk import _lib, library_constants

    assert library_constants() == fs.FLOAT_CONSTANTS
    lib = _lib()
    for qt, (tq, _, _) in fs.TILES.items():
        for bf16 in (0, 1):
            for k in (1, 30, 64):
                for bps in (1, 2):
                    rows = fs.tile_rows(qt)
                    assert lib.rc2_dense_topk_stages(qt, tq, rows, bf16, k, bps) == \
                        fs.stages_for(qt, rows, 2 if bf16 else 4, k, bps)


def _float_inputs(B, N, D, dtype, g, dev, clustered=True):
    """Unit rows around a few centres (near ties occur) and queries near
    rows, on the card."""
    cent = torch.randn(24, D, generator=g)
    x = cent[torch.randint(0, 24, (N,), generator=g)] + 0.4 * torch.randn(N, D, generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    q = x[torch.randint(0, N, (B,), generator=g)] + 0.05 * torch.randn(B, D, generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    return q.to(dev), x.to(dev, dtype)


def _rows_equal_where_untied(kv, ki, plain, k, tol=1e-4):
    """Values within ``tol`` of the plain version's and rows equal wherever
    the plain value is apart from both neighbours by more than 2 tol.  The
    plain version is asked for one more than k, so the last place is held
    against the value just below the cut too."""
    pv, pi = plain(k + 1)
    n = kv.shape[1]
    torch.testing.assert_close(kv, pv[:, :n], rtol=0, atol=tol)
    step = (pv[:, 1:] - pv[:, :-1]).abs()
    inf = torch.full_like(pv[:, :1], float("inf"))
    gap = torch.minimum(torch.cat([inf, step], 1), torch.cat([step, inf], 1))[:, :n]
    untied = gap > 2 * tol
    assert torch.equal(ki[untied], pi[:, :n][untied])


def _k1_check(q, emb, k, mask=None):
    kv, ki = dense_topk_fused(q, emb, k, mask)
    torch.cuda.synchronize()
    assert kv.shape == (q.shape[0], min(k, emb.shape[0])) and ki.dtype == torch.int32
    _rows_equal_where_untied(kv, ki, lambda kk: dense_topk_plain(q, emb, kk, mask), k)
    return kv, ki


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 7, 8, 9, 33, 64])
@pytest.mark.parametrize("N", [1, 255, 256, 257, 4099, 70_001])
def test_k1_batches_and_row_counts(dev, dtype, B, N):
    """Every query tile (8 / 16 / 32 / 64) either side of its edge, stores
    of one row, one tile less / exactly / more one row, ragged, and large
    enough for several tiles per block; with and without a mask."""
    g = torch.Generator(device="cpu").manual_seed(B * 131 + N)
    q, emb = _float_inputs(B, N, 64, dtype, g, dev)
    _k1_check(q, emb, 30)
    _k1_check(q, emb, 30, (torch.rand(N, generator=g) > 0.4).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 64])
@pytest.mark.parametrize("D", [32, 1000, 1024])
@pytest.mark.parametrize("B", [4, 20])
def test_k1_widths_and_k(dev, dtype, k, D, B):
    """D below one 128-byte chunk, D = 1000 (a ragged last chunk; bf16 rows
    of 2000 bytes are 16-byte aligned, f32 rows too) and the main width."""
    g = torch.Generator(device="cpu").manual_seed(D + k + B)
    q, emb = _float_inputs(B, 3001, D, dtype, g, dev)
    _k1_check(q, emb, k, (torch.rand(3001, generator=g) > 0.2).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 50, 7])
def test_k1_rows_the_threads_load(dev, dtype, D):
    """Rows that TMA does not take: a store view that does not start on 16
    bytes, and row widths that are no multiple of 16 bytes."""
    g = torch.Generator(device="cpu").manual_seed(D)
    N = 2500
    q, emb = _float_inputs(9, N + 1, D, dtype, g, dev)
    view = emb.reshape(-1)[1:1 + N * D].view(N, D)
    assert view.data_ptr() % 16 != 0 or D % 8 != 0
    _k1_check(q, view, 30, (torch.rand(N, generator=g) > 0.3).to(dev))
    _k1_check(q, emb[:N].contiguous(), 30)


@pytest.mark.parametrize("B", [3, 40])
def test_k1_all_masked_ties_across_chunks_and_k_above_n(dev, B):
    g = torch.Generator(device="cpu").manual_seed(B)
    q, emb = _float_inputs(B, 9000, 48, torch.float32, g, dev)
    # all masked: NEG_INF values, the lowest rows first
    kv, ki = _k1_check(q, emb, 30, torch.zeros(9000, dtype=torch.bool, device=dev))
    assert (kv == -3.0e38).all()
    assert torch.equal(ki, torch.arange(30, device=dev, dtype=torch.int32).expand(B, 30))
    # fewer eligible rows than k: the masked rows follow, lowest first
    few = torch.zeros(9000, dtype=torch.bool, device=dev)
    few[torch.tensor([7, 4000, 8999], device=dev)] = True
    kv, ki = _k1_check(q, emb, 10, few)
    assert set(ki[0, :3].tolist()) == {7, 4000, 8999}
    assert ki[0, 3:].tolist() == [0, 1, 2, 3, 4, 5, 6]
    # every row three times, 3,000 rows apart: the copies of one row lie in
    # different blocks' chunks, and equal values come in ascending row order
    emb3 = emb[:3000].repeat(3, 1).contiguous()
    kv, ki = dense_topk_fused(q, emb3, 30)
    pv, pi = dense_topk_plain(q, emb3, 30)
    assert torch.equal(ki, pi)
    same = kv[:, 1:] == kv[:, :-1]
    assert bool(same.any()) and bool((ki[:, 1:][same] > ki[:, :-1][same]).all())
    # k > N
    kv, ki = _k1_check(q, emb[:20].contiguous(), 64)
    assert kv.shape == (B, 20)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("B", [16, 17, 64, 65, 96, 97, 128])
@pytest.mark.parametrize("N,D,k", [(1, 64, 5), (255, 64, 30), (257, 32, 64), (9001, 1000, 30),
                                   (40_000, 128, 1), (1700, 1024, 30)])
def test_k3_float_query_tile_boundaries(dev, mode, B, N, D, k):
    """K3's f32 / bf16 forms either side of each query tile's edge, on short,
    ragged and multi-tile stores, and on one routed slot of the deployment
    (1,700 full-width rows: a block owns less than a tile); masked rows
    never enter.  Both calls run the regime the planner picks: bf16_tc for
    bf16 rows above 16 queries, else float."""
    from rag_challenge_2_tpu_torch.ops.float_scan import sm_count
    from rag_challenge_2_tpu_torch.ops.stream_topk import plan, stream_topk, stream_topk_plain

    g = torch.Generator(device="cpu").manual_seed(B + N + D)
    q, emb = _float_inputs(B, N, D, torch.float32 if mode == "f32" else torch.bfloat16,
                           g, dev)
    mask = (torch.rand(N, generator=g) > 0.3).to(dev)
    regime = plan(B, False, False, N, sm_count(dev), k, emb.element_size(), D,
                  emb.data_ptr() % 16 == 0).regime
    assert regime == ("bf16_tc" if mode == "bf16" and B > 16 else "float")
    before = dict(stream_topk.regime_launches)
    for m in (None, mask):
        kv, ki = stream_topk(q, emb, k, m)
        assert kv.shape == (B, min(k, N)) and ki.dtype == torch.int32
        _rows_equal_where_untied(kv, ki, lambda kk: stream_topk_plain(q, emb, kk, m), k)
    torch.cuda.synchronize()
    assert stream_topk.regime_launches[regime] == before[regime] + 2
    assert sum(stream_topk.regime_launches.values()) == sum(before.values()) + 2


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_k3_float_misaligned_view_and_ties(dev, mode):
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    g = torch.Generator(device="cpu").manual_seed(3)
    N, D = 2100, 64
    q, emb = _float_inputs(70, N + 1, D, torch.float32 if mode == "f32" else torch.bfloat16,
                           g, dev)
    view = emb.reshape(-1)[1:1 + N * D].view(N, D)
    kv, ki = stream_topk(q, view, 30)
    _rows_equal_where_untied(kv, ki, lambda kk: stream_topk_plain(q, view, kk), 30)
    emb3 = emb[:700].repeat(3, 1).contiguous()
    kv, ki = stream_topk(q, emb3, 30)
    pv, pi = stream_topk_plain(q, emb3, 30)
    assert torch.equal(ki, pi)
    same = kv[:, 1:] == kv[:, :-1]
    assert bool(same.any()) and bool((ki[:, 1:][same] > ki[:, :-1][same]).all())


# ---- K3's bf16_tc regime: bf16 rows on the tensor cores ---------------------

def _bf16_call(q, emb, k, mask=None):
    """K3 on a bf16 store above 16 queries: one bf16_tc launch, held
    against the plain version (values within 1e-4, rows equal where
    untied)."""
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    before = dict(stream_topk.regime_launches)
    kv, ki = stream_topk(q, emb, k, mask)
    torch.cuda.synchronize()
    after = stream_topk.regime_launches
    assert after["bf16_tc"] == before["bf16_tc"] + 1 and after["float"] == before["float"]
    assert kv.shape == (q.shape[0], min(k, emb.shape[0])) and ki.dtype == torch.int32
    _rows_equal_where_untied(kv, ki, lambda kk: stream_topk_plain(q, emb, kk, mask), k)
    return kv, ki


@pytest.mark.parametrize("B", [17, 31, 32, 33, 64, 96, 127, 128])
@pytest.mark.parametrize("k", [1, 30, 64])
@pytest.mark.parametrize("N,D", [(3_001, 256), (40_000, 128)])
def test_k3_bf16_tc_matches_plain(dev, B, k, N, D):
    """Every query tile (32 / 64 / 96 / 128) either side of its edge, k at
    1, 30 and 64, a ragged store of fewer tiles than the grid has blocks
    and one of several tiles a block, with and without a mask."""
    g = torch.Generator(device="cpu").manual_seed(B * 7 + k + N)
    q, emb = _float_inputs(B, N, D, torch.bfloat16, g, dev)
    _bf16_call(q, emb, k)
    _bf16_call(q, emb, k, (torch.rand(N, generator=g) > 0.3).to(dev))


@pytest.mark.parametrize("D", [8, 72, 1000])
def test_k3_bf16_tc_widths_masks_and_overflow(dev, D):
    """D below one 64-value chunk and ragged last chunks; a mask that
    leaves fewer rows than k (the rest row -1 at NEG_INF) and one that
    leaves none."""
    g = torch.Generator(device="cpu").manual_seed(D)
    N = 2_500
    q, emb = _float_inputs(40, N, D, torch.bfloat16, g, dev)
    _bf16_call(q, emb, 30, (torch.rand(N, generator=g) > 0.5).to(dev))
    few = torch.zeros(N, dtype=torch.bool, device=dev)
    few[torch.tensor([3, 700, 2_499], device=dev)] = True
    kv, ki = _bf16_call(q, emb, 10, few)
    assert (ki[:, 3:] == -1).all() and (kv[:, 3:] == -3.0e38).all()
    assert set(ki[0, :3].tolist()) == {3, 700, 2_499}
    kv, ki = _bf16_call(q, emb, 10, torch.zeros_like(few))
    assert (ki == -1).all() and (kv == -3.0e38).all()


def test_k3_bf16_tc_takes_only_what_tma_reads(dev):
    """A view that does not start on 16 bytes, and rows of D % 8 != 0
    values, stay on scan_float; the same rows aligned run bf16_tc."""
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    g = torch.Generator(device="cpu").manual_seed(9)
    N = 3_000
    for D, view in ((64, True), (60, False)):
        q, emb = _float_inputs(50, N + 1, D, torch.bfloat16, g, dev)
        e = emb.reshape(-1)[1:1 + N * D].view(N, D) if view else emb[:N].contiguous()
        before = dict(stream_topk.regime_launches)
        kv, ki = stream_topk(q, e, 30)
        torch.cuda.synchronize()
        assert stream_topk.regime_launches["float"] == before["float"] + 1
        assert stream_topk.regime_launches["bf16_tc"] == before["bf16_tc"]
        _rows_equal_where_untied(kv, ki, lambda kk: stream_topk_plain(q, e, kk), 30)
    _bf16_call(q[:, :56].contiguous(), emb[:N, :56].contiguous(), 30)


def test_k3_bf16_tc_precision_against_f64(dev):
    """The three-plane split keeps every bit of the f32 query: each value
    at D = 1024 over unit rows lies within 1e-5 of the f64 score of the
    bf16 row it names (a tenth of the bf16 cell's value_gap limit).
    Measured on an H100: 2.19e-7, against 1.85e-6 for scan_float's f32 FMA
    in the bf16 cell.  A query rounded to bf16 (the hi plane alone) would
    miss by ~1e-4, one without its lo plane by only ~5e-7: the test below
    holds each plane bit for bit."""
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk

    g = torch.Generator(device=dev).manual_seed(20)
    N, D, B = 200_000, 1024, 127
    emb = torch.nn.functional.normalize(torch.randn(N, D, generator=g, device=dev))
    emb = emb.to(torch.bfloat16)
    q = emb[torch.randint(0, N, (B,), generator=g, device=dev)].float() + \
        0.25 * torch.randn(B, D, generator=g, device=dev) / D ** 0.5
    q = torch.nn.functional.normalize(q).contiguous()
    kv, ki = stream_topk(q, emb, 30)
    exact = (q.double()[:, None, :] * emb[ki.long()].double()).sum(-1)
    err = (kv.double() - exact).abs().max().item()
    print(f"bf16_tc max |value - f64| at D = {D}: {err:.3g}")
    assert err <= 1e-5


@pytest.mark.parametrize("B", [17, 127])
def test_k3_bf16_tc_keeps_every_plane_of_the_query(dev, B):
    """Row j holds one power of two, 2^(j // D), at column j % D, so its
    exact score is q[:, j % D] * 2^(j // D): one product a row, no rounding
    anywhere.  Every query value has all 24 significant bits set down to
    the last, so each of its hi, mid and lo planes carries bits, and the
    returned values equal the exact scores bit for bit only if all three
    planes reached the tensor cores (without lo a value misses by up to
    2^7 ulps, without mid by up to 2^15)."""
    g = torch.Generator(device="cpu").manual_seed(B)
    D, k = 1024, 64
    N = 3 * D
    m = torch.randint(1 << 22, 1 << 23, (B, D), generator=g) * 2 + 1   # 24 bits, odd
    e = torch.randint(-8, 9, (B, D), generator=g).double()
    sign = torch.where(torch.rand(B, D, generator=g) < 0.5, -1.0, 1.0).double()
    q = (sign * m.double() / 2 ** 23 * torch.exp2(e)).float()
    assert torch.equal(q.double(), sign * m.double() / 2 ** 23 * torch.exp2(e))
    scale = torch.exp2(torch.arange(N) // D).float()
    emb = torch.zeros(N, D)
    emb[torch.arange(N), torch.arange(N) % D] = scale
    exact = q[:, torch.arange(N) % D] * scale          # f32: exact
    q, emb = q.to(dev).contiguous(), emb.to(torch.bfloat16).to(dev)
    kv, ki = _bf16_call(q, emb, k)
    exact = exact.to(dev)
    assert torch.equal(kv, torch.topk(exact, k, dim=1).values)
    assert torch.equal(kv, exact.gather(1, ki.long()))


@pytest.mark.parametrize("period", [700, 5_003])
def test_k3_bf16_tc_copies_of_a_row_score_the_same_bits(dev, period):
    """Every row three times, ``period`` rows apart: the copies sit at other
    places of a tile (700) or in other blocks' chunks (5,003 rows: one
    stage of two tiles a block), and score the same bits, returned in
    ascending row order."""
    g = torch.Generator(device="cpu").manual_seed(period)
    q, emb = _float_inputs(100, period, 256, torch.bfloat16, g, dev)
    emb3 = emb.repeat(3, 1).contiguous()
    kv, ki = _bf16_call(q, emb3, 30)
    v3, i3 = kv.view(-1, 10, 3), ki.view(-1, 10, 3).long()
    assert torch.equal(v3, v3[:, :, :1].expand_as(v3))
    assert torch.equal(i3 - i3[:, :, :1], torch.tensor([0, period, 2 * period], device=dev)
                       .expand_as(i3))


@pytest.mark.parametrize("N", [1_700, 250_000])
@pytest.mark.parametrize("B", [80, 160])
def test_k3_bf16_tc_at_the_hop_shapes(dev, N, B):
    """A traversal hop of 80 or 160 walkers (128 + 32: two launches, both
    bf16_tc) over one document's full-width bf16 rows, k = 31, with and
    without a row-shared mask, through ops.topk.dense_topk."""
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk

    g = torch.Generator(device="cpu").manual_seed(N + B)
    q, emb = _float_inputs(B, N, 1024, torch.bfloat16, g, dev)
    for mask in (None, (torch.rand(N, generator=g) > 0.4).to(dev)):
        before = dict(stream_topk.regime_launches)
        kv, ki = dense_topk(q, emb, 31, mask=mask)
        torch.cuda.synchronize()
        assert stream_topk.regime_launches["bf16_tc"] == before["bf16_tc"] + -(-B // 128)
        assert stream_topk.regime_launches["float"] == before["float"]
        _rows_equal_where_untied(kv, ki, lambda kk: dense_topk_plain(q, emb, kk, mask), 31)


def test_k3_tc_constants_match_the_library(dev):
    from rag_challenge_2_tpu_torch.ops import stream_topk as sk

    assert sk.library_tc_constants() == sk.TC_CONSTANTS
    lib = sk._lib()
    for qt in sk.TC_QUERY_TILES:
        for k in (1, 30, 31, 64):
            for tiles in (1, 2):
                assert lib.rc2_stream_topk_tc_stages(qt, tiles, k) == sk.tc_stages(qt, tiles, k)


# ---- the traversal's hop shapes: K1 / K3 through ops.topk.dense_topk ------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1_700, 250_000])
@pytest.mark.parametrize("B,k", [(8, 31), (10, 31), (20, 31), (80, 31), (128, 31),
                                 (160, 31), (8, 1), (160, 1)])
def test_hop_shapes_match_plain(dev, dtype, N, B, k):
    """A hop of B walkers over one document's rows, with and without a
    row-shared mask: K1 up to 64 walkers, K3 above, split at 128."""
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk

    g = torch.Generator(device="cpu").manual_seed(N + B + k)
    D = 1024 if N == 1_700 else 128
    q = torch.nn.functional.normalize(torch.randn(B, D, generator=g)).to(dev)
    emb = torch.nn.functional.normalize(torch.randn(N, D, generator=g)).to(dev, dtype)
    for mask in (None, (torch.rand(N, generator=g) > 0.4).to(dev)):
        k1, k3 = dense_topk_fused.launches, stream_topk.launches
        kv, ki = dense_topk(q, emb, k, mask=mask)
        pv, pi = dense_topk_plain(q, emb, k, mask)
        torch.cuda.synchronize()
        assert (dense_topk_fused.launches - k1, stream_topk.launches - k3) == (
            (1, 0) if B <= 64 else (0, -(-B // 128)))
        _untied_rows_equal(kv, ki, pv, pi)


def test_traversal_on_the_card_equals_the_cpu(dev):
    """Both traversal forms on CUDA tensors (kernel hops) against the same
    call on CPU copies (plain hops), for walkers clear of ties; int8 and
    per-walker-mask hops are plain PyTorch on the card too."""
    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.retrieval.traversal import traverse, traverse_windowed

    g = torch.Generator(device="cpu").manual_seed(5)
    N, D, A = 6_000, 256, 80
    emb = torch.nn.functional.normalize(torch.randn(N, D, generator=g))
    q = torch.nn.functional.normalize(torch.randn(3, A, D, generator=g))
    ws, wl = [0, 2_000, 4_100], [2_000, 2_100, 1_900]
    anchors = torch.stack([torch.randint(s, s + n, (A,), generator=g)
                           for s, n in zip(ws, wl)]).to(torch.int32)
    anchors[1, 7] = -1
    e8, sc = quantize_rows(emb)

    def clear(res, mode):
        # tie windows: SSG's raw similarities 4e-6; triangulation's step score
        # 1 / (1 + dist) moves a tenth as much with the sums' order: 1e-6
        cs, hs, path = res.cand_scores, res.hop_score, res.path
        tie = 4e-6 if mode == "ssg" else 1e-6
        ok = ~((res.cand_ids[:, :, 1] >= 0) & ((cs[:, :, 0] - cs[:, :, 1]).abs() <= tie)).any(1)
        if mode == "ssg":
            ok &= ~((path[:, 2:] >= 0) & ((hs[:, 2:] - hs[:, 1:-1]).abs() <= tie)).any(1)
        return ok

    for mode in ("ssg", "triangulation"):
        for store, scale in ((emb, None), (emb.to(torch.bfloat16), None), (e8, sc)):
            k1, k3 = dense_topk_fused.launches, stream_topk.launches
            got = traverse_windowed(store.to(dev), anchors.to(dev), q.to(dev), ws, wl,
                                    None if scale is None else scale.to(dev),
                                    max_hops=3, neighbor_k=30, mode=mode)
            torch.cuda.synchronize()
            hops = stream_topk.launches - k3
            assert dense_topk_fused.launches == k1
            assert hops == (0 if store.dtype == torch.int8 else 9)   # 3 groups x 3 hops
            ref = traverse_windowed(store, anchors, q, ws, wl, scale,
                                    max_hops=3, neighbor_k=30, mode=mode)
            got = type(got)(*(x.cpu() for x in got))
            ok = clear(got, mode) & clear(ref, mode)
            assert (~ok).sum() <= 0.01 * ok.numel()
            assert torch.equal(got.path[ok], ref.path[ok])
            # a recorded candidate is compared where its score is clear of
            # both its neighbours in the record
            gap = (ref.cand_scores[..., :-1] - ref.cand_scores[..., 1:]).abs() > 4e-6
            edge = torch.ones_like(gap[..., :1])
            sel = (torch.cat([edge, gap], -1) & torch.cat([gap, ~edge], -1)
                   & ok[:, None, None] & (ref.cand_ids >= 0))
            assert torch.equal(got.cand_ids[sel], ref.cand_ids[sel])
            torch.testing.assert_close(got.hop_score[ok], ref.hop_score[ok],
                                       rtol=0, atol=1e-4)
        # a per-walker [A, N] mask: plain hops on the card, no launch
        mask = torch.zeros(A, N, dtype=torch.bool)
        mask[:, : wl[0]] = True
        k1, k3 = dense_topk_fused.launches, stream_topk.launches
        got = traverse(emb.to(dev), anchors[0].to(dev), q[0].to(dev), mask.to(dev),
                       max_hops=2, neighbor_k=30, mode=mode)
        assert (dense_topk_fused.launches, stream_topk.launches) == (k1, k3)
        ref = traverse(emb, anchors[0], q[0], mask, max_hops=2, neighbor_k=30, mode=mode)
        got = type(got)(*(x.cpu() for x in got))
        ok = clear(got, mode) & clear(ref, mode)
        assert (~ok).sum() <= 0.01 * ok.numel() and torch.equal(got.path[ok], ref.path[ok])


def test_neighbor_k_above_the_kernels_k_raises_on_the_card(dev):
    """neighbor_k + 1 = 65 used to raise on the card; the hop now routes by
    k: 64 candidates through K1, 65 through ``wide_topk`` (no kernel
    launch), and both answer as the CPU does."""
    from rag_challenge_2_tpu_torch.ops.topk import wide_topk
    from rag_challenge_2_tpu_torch.retrieval.traversal import traverse

    emb = torch.nn.functional.normalize(torch.randn(500, 32, device=dev))
    for nk, wide in ((63, 0), (64, 2)):
        k1, w = dense_topk_fused.launches, wide_topk.launches
        res = traverse(emb, torch.tensor([3], device=dev), emb[3:4].clone(), None,
                       max_hops=2, neighbor_k=nk, mode="ssg")
        ref = traverse(emb.cpu(), torch.tensor([3]), emb[3:4].cpu(), None,
                       max_hops=2, neighbor_k=nk, mode="ssg")
        assert (dense_topk_fused.launches - k1, wide_topk.launches - w) == (
            (2, 0) if not wide else (0, wide))
        assert res.path[0, 1] >= 0 and torch.equal(res.path.cpu(), ref.path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("B,k", [(8, 100), (70, 65), (130, 200)])
def test_wide_k_on_the_card_equals_the_cpu(dev, dtype, B, k):
    """k above 64: ``dense_topk`` (and through it ``int8_topk`` and
    ``blocked_topk``) takes ``wide_topk`` on the card, one call per 128
    queries, no K1 / K3 launch; values within 1e-4 of the CPU's, rows
    equal where untied, overflow slots as the CPU's.  int8 is not bitwise
    here: on the card ``amax / 127`` in ``quantize_rows`` runs as a
    multiply by 1/127, one ulp off the CPU's division on some queries."""
    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk, wide_topk

    g = torch.Generator(device="cpu").manual_seed(B + k)
    q = torch.randn(B, 96, generator=g)
    emb = torch.randn(20_000, 96, generator=g)
    mask = torch.rand(20_000, generator=g) > 0.995          # ~100 eligible rows
    scale = None
    if dtype == torch.int8:
        emb, scale = quantize_rows(emb)
    else:
        emb = emb.to(dtype)
    counts = (dense_topk_fused.launches, stream_topk.launches, wide_topk.launches)
    kv, ki = dense_topk(q.to(dev), emb.to(dev), k, mask.to(dev),
                        row_scale=None if scale is None else scale.to(dev))
    torch.cuda.synchronize()
    assert (dense_topk_fused.launches, stream_topk.launches,
            wide_topk.launches) == (counts[0], counts[1], counts[2] + -(-B // 128))
    pv, pi = dense_topk(q, emb, k, mask, row_scale=scale)
    assert kv.shape == pv.shape == (B, k)
    _untied_rows_equal(kv.cpu(), ki.cpu(), pv, pi)
