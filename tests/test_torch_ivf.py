"""The IVF probe path of the port held against the JAX package on the CPU.

The same numpy inputs go through both.  Where the JAX function reaches
its Pallas span kernel it runs in interpret mode (``impl="pallas"``), as
tests/test_ivf.py does.  Tolerances:

* int8 codes and int8 dot products are integers: bitwise.
* quantization scales: within 1 ulp (one f32 division and reciprocal).
* f32 and bf16 scores: 1e-5 (f32 sums taken in another order).
* k-means centroids: 1e-5 on well-separated data, where the assignments,
  and so every list, must be equal.
* ivf_search rows: equal, on one IVFIndex built by JAX and carried
  across through save_ivf / load_ivf.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.index.schema import CorpusIndex as JaxCorpusIndex
from rag_challenge_2_tpu.ops.pallas_ivf import ROW_ALIGN as JAX_ROW_ALIGN
from rag_challenge_2_tpu.ops.pallas_ivf import dma_slack_rows as jax_dma_slack_rows
from rag_challenge_2_tpu.ops.pallas_ivf import probe_span_scores as jax_probe
from rag_challenge_2_tpu.ops.quant import quantize_rows as jax_quantize_rows
from rag_challenge_2_tpu_torch.index import ivf as tivf
from rag_challenge_2_tpu_torch.index import store as tstore
from rag_challenge_2_tpu_torch.index.schema import CorpusIndex
from rag_challenge_2_tpu_torch.ops import kmeans as tkm
from rag_challenge_2_tpu_torch.ops.probe_scores import (
    ROW_ALIGN, dma_slack_rows, probe_span_scores, probe_span_scores_plain)
from rag_challenge_2_tpu_torch.ops.quant import quantize_rows

# the JAX package's ``ops`` exports a function named ``kmeans``
jivf = importlib.import_module("rag_challenge_2_tpu.index.ivf")
jstore = importlib.import_module("rag_challenge_2_tpu.index.store")
jkm = importlib.import_module("rag_challenge_2_tpu.ops.kmeans")

TOL = 1e-5


def _clustered(rng, n_clusters=8, per=100, d=32, spread=0.05):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = np.repeat(centers, per, axis=0) + spread * rng.normal(
        size=(n_clusters * per, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.float().numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" else a


def _same_ivf(t, j, store_exact=True):
    for f in ("row_ids", "pos_cluster", "list_offsets", "list_row_min",
              "list_row_max", "cluster_doc"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f)
    for f in ("k_clusters", "max_list", "dim", "list_align", "dma_pad_rows"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_allclose(_np(t.centroids), np.asarray(j.centroids),
                               rtol=TOL, atol=TOL)
    assert t.emb_perm.shape == tuple(j.emb_perm.shape)
    if store_exact:
        np.testing.assert_array_equal(_np(t.emb_perm), _np(j.emb_perm))


def _same_hits(tvals, trows, jvals, jrows):
    """Values within TOL; rows identical, except that inside a group of
    values tied within 2 * TOL the order is free (f32 sums in another
    order can swap near-ties)."""
    tv, tr = tvals.numpy(), trows.numpy()
    jv, jr = np.asarray(jvals), np.asarray(jrows)
    assert tv.shape == jv.shape and trows.dtype == torch.int32
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    for b in range(jv.shape[0]):
        i = 0
        while i < jv.shape[1]:
            j = i + 1
            while j < jv.shape[1] and abs(jv[b, j] - jv[b, j - 1]) <= 2 * TOL:
                j += 1
            if j < jv.shape[1] or i == 0:   # a group cut at k is free
                assert sorted(tr[b, i:j]) == sorted(jr[b, i:j]), (b, i, j)
            i = j


def test_layout_constants_match():
    assert ROW_ALIGN == JAX_ROW_ALIGN
    for m in (0, 1, 127, 128, 500, 4097):
        assert dma_slack_rows(m) == jax_dma_slack_rows(m)


# ---------------------------------------------------------------- quant

def test_quantize_rows_matches_jax(rng):
    x = rng.normal(size=(64, 40)).astype(np.float32)
    x[3] = 0.0                                        # all-zero row
    x[5] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5] + [0.0] * 34   # half-way codes
    x[6] = np.linspace(-127, 127, 40) + 0.5
    q, s = quantize_rows(torch.from_numpy(x))
    jq, js = jax_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    assert q.dtype == torch.int8 and s[3] == 0 and (q[3] == 0).all()
    assert q[5, :6].tolist() == [127, 2, -4, 0, 0, 2]   # half to even


# ---------------------------------------------------------------- k-means

def test_kmeans_matches_jax(rng):
    x = _clustered(rng)
    tc, ta = tkm.kmeans(torch.from_numpy(x), 8, iters=10, seed=1, block=128)
    jc, ja = jkm.kmeans(jnp.asarray(x), 8, iters=10, seed=1, block=128)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    # k > N pads with zero centroids, as in JAX
    tc, ta = tkm.kmeans(torch.from_numpy(x[:5]), 7, iters=2, seed=0)
    jc, ja = jkm.kmeans(jnp.asarray(x[:5]), 7, iters=2, seed=0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)


def test_assign_clusters_matches_jax(rng):
    x = rng.normal(size=(1000, 16)).astype(np.float32)
    c = rng.normal(size=(10, 16)).astype(np.float32)
    ta = tkm.assign_clusters(torch.from_numpy(x), torch.from_numpy(c), block=128)
    ja = jkm.assign_clusters(jnp.asarray(x), jnp.asarray(c), block=128)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("k", [4, 16])
def test_kmeans_batched_matches_jax(rng, k):
    xs = np.stack([_clustered(rng, n_clusters=4, per=50, d=16) for _ in range(3)])
    tc, ta = tkm.kmeans_batched(torch.from_numpy(xs), k, iters=6, seed=2)
    jc, ja = jkm.kmeans_batched(jnp.asarray(xs), k, iters=6, seed=2)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- build

def _nested(rng, n_super=4, n_sub=3, per=60, d=32):
    """Clusters made of well-separated sub-clusters: the balanced build's
    sub-splits then have one right answer."""
    pts = []
    for _ in range(n_super):
        c = rng.normal(size=d)
        for _ in range(n_sub):
            s = c + 0.8 * rng.normal(size=d)
            pts.append(s + 0.03 * rng.normal(size=(per, d)))
    x = np.concatenate(pts).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("cap", [None, 70])
def test_build_ivf_matches_jax(rng, cap):
    x = _nested(rng)
    n = len(x)
    xp = np.zeros((n + 40, x.shape[1]), np.float32)
    xp[:n] = x
    valid = np.arange(n + 40) < n
    t = tivf.build_ivf(torch.from_numpy(xp), n_clusters=4, iters=8,
                       valid=torch.from_numpy(valid), max_list_size=cap)
    j = jivf.build_ivf(jnp.asarray(xp), n_clusters=4, iters=8,
                       valid=jnp.asarray(valid), max_list_size=cap)
    _same_ivf(t, j)
    if cap:
        assert t.k_clusters > 4 and t.max_list <= cap
    assert t.emb_perm.shape[0] % 128 == 0
    assert (t.list_offsets.numpy() % ROW_ALIGN == 0).all()


def test_build_ivf_keeps_store_dtype(rng):
    x = _clustered(rng, per=40)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        t = tivf.build_ivf(torch.from_numpy(x).to(tdt), n_clusters=8, iters=5)
        j = jivf.build_ivf(jnp.asarray(x, jdt), n_clusters=8, iters=5)
        assert t.emb_perm.dtype == tdt
        _same_ivf(t, j)


@pytest.mark.parametrize("quantize", [False, True])
def test_build_ivf_streaming_matches_jax(rng, quantize):
    x = _clustered(rng, n_clusters=8, per=150, d=32)
    C = 300
    chunks = [x[i:i + C] for i in range(0, len(x), C)]
    kw = dict(n_clusters=8, iters=8, sample_rows=600, max_list_size=400,
              quantize=quantize)
    t = tivf.build_ivf_streaming(lambda i: torch.from_numpy(chunks[i]),
                                 len(chunks), **kw)
    j = jivf.build_ivf_streaming(lambda i: jnp.asarray(chunks[i]),
                                 len(chunks), **kw)
    _same_ivf(t, j, store_exact=not quantize)
    assert (t.emb_perm.dtype == torch.int8) == quantize
    if quantize:
        np.testing.assert_array_equal(t.emb_perm.numpy(), np.asarray(j.emb_perm))
        np.testing.assert_array_max_ulp(t.row_scale.numpy(),
                                        np.asarray(j.row_scale), maxulp=1)
    # structure, as the reference's test holds it
    row_ids = t.row_ids.numpy()
    live = row_ids >= 0
    assert sorted(row_ids[live].tolist()) == list(range(len(x)))
    a_all = tkm.assign_clusters(torch.from_numpy(x), t.centroids).numpy()
    np.testing.assert_array_equal(t.pos_cluster.numpy()[live], a_all[row_ids[live]])


def test_quantize_ivf_matches_jax_and_is_idempotent(rng):
    x = _clustered(rng, per=40)
    j = jivf.build_ivf(jnp.asarray(x), n_clusters=8, iters=5)
    t = tivf.build_ivf(torch.from_numpy(x), n_clusters=8, iters=5)
    tq, jq = tivf.quantize_ivf(t), jivf.quantize_ivf(j)
    np.testing.assert_array_equal(tq.emb_perm.numpy(), np.asarray(jq.emb_perm))
    np.testing.assert_array_max_ulp(tq.row_scale.numpy(), np.asarray(jq.row_scale),
                                    maxulp=1)
    assert tivf.quantize_ivf(tq) is tq


# ---------------------------------------------------------------- K4 plain

def test_probe_span_scores_plain_matches_jax_kernel(rng):
    """The twin of tests/test_ivf.py:288: JAX's span kernel in interpret
    mode against the port's plain version (what K4 is held to)."""
    N, D, W, G = 4096, 128, 256, 9
    starts = (rng.integers(0, (N - W) // ROW_ALIGN, size=(G,)) * ROW_ALIGN
              ).astype(np.int32)
    emb8 = rng.integers(-127, 128, size=(N, D)).astype(np.int8)
    q8 = rng.integers(-127, 128, size=(G, D)).astype(np.int8)
    got = probe_span_scores(torch.from_numpy(emb8), torch.from_numpy(q8),
                            torch.from_numpy(starts), window=W)
    ref = jax_probe(jnp.asarray(emb8), jnp.asarray(q8), jnp.asarray(starts),
                    window=W, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    embf = rng.normal(size=(N, D)).astype(np.float32)
    qf = rng.normal(size=(G, D)).astype(np.float32)
    got = probe_span_scores_plain(torch.from_numpy(embf), torch.from_numpy(qf),
                                  torch.from_numpy(starts), window=W)
    ref = jax_probe(jnp.asarray(embf), jnp.asarray(qf), jnp.asarray(starts),
                    window=W, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=1e-4)

    # bf16: unit rows, q cast to the store's dtype by the caller
    embu = embf / np.linalg.norm(embf, axis=1, keepdims=True)
    qu = qf / np.linalg.norm(qf, axis=1, keepdims=True)
    eb = torch.from_numpy(embu).to(torch.bfloat16)
    qb = torch.from_numpy(qu).to(torch.bfloat16)
    got = probe_span_scores_plain(eb, qb, torch.from_numpy(starts), window=W)
    ref = jax_probe(jnp.asarray(embu, jnp.bfloat16), jnp.asarray(qu, jnp.bfloat16),
                    jnp.asarray(starts), window=W, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_probe_span_scores_plain_clamps_and_wide_int8(rng):
    """Spans running off either end read the clamped row, like the
    reference's XLA path; int8 rows wider than 1040 stay exact."""
    for N, D in ((300, 40), (50, 1100)):
        emb = rng.integers(-127, 128, size=(N, D)).astype(np.int8)
        q = rng.integers(-127, 128, size=(3, D)).astype(np.int8)
        starts = np.array([-5, N - 7, 17], np.int32)
        got = probe_span_scores_plain(torch.from_numpy(emb), torch.from_numpy(q),
                                      torch.from_numpy(starts), window=33)
        pos = np.clip(starts[:, None] + np.arange(33), 0, N - 1)
        want = np.einsum("gd,gwd->gw", q.astype(np.int64),
                         emb[pos].astype(np.int64)).astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- search

D_SEARCH = 128     # the JAX span kernel needs D % 128 == 0


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """One IVF built by JAX over two 512-row documents, carried to the
    port through the sidecar, in three store dtypes; plus the cluster-
    ordered variant for doc-equality routing."""
    rng = np.random.default_rng(0)
    x = _clustered(rng, n_clusters=8, per=128, d=D_SEARCH)
    N = len(x)
    q = x[rng.choice(N, 6)] + 0.01 * rng.normal(size=(6, D_SEARCH)).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    j = jivf.build_ivf(jnp.asarray(x), n_clusters=8, iters=8, max_list_size=256)
    rows = np.arange(N, dtype=np.int32)
    doc_id = (rows // 512).astype(np.int32)
    jidx = JaxCorpusIndex(
        emb=jnp.asarray(x), doc_id=jnp.asarray(doc_id),
        page=jnp.asarray(rows % 7 + 1), year=jnp.asarray(2020 + doc_id),
        company_id=jnp.zeros((N,), jnp.int32), kind=jnp.zeros((N,), jnp.int32),
        page_seg=jnp.asarray(rows // 3), chunk_in_doc=jnp.asarray(rows % 512),
        valid=jnp.ones((N,), bool), sparse=None,
        n_chunks=N, n_pages=N // 3, n_docs=2, dim=D_SEARCH)
    tmp = tmp_path_factory.mktemp("ivf")
    out = {}
    for name in ("float32", "bfloat16", "int8"):
        jv = j
        if name == "bfloat16":
            jv = dataclasses.replace(j, emb_perm=j.emb_perm.astype(jnp.bfloat16))
        elif name == "int8":
            jv = jivf.quantize_ivf(j)
        jidx_co, _, jv_co = jivf.cluster_order_index(jidx, None, jv)
        pair = {}
        for tag, ivf in (("flat", jv), ("co", jv_co)):
            jstore.save_ivf(tmp / f"{name}_{tag}.npz", ivf)
            pair[tag] = (ivf, tstore.load_ivf(tmp / f"{name}_{tag}.npz", device="cpu"))
        out[name] = (pair, np.array(jidx_co.doc_id))
    return x, q, out


def _routing(mode, N, pos_doc):
    ws = np.array([0, 0, 0, 512, 512, 0], np.int32)
    wl = np.array([512, 512, 512, 512, 512, 0], np.int32)       # last: invalid
    if mode == "pair_doc":
        pair_doc = np.array([0, 0, 0, 1, 1, -1], np.int32)
        return (dict(pair_doc=jnp.asarray(pair_doc), pos_doc=jnp.asarray(pos_doc)),
                dict(pair_doc=torch.from_numpy(pair_doc),
                     pos_doc=torch.from_numpy(pos_doc)))
    if mode == "win_start":
        return (dict(win_start=jnp.asarray(ws), win_len=jnp.asarray(wl)),
                dict(win_start=torch.from_numpy(ws), win_len=torch.from_numpy(wl)))
    mask = np.zeros((6, N), bool)
    for b in range(6):
        mask[b, ws[b]:ws[b] + wl[b]] = True
    return dict(mask=jnp.asarray(mask)), dict(mask=torch.from_numpy(mask))


@pytest.mark.parametrize("nprobe", [1, 4, "K"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["mask", "win_start", "pair_doc"])
def test_ivf_search_matches_jax(searched, mode, dtype, nprobe):
    x, q, out = searched
    pair, pos_doc = out[dtype]
    jv, tv = pair["co" if mode == "pair_doc" else "flat"]
    npr = tv.k_clusters if nprobe == "K" else nprobe
    jr, tr = _routing(mode, len(x), pos_doc)
    if mode == "mask" and dtype == "bfloat16":
        # the reference's kernel has no mask arm and its XLA scan scores
        # an f32 query against bf16 rows; the port casts q to bf16 like the
        # kernel, so hold it to the kernel under the equivalent row windows
        jr, _ = _routing("win_start", len(x), pos_doc)
    impl = "xla" if "mask" in jr else "pallas"
    for k in (5, 10_000):                      # 10_000 > P * W
        jvals, jrows = jivf.ivf_search(jv, jnp.asarray(q), k, nprobe=npr,
                                       impl=impl, **jr)
        tvals, trows = tivf.ivf_search(tv, torch.from_numpy(q), k, nprobe=npr, **tr)
        _same_hits(tvals, trows, jvals, jrows)
        assert (trows[5] == -1).all()          # the invalid pair finds nothing


def test_ivf_search_all_ineligible_picks_lowest_clusters(searched):
    """A query with no eligible cluster still probes clusters 0..P-1 (ties
    to the lowest id) and returns only -1 rows, as lax.top_k does."""
    x, q, out = searched
    _, tv = out["float32"][0]["flat"]
    ws = torch.zeros(6, dtype=torch.int32)
    wl = torch.zeros(6, dtype=torch.int32)
    vals, rows = tivf.ivf_search(tv, torch.from_numpy(q), 7, nprobe=3,
                                 win_start=ws, win_len=wl)
    assert (rows == -1).all() and (vals <= -1e38).all()


def test_ivf_search_guard(searched):
    x, q, out = searched
    _, tv = out["float32"][0]["flat"]
    legacy = dataclasses.replace(tv, list_row_min=None, list_row_max=None)
    ws = torch.tensor([0, 0], dtype=torch.int32)
    wl = torch.tensor([64, 64], dtype=torch.int32)
    with pytest.raises(ValueError, match="list_row_min"):
        tivf.ivf_search(legacy, torch.from_numpy(q[:2]), 5, nprobe=4,
                        win_start=ws, win_len=wl)
    with pytest.raises(ValueError, match="pos_doc"):
        tivf.ivf_search(tv, torch.from_numpy(q[:2]), 5,
                        pair_doc=torch.tensor([0, 1], dtype=torch.int32))


# ---------------------------------------------------------------- cluster order

def _corpus_pair(x, doc_id, n_docs):
    N = len(x)
    rows = np.arange(N, dtype=np.int32)
    cols = dict(doc_id=doc_id, page=rows % 7 + 1, year=2020 + doc_id,
                company_id=np.zeros(N, np.int32), kind=np.zeros(N, np.int32),
                page_seg=rows // 3, chunk_in_doc=rows % 100)
    stat = dict(sparse=None, n_chunks=N, n_pages=N // 3, n_docs=n_docs,
                dim=x.shape[1])
    jidx = JaxCorpusIndex(emb=jnp.asarray(x), valid=jnp.ones((N,), bool),
                          **{k: jnp.asarray(v.astype(np.int32)) for k, v in cols.items()},
                          **stat)
    tidx = CorpusIndex(emb=torch.from_numpy(x), valid=torch.ones(N, dtype=torch.bool),
                       **{k: torch.from_numpy(v.astype(np.int32)) for k, v in cols.items()},
                       **stat)
    return jidx, tidx


@pytest.mark.parametrize("doc_div,n_docs", [(512, 2), (100, 2)])
def test_cluster_order_index_matches_jax(rng, tmp_path, doc_div, n_docs):
    """Twins of tests/test_ivf.py:353 (doc equality == mask routing) and
    :399 (doc ids >= n_docs are never eligible, and do not crash)."""
    x = _clustered(rng, n_clusters=8, per=128, d=D_SEARCH)
    doc_id = (np.arange(len(x)) // doc_div).astype(np.int32)
    jidx, tidx = _corpus_pair(x, doc_id, n_docs)
    j = jivf.build_ivf(jnp.asarray(x), n_clusters=8, iters=8, max_list_size=256)
    jstore.save_ivf(tmp_path / "ivf.npz", j)
    t = tstore.load_ivf(tmp_path / "ivf.npz", device="cpu")
    jidx_co, _, j_co = jivf.cluster_order_index(jidx, None, j)
    tidx_co, _, t_co = tivf.cluster_order_index(tidx, None, t)
    _same_ivf(t_co, j_co)
    for f in ("doc_id", "page", "year", "company_id", "kind", "page_seg",
              "chunk_in_doc", "valid"):
        np.testing.assert_array_equal(getattr(tidx_co, f).numpy(),
                                      np.asarray(getattr(jidx_co, f)), err_msg=f)
    assert tidx_co.emb is t_co.emb_perm
    pair_doc = np.array([0, 0, 1, 1, -1, 5], np.int32)
    qq = x[:6]
    jv, jr = jivf.ivf_search(j_co, jnp.asarray(qq), 5, nprobe=8,
                             pair_doc=jnp.asarray(pair_doc),
                             pos_doc=jidx_co.doc_id, impl="pallas")
    tv_, tr = tivf.ivf_search(t_co, torch.from_numpy(qq), 5, nprobe=8,
                              pair_doc=torch.from_numpy(pair_doc),
                              pos_doc=tidx_co.doc_id)
    _same_hits(tv_, tr, jv, jr)
    doc_perm = tidx_co.doc_id.numpy()
    for b in range(4):
        got = tr[b][tr[b] >= 0].numpy()
        assert got.size and (doc_perm[got] == pair_doc[b]).all()
    # -1 finds nothing; an id past n_docs probes no eligible cluster but
    # still matches its own rows by equality, as in the reference
    assert (tr[4] == -1).all()


# ---------------------------------------------------------------- sidecars

@pytest.mark.parametrize("variant", ["float32", "bfloat16", "int8", "cluster_order"])
def test_sidecar_round_trips_both_ways(rng, tmp_path, variant):
    x = _clustered(rng, n_clusters=4, per=64, d=D_SEARCH)
    j = jivf.build_ivf(jnp.asarray(x), n_clusters=4, iters=5, max_list_size=80)
    if variant == "bfloat16":
        j = dataclasses.replace(j, emb_perm=j.emb_perm.astype(jnp.bfloat16))
    elif variant == "int8":
        j = jivf.quantize_ivf(j)
    elif variant == "cluster_order":
        jidx, _ = _corpus_pair(x, (np.arange(len(x)) // 128).astype(np.int32), 2)
        _, _, j = jivf.cluster_order_index(jidx, None, j)
    jstore.save_ivf(tmp_path / "j.npz", j, fingerprint="fp1")
    assert tstore.load_ivf(tmp_path / "j.npz", expect_fingerprint="other",
                           device="cpu") is None
    t = tstore.load_ivf(tmp_path / "j.npz", expect_fingerprint="fp1", device="cpu")
    _same_ivf(t, j)
    assert (t.row_scale is None) == (j.row_scale is None)
    if t.row_scale is not None:
        np.testing.assert_array_equal(t.row_scale.numpy(), np.asarray(j.row_scale))
    tstore.save_ivf(tmp_path / "t.npz", t, fingerprint="fp2")
    back = jstore.load_ivf(tmp_path / "t.npz", expect_fingerprint="fp2")
    _same_ivf(t, back)
    assert back.emb_perm.dtype == j.emb_perm.dtype
    assert tstore.load_ivf(tmp_path / "missing.npz") is None


def test_legacy_sidecar_loads_with_no_layout_contract(rng, tmp_path):
    x = _clustered(rng, n_clusters=4, per=32, d=16)
    t = tivf.build_ivf(torch.from_numpy(x), n_clusters=4, iters=3)
    tstore.save_ivf(tmp_path / "s.npz", t)
    with np.load(tmp_path / "s.npz") as z:
        arrays = {k: z[k] for k in z.files}
    import json

    statics = json.loads(str(arrays.pop("__statics__")))
    del statics["list_align"], statics["dma_pad_rows"]
    np.savez(tmp_path / "legacy.npz", __statics__=json.dumps(statics), **arrays)
    back = tstore.load_ivf(tmp_path / "legacy.npz", device="cpu")
    assert back.list_align == 0 and back.dma_pad_rows == 0
    jback = jstore.load_ivf(tmp_path / "legacy.npz")
    assert jback.list_align == 0 and jback.dma_pad_rows == 0
