"""Row-range-sharded BM25 (``parallel/sharded_sparse.py``) against the
single-device port, the JAX package (``tests/test_sharded_sparse.py``'s
twins) and an f64 host oracle.

The partition is bitwise the JAX package's.  Sharded results equal the
single-device port's: ``ok`` and rows equal, values within rtol 1e-4 /
atol 1e-5 (the twin's tolerance).  Against the JAX package, values agree
within the BM25 tests' tolerance and rows where they are clear of ties:
the JAX package orders tied totals by an unstable sort (ROADMAP C).  The
tie rule itself is pinned by an oracle: per-(query, row) totals in
float64, ranked with ties to the lowest row, on a corpus of 160 chunks a
document whose chunks tie by the dozen.

The one-process form (``mesh=None``, all shards stacked) runs here; the
one-shard-a-rank form in a gloo world (``run_ranks``, rank programs in
``tests/torch_ranks.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.ops.bm25 import encode_queries_host
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu.parallel.sharded_sparse import (
    shard_sparse_index as jax_shard, sharded_bm25_topk as jax_sharded_bm25)
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu_torch.index import load_index
from rag_challenge_2_tpu_torch.ops.bm25 import bm25_topk
from rag_challenge_2_tpu_torch.parallel import launch
from rag_challenge_2_tpu_torch.parallel.sharded_sparse import (
    from_jax_sharded_sparse, shard_sparse_index, sharded_bm25_topk)
from rag_challenge_2_tpu_torch.retrieval import QueryEngine
from rag_challenge_2_tpu_torch.retrieval import SearchConfig as TorchCfg
from tests import torch_ranks
from tests.conftest import make_reports
from tests.test_torch_engine import _q_for, assert_same_results

QUERIES = ["金盘科技 营业收入", "页面2 chunk4", "doc1 营业收入 chunk17", "",
           "chunk11 页面4 doc2"]


def _corpus(tmp_path, **shape):
    reports, embs = make_reports(np.random.default_rng(0), **shape)
    idx, meta = jax_build(reports, embs, vocab_bits=16)
    jax_save(tmp_path / "idx.npz", idx, meta)
    tidx, _ = load_index(tmp_path / "idx.npz", device="cpu")
    return idx, meta, tidx, embs, tmp_path / "idx.npz"


def _routes(tidx, M=3):
    doc = tidx.doc_id.numpy()
    valid = tidx.valid.numpy()
    masks = np.stack([valid & (doc == d) for d in range(M)])
    slot = np.full(doc.shape, M, np.int32)
    ws = np.zeros(M, np.int32)
    wl = np.zeros(M, np.int32)
    for d in range(M):
        slot[masks[d]] = d
        rows = np.flatnonzero(masks[d])
        ws[d], wl[d] = rows[0], len(rows)
    return masks, slot, ws, wl


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The twin's corpus (3 docs x 12 chunks) in both packages."""
    idx, meta, tidx, embs, path = _corpus(tmp_path_factory.mktemp("tiny"))
    qt = encode_queries_host(QUERIES, 32, idx.sparse.vocab_bits)
    masks, slot, ws, wl = _routes(tidx)
    return idx, meta, tidx, embs, path, qt, masks, slot


def _port(res):
    return tuple(a.numpy() for a in res)


def assert_same_as_single(got, want):
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)


def assert_like_jax(got, jres):
    """ok equal, values within the BM25 tests' tolerance, rows equal where
    the value is clear of its neighbours (a tie may go either way there)."""
    jv, jr, jok = (np.asarray(a) for a in jres)
    v, r, ok = got
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-4)
    gap = np.minimum(np.abs(np.diff(jv, axis=-1, prepend=np.inf)),
                     np.abs(np.diff(jv, axis=-1, append=-np.inf)))
    sure = jok & (gap > 2e-4)
    sure[..., -1] = False               # the cut-off: its next value is not kept
    np.testing.assert_array_equal(r[sure], jr[sure])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_partition_equals_jax(tiny, n_shards):
    """Array for array the JAX partition; a JAX index carried across
    searches as the port's own."""
    idx, _, tidx, _, _, qt, masks, slot = tiny
    j = jax_shard(idx.sparse, n_shards)
    t = shard_sparse_index(tidx.sparse, n_shards)
    for f in ("indptr", "chunk_ids", "tf", "dl", "df", "chunk_len", "avgdl"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
        assert getattr(t, f).numpy().dtype == np.asarray(getattr(j, f)).dtype
    assert (t.max_postings, t.n_shards, t.vocab_bits) == (
        j.max_postings, j.n_shards, j.vocab_bits)
    arrays = {f: np.asarray(getattr(j, f)) for f in (
        "indptr", "chunk_ids", "tf", "dl", "df", "chunk_len", "avgdl")}
    arrays.update(vocab_bits=j.vocab_bits, max_postings=j.max_postings,
                  n_shards=j.n_shards)
    carried = from_jax_sharded_sparse(arrays, device="cpu")
    args = (torch.from_numpy(qt), torch.from_numpy(masks), 5)
    for a, b in zip(sharded_bm25_topk(carried, *args), sharded_bm25_topk(t, *args)):
        assert torch.equal(a, b)


def test_shard_partition_covers_all_postings(tiny):
    _, _, tidx, *_ = tiny
    ss = shard_sparse_index(tidx.sparse, 4)
    nnz = int(tidx.sparse.indptr[-1])
    per_shard = ss.indptr[:, -1].numpy()
    assert per_shard.sum() == nnz
    counts = np.diff(tidx.sparse.indptr.numpy())
    np.testing.assert_array_equal(np.diff(ss.indptr.numpy(), axis=1).sum(0), counts)
    rows_per = -(-tidx.n_pad // 4)
    for s in range(4):
        ids = ss.chunk_ids[s, : per_shard[s]].numpy()
        assert ((ids // rows_per).clip(max=3) == s).all()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_bm25_matches_single_device(tiny, n_shards):
    idx, _, tidx, _, _, qt, masks, slot = tiny
    args = (torch.from_numpy(qt), torch.from_numpy(masks), 5)
    got = _port(sharded_bm25_topk(shard_sparse_index(tidx.sparse, n_shards), *args,
                                  row_slot=torch.from_numpy(slot)))
    assert_same_as_single(got, _port(bm25_topk(tidx.sparse, *args,
                                               row_slot=torch.from_numpy(slot))))
    jres = jax_sharded_bm25(jax_shard(idx.sparse, n_shards), jnp.asarray(qt),
                            jnp.asarray(masks), 5, row_slot=jnp.asarray(slot))
    assert_like_jax(got, jres)


def test_sharded_bm25_scan_path_no_row_slot(tiny):
    idx, _, tidx, _, _, qt, masks, _ = tiny
    args = (torch.from_numpy(qt), torch.from_numpy(masks), 5)
    got = _port(sharded_bm25_topk(shard_sparse_index(tidx.sparse, 4), *args))
    assert_same_as_single(got, _port(bm25_topk(tidx.sparse, *args)))
    assert_like_jax(got, jax_sharded_bm25(jax_shard(idx.sparse, 4), jnp.asarray(qt),
                                          jnp.asarray(masks), 5))


# ---- the tie rule: an f64 host oracle on a corpus of tied chunks

def oracle_topk(sparse, qt, masks, k, k1=1.5, b=0.75):
    """Per-document BM25 top-k by definition: each (query, row) total summed
    in float64 over the query's terms and the row's postings, rows ranked
    by (-total rounded to f32, row) — ties to the lowest row — among the
    doc's rows with a positive total.  Returns (values, rows, ok) like
    ``bm25_topk``."""
    indptr = sparse.indptr.numpy().astype(np.int64)
    ids = sparse.chunk_ids.numpy()
    tf = sparse.tf.numpy().astype(np.float64)
    df = sparse.df.numpy().astype(np.float64)
    clen = sparse.chunk_len.numpy().astype(np.float64)
    avgdl = float(sparse.avgdl.numpy().reshape(-1)[0])
    n = max(float((clen > 0).sum()), 1.0)
    M, N = masks.shape
    B = qt.shape[0]
    vals = np.zeros((M, B, k), np.float32)
    rows = np.full((M, B, k), -1, np.int32)
    for bq in range(B):
        total = np.zeros(N, np.float64)
        for t in qt[bq]:
            if t < 0:
                continue
            idf = np.log1p((n - df[t] + 0.5) / (df[t] + 0.5))
            for p in range(indptr[t], indptr[t + 1]):
                r = ids[p]
                total[r] += idf * tf[p] * (k1 + 1) / (
                    tf[p] + k1 * (1 - b + b * clen[r] / avgdl))
        key = total.astype(np.float32)
        for m in range(M):
            cand = np.flatnonzero(masks[m] & (total > 0))
            order = cand[np.lexsort((cand, -key[cand]))][:k]
            vals[m, bq, : len(order)] = key[order]
            rows[m, bq, : len(order)] = order
    return vals, rows, rows >= 0


@pytest.fixture(scope="module")
def tied(tmp_path_factory):
    """20 pages x 8 chunks a document: chunks of one length and the same
    query terms tie exactly, so a cut-off at k = 12 falls inside a group."""
    idx, meta, tidx, embs, path = _corpus(tmp_path_factory.mktemp("tied"),
                                          pages_per_doc=20, chunks_per_page=8)
    qt = encode_queries_host(QUERIES, 32, idx.sparse.vocab_bits)
    masks, slot, ws, wl = _routes(tidx)
    want = oracle_topk(tidx.sparse, qt, masks, 12)
    return tidx, path, qt, masks, slot, ws, wl, want


def _assert_oracle(got, want):
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["win_start", "row_slot", "scan"])
def test_bm25_tie_rule_against_oracle(tied, mode):
    """``bm25_topk`` in its three modes, and ``sharded_bm25_topk`` over 2,
    4 and 8 shards in its two, equal the oracle: ties to the lowest row."""
    tidx, _, qt, masks, slot, ws, wl, want = tied
    v, r, ok = want
    assert ok.sum() > 0
    # the cut-off falls inside tied groups: the rule decides these rows
    assert (v[..., -1] == v[..., -2])[ok[..., -1]].any()
    kw = dict(row_slot=torch.from_numpy(slot)) if mode == "row_slot" else (
        dict(win_start=torch.from_numpy(ws), win_len=torch.from_numpy(wl))
        if mode == "win_start" else {})
    args = (torch.from_numpy(qt), torch.from_numpy(masks), 12)
    _assert_oracle(_port(bm25_topk(tidx.sparse, *args, **kw)), want)
    if mode == "win_start":
        return                          # the sharded form routes by row_slot
    for S in (2, 4, 8):
        _assert_oracle(_port(sharded_bm25_topk(shard_sparse_index(tidx.sparse, S),
                                               *args, **kw)), want)


@pytest.fixture(scope="module")
def world_bm25(tiny, tied):
    """One 4-rank world: one shard a rank, the twin's corpus and the tied
    one, with and without row_slot."""
    _, _, _, _, tiny_path, tqt, tmasks, tslot = tiny
    _, tied_path, qt, masks, slot, _, _, _ = tied
    a = launch.run_ranks(torch_ranks.bm25_cases, 4, "gloo", "cpu", (str(tiny_path), [
        (tqt, tmasks, 5, tslot), (tqt, tmasks, 5, None)]))
    b = launch.run_ranks(torch_ranks.bm25_cases, 4, "gloo", "cpu", (str(tied_path), [
        (qt, masks, 12, slot), (qt, masks, 12, None)]))
    return a, b


@pytest.mark.parametrize("mode", ["row_slot", "scan"])
def test_sharded_bm25_one_shard_a_rank(tiny, tied, world_bm25, mode):
    """Each rank searches its shard and the all-gather merge gives every
    rank the one-process result, bitwise, and the oracle's."""
    i = ["row_slot", "scan"].index(mode)
    _, _, tidx, _, _, qt, masks, slot = tiny
    kw = dict(row_slot=torch.from_numpy(slot)) if mode == "row_slot" else {}
    stacked = _port(sharded_bm25_topk(shard_sparse_index(tidx.sparse, 4),
                                      torch.from_numpy(qt), torch.from_numpy(masks), 5,
                                      **kw))
    for a, b in zip(world_bm25[0][i], stacked):
        np.testing.assert_array_equal(a, b)
    _assert_oracle(world_bm25[1][i], tied[-1])


@pytest.fixture(scope="module")
def sparse_engine(tiny):
    """The twin's engine test: the dense store row-sharded and the CSR
    sharded beside it, one shard a rank (a 2 x 2 world)."""
    idx, meta, tidx, embs, path, *_ = tiny
    rng = np.random.default_rng(5)
    qs = (_q_for(embs, 0, 5, rng),
          np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)]))
    calls = [(q, years, kw, texts) for kw in ENGINE_CFGS.values()
             for years in (None, [2024]) for q in qs
             for texts in (["营业收入"], ["营业收入 chunk5", "页面3 chunk7 金盘科技"])]
    got = launch.run_ranks(torch_ranks.engine_cases, 4, "gloo", "cpu",
                           (str(path), {"slice": 2, "device": 2}, True, None, calls))
    return calls, got


ENGINE_CFGS = {
    "basic_bm25": dict(method="basic", top_k=5, top_n=40, use_bm25=True),
    "bm25_k5_sum": dict(method="basic", top_k=5, top_n=40, use_bm25=True,
                        bm25_top_k=5, fuse_mode="sum", dense_weight=0.5),
}


@pytest.mark.parametrize("name", list(ENGINE_CFGS))
def test_engine_hybrid_with_fully_sharded_index(tiny, sparse_engine, name):
    """QueryEngine over a row-sharded store and a ShardedSparseIndex equals
    the single-device port engine and the JAX engine over its sharded
    index (GSPMD places the row store, the CSR stacks 8 shards)."""
    idx, meta, tidx, _, path, *_ = tiny
    calls, got = sparse_engine
    single = QueryEngine(tidx, load_index(path, device="cpu")[1])
    mesh = jax_mesh({"data": 8})
    jidx = dataclasses.replace(
        idx, emb=jax.device_put(idx.emb, NamedSharding(mesh, P("data", None))),
        valid=jax.device_put(idx.valid, NamedSharding(mesh, P("data"))),
        sparse=jax_shard(idx.sparse, 8, mesh=mesh))
    jeng = JaxEngine(jidx, meta)
    for (q, years, kw, texts), res in zip(calls, got):
        if kw != ENGINE_CFGS[name]:
            continue
        tc, jc = TorchCfg(**kw), JaxCfg(**kw)
        want = single.materialize(single.search(q, "金盘科技", "营业收入", years, tc,
                                                query_texts=texts), tc)
        assert res and any(r["method_count"] == 2 for r in res)
        assert_same_results(res, want)
        if kw.get("bm25_top_k", 30) < 12:
            continue                    # a BM25 cut-off inside tied rows: ROADMAP C
        jres = jeng.materialize(jeng.search(q, "金盘科技", "营业收入", years, jc,
                                            query_texts=texts), jc)
        assert_same_results(res, jres)
