"""``retrieval/sparse.BM25Retriever`` against the JAX package's on one
corpus: the same hits (rows, pages, texts) with scores within 1e-5."""

import numpy as np
import pytest

from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.retrieval.sparse import BM25Retriever as JaxBM25
from rag_challenge_2_tpu_torch.index import build_corpus_index, load_index
from rag_challenge_2_tpu_torch.retrieval.sparse import BM25Retriever
from tests.conftest import make_reports


@pytest.fixture
def retrievers(tiny_corpus, tmp_path):
    idx, meta, reports, _ = tiny_corpus
    jax_save(tmp_path / "idx.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "idx.npz", device="cpu")
    return JaxBM25(idx, meta), BM25Retriever(tidx, tmeta), reports


def assert_same_hits(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose([r["distance"] for r in got],
                               [r["distance"] for r in want], rtol=1e-5, atol=1e-5)
    i = 0
    while i < len(want):                   # tied scores compare as sets
        j = i + 1
        while j < len(want) and abs(want[j]["distance"] - want[j - 1]["distance"]) <= 2e-5:
            j += 1
        key = lambda r: (r["source_sha1"], r["page"], r["text"], r["source_year"])  # noqa: E731
        assert sorted(map(key, got[i:j])) == sorted(map(key, want[i:j]))
        i = j


@pytest.mark.parametrize("parent_pages", [False, True])
@pytest.mark.parametrize("years", [None, [2024], [2019]])
@pytest.mark.parametrize("top_n", [3, 40])
def test_bm25_retriever_matches_jax(retrievers, parent_pages, years, top_n):
    jr, tr, reports = retrievers
    for text in (reports[0]["content"]["chunks"][2]["text"], "页面3 chunk7", "营业收入"):
        kw = dict(top_n=top_n, return_parent_pages=parent_pages, selected_years=years)
        got = tr.retrieve_by_company_name("金盘科技", text, **kw)
        want = jr.retrieve_by_company_name("金盘科技", text, **kw)
        assert got
        assert_same_hits(got, want)
        assert {"distance", "page", "text", "source_sha1", "source_year",
                "rep_row"} == set(got[0])


def test_bm25_retriever_standalone(retrievers):
    _, tr, reports = retrievers
    text = reports[0]["content"]["chunks"][2]["text"]
    out = tr.retrieve_by_company_name("金盘科技", text, top_n=3)
    assert out and out[0]["rep_row"] == 2
    out_p = tr.retrieve_by_company_name("金盘科技", text, top_n=3,
                                        return_parent_pages=True)
    assert out_p and out_p[0]["page"] == reports[0]["content"]["chunks"][2]["page"]
    with pytest.raises(ValueError, match="No report found"):
        tr.retrieve_by_company_name("不存在", text)
    # routing: another company's chunks never come back
    assert all(r["source_sha1"] != "J2023_doc2" for r in
               tr.retrieve_by_company_name("金盘科技", "营业收入", top_n=100))
    assert tr.retrieve_by_company_name("金盘科技", "?!") == []


def test_bm25_retriever_needs_a_sparse_index():
    reports, embs = make_reports(np.random.default_rng(0))
    idx, meta = build_corpus_index(reports, embs, vocab_bits=16, device="cpu")
    idx.sparse = None
    with pytest.raises(ValueError, match="sparse"):
        BM25Retriever(idx, meta)
