"""The engine's ``triangulation`` method against the JAX engine (every
tier and option, bf16 / int8 stores, ``search_many``), and the checks
that hold every method: the details' order by tier, planted neighbours,
hops through ``dense_topk``, an unknown method
(``tests/torch_engine_traversal_common.py`` has the shared bodies)."""

import numpy as np
import pytest
import torch

import rag_challenge_2_tpu_torch.retrieval.engine as engine_mod
from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
from tests import torch_engine_traversal_common as common
from tests.conftest import make_reports
from tests.test_torch_engine import _q_for
from tests.torch_engine_traversal_common import (  # noqa: F401  (a fixture)
    OPTIONS, TIERS, drop_compiled_programs, make_engines, set_tier)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("method", ["triangulation"])
def test_traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option):
    common.traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option)


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", ["triangulation"])
def test_traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method,
                                             tier, store):
    common.traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method, tier, store)


@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", ["triangulation"])
def test_traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch,
                                                       method, tier, R):
    common.traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch, method, tier, R)


@pytest.mark.parametrize("tier", TIERS)
def test_details_order_follows_the_tier(tmp_path, rng, monkeypatch, tier):
    """Walkers come slot-major where the JAX engine's traversal is windowed
    and query-major where it is not, and materialize_details shows it.  The
    cap decides that order alone: a windowed corpus walks views of the
    store whatever the cap, only ``window == 0`` hops under row masks."""
    je, te, embs = make_engines(tmp_path)
    slot_major = set_tier(je, te, tier, monkeypatch)
    cfg = SearchConfig(method="ssg", top_k=5, top_n=40, max_hops=2, neighbor_k=5)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    calls = []
    for name in ("traverse_windowed", "traverse"):
        def counted(*a, _real=getattr(engine_mod, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(engine_mod, name, counted)
    _, d = te.search(q, "金盘科技", cfg=cfg, with_details=True)
    assert set(calls) == {"traverse" if tier == "window0" else "traverse_windowed"}
    Q, M = cfg.max_queries, cfg.max_docs
    want = (np.tile(np.arange(Q), M) if slot_major else np.repeat(np.arange(Q), M))
    np.testing.assert_array_equal(d["trav_qids"].numpy(), want)
    info = te.materialize_details(d, cfg)["retrieval_details"]
    anchors = [t["anchor"]["idx"] for t in info["traversal_info"]]
    # 2 queries x 2 routed docs of 12 rows: the anchors' documents
    docs = [a // 12 for a in anchors]
    assert docs == ([0, 0, 1, 1] if slot_major else [0, 1, 0, 1])
    assert info["method"] == "ssg" and info["max_hops"] == 2


def test_planted_neighbours_are_reached(tmp_path):
    """A chain of near-duplicates of one chunk: ssg from that chunk walks
    the chain, and hybrid_expansion reports the chain's far end as new."""
    rng = np.random.default_rng(3)
    reports, embs = make_reports(rng, n_docs=2, companies=("金盘科技",) * 2,
                                 years=(2023, 2024), pages_per_doc=20, dim=64)
    base = embs[0][4].copy()
    chain = [4, 30, 41, 52]
    for step, row in enumerate(chain[1:], 1):
        # each link is closer to the next than to the one before the last:
        # similarity along the chain rises, so SSG keeps stepping
        v = base + (0.5 - 0.12 * step) * rng.normal(size=64) / 8
        embs[0][row] = (v / np.linalg.norm(v)).astype(np.float32)
    from rag_challenge_2_tpu_torch.index import build_corpus_index

    idx, meta = build_corpus_index(reports, embs, vocab_bits=16, device="cpu")
    te = QueryEngine(idx, meta)
    cfg = SearchConfig(method="ssg", top_k=5, top_n=30, max_hops=4, neighbor_k=10)
    cands, d = te.search(embs[0][4][None], "金盘科技", selected_years=[2023], cfg=cfg,
                         with_details=True)
    path = d["trav"].path[d["trav"].path[:, 0] == 4][0].tolist()
    assert path[0] == 4 and set(path[1:]) & set(chain[1:])
    rows = {r["rep_row"] for r in te.materialize(cands, cfg)}
    assert set(p for p in path if p >= 0) <= rows


def test_hops_go_through_dense_topk(tmp_path, rng, monkeypatch):
    """On an f32 store every hop of the windowed and of the full-corpus
    tier is a dense_topk call with a row-shared mask (the path that
    launches K1 / K3 on the card); an int8 store's hops never are."""
    import rag_challenge_2_tpu_torch.retrieval.traversal as tv

    calls = []
    real = tv.dense_topk

    def spy(q, emb, k, mask=None, **kw):
        calls.append((q.shape[0], emb.shape[0], k, None if mask is None else mask.dim()))
        return real(q, emb, k, mask=mask, **kw)

    monkeypatch.setattr(tv, "dense_topk", spy)
    je, te, embs = make_engines(tmp_path)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    cfg = SearchConfig(method="hybrid_expansion", top_k=5, top_n=30, max_hops=3,
                       neighbor_k=5)
    te.search(q, "金盘科技", cfg=cfg)
    Q = cfg.max_queries
    # 2 routed slots x (3 ssg hops of Q*10 walkers + 3 tri hops of Q*20), 12-row views
    assert sorted(calls) == sorted(
        [(Q * 10, 12, 6, None)] * 6 + [(Q * 20, 12, 6, None)] * 6)
    calls.clear()
    te.window = 0
    te.search(q, "金盘科技", cfg=cfg)
    n_pad = te.index.n_pad
    assert sorted(calls) == sorted(
        [(Q * 10, n_pad, 6, 1)] * 6 + [(Q * 20, n_pad, 6, 1)] * 6)
    calls.clear()
    _, te8, _ = make_engines(tmp_path, "int8")
    te8.search(q, "金盘科技", cfg=cfg)
    assert calls == []


def test_unknown_method_raises_value_error(tmp_path, rng):
    _, te, embs = make_engines(tmp_path)
    q = _q_for(embs, 0, 0, rng)
    for call in (lambda c: te.search(q, "金盘科技", cfg=c),
                 lambda c: te.search_many([q], "金盘科技", cfg=c)):
        with pytest.raises(ValueError, match="unknown method"):
            call(SearchConfig(method="graph"))
    assert te.materialize_details({}, SearchConfig()) == {
        "retrieval_details": None, "algorithm_contribution": None}
    cands, d = te.search(q, "金盘科技", cfg=SearchConfig(top_k=3), with_details=True)
    assert d == {} and (cands.key >= 0).any()
    assert torch.is_tensor(cands.key)
