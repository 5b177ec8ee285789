"""The engine's ``hybrid_expansion`` method against the JAX engine: every
tier and option, wide k, and the ``use_ivf`` basic block
(``tests/torch_engine_traversal_common.py`` has the shared bodies)."""

import numpy as np
import pytest

from rag_challenge_2_tpu_torch.retrieval import QueryEngine
from tests import torch_engine_traversal_common as common
from tests.test_torch_engine import _q_for, assert_same_results
from tests.torch_engine_traversal_common import (  # noqa: F401  (a fixture)
    OPTIONS, TIERS, assert_same_details, both_search, drop_compiled_programs,
    make_engines, set_tier)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("method", ["hybrid_expansion"])
def test_traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option):
    common.traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option)


@pytest.mark.parametrize("route", ["plain", "wide"])
@pytest.mark.parametrize("method", ["hybrid_expansion"])
def test_traversal_neighbor_k_100_matches_jax(tmp_path, rng, monkeypatch, method, route):
    common.traversal_neighbor_k_100_matches_jax(tmp_path, rng, monkeypatch, method, route)


@pytest.mark.parametrize("tier", ["windowed", "window0"])
def test_hybrid_expansion_with_use_ivf(tmp_path, rng, monkeypatch, tier):
    """use_ivf serves the basic block (and so the anchors) through the
    probe; the hops stay exact.  Both engines share one IVFIndex."""
    from rag_challenge_2_tpu.index.store import save_ivf as jax_save_ivf
    from rag_challenge_2_tpu_torch.index import load_ivf

    je, te, embs = make_engines(tmp_path)
    jax_save_ivf(tmp_path / "idx.ivf.npz", je.build_ivf(iters=5))
    te.ivf = load_ivf(tmp_path / "idx.ivf.npz", device="cpu")
    set_tier(je, te, tier, monkeypatch)
    kw = dict(method="hybrid_expansion", top_k=5, top_n=80 + TIERS.index(tier),
              max_hops=3, neighbor_k=5, use_ivf=True, use_bm25=True, bm25_top_k=12)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    (jc, jcands, jd), (tc, tcands, td) = both_search(je, te, q, kw)
    assert_same_results(te.materialize(tcands, tc), je.materialize(jcands, jc))
    assert_same_details(td, jd, 1e-5, f"hybrid ivf {tier}")
    with pytest.raises(ValueError, match="build_ivf"):
        QueryEngine(te.index, te.meta).search(q, "金盘科技", cfg=tc)
