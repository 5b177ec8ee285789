"""The port's encoder quality eval (``eval/encoder_quality.py``) held against
the JAX package's on the CPU.

The datasets and the metric are host copies: equal corpora, queries,
supervised pairs and metrics from the same seeds.  The scorers run the
port's BM25 and served engine: ``eval_bm25`` equals the JAX one exactly,
and ``eval_dense``, ``eval_hybrid`` and ``eval_hybrid_e2e`` equal the JAX
ones exactly when both get the same numpy embed function (a text's CRC
seeds its vector, so no two texts tie unless they are equal).  A tiny
``run_quality_eval`` runs every arm on the CPU."""

import zlib

import numpy as np
import pytest

import rag_challenge_2_tpu.eval.encoder_quality as J
import rag_challenge_2_tpu_torch.eval.encoder_quality as T


def crc_embed(dim=32):
    def embed(texts):
        out = np.stack([np.random.default_rng(zlib.crc32(t.encode())).normal(size=dim)
                        for t in texts]).astype(np.float32)
        return out / np.linalg.norm(out, axis=1, keepdims=True)
    return embed


@pytest.mark.parametrize("build,kw", [
    ("build_dataset", dict(seed=0)),
    ("build_dataset", dict(seed=3, n_eval=40, chunks_per_fact=3)),
    ("build_dataset_v2", dict()),
    ("build_dataset_v2", dict(seed=1, n_eval=25)),
])
def test_datasets_equal_jax(build, kw):
    a, b = getattr(T, build)(**kw), getattr(J, build)(**kw)
    for field in ("chunk_texts", "fact_of_chunk", "train_facts", "eval_facts",
                  "queries", "gold_fact", "fact_tuples"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.gold_rows(a.gold_fact[0]) == b.gold_rows(b.gold_fact[0])


def test_constants_and_paraphrase_pairs_equal_jax():
    for name in ("COMPANIES", "YEARS", "METRICS", "_CHUNK_TEMPLATES", "_QUERY_TEMPLATES",
                 "_SEGMENTS", "_DIRECTIONS", "_GLOSSARY_TEMPLATE", "COMPANIES_V2",
                 "METRICS_V2", "_CHUNK_TEMPLATES_V2", "_QUERY_TEMPLATES_V2",
                 "_SEGMENTS_V2", "_GLOSSARY_TEMPLATE_V2"):
        assert getattr(T, name) == getattr(J, name), name
    ds_t, ds_j = T.build_dataset(seed=1), J.build_dataset(seed=1)
    assert T.paraphrase_pairs(ds_t, 64, np.random.default_rng(0)) == \
        J.paraphrase_pairs(ds_j, 64, np.random.default_rng(0))
    v2_t, v2_j = T.build_dataset_v2(), J.build_dataset_v2()
    assert T.paraphrase_pairs(v2_t, 32, np.random.default_rng(2), T.METRICS_V2,
                              T._QUERY_TEMPLATES_V2) == \
        J.paraphrase_pairs(v2_j, 32, np.random.default_rng(2), J.METRICS_V2,
                           J._QUERY_TEMPLATES_V2)


def test_retrieval_metrics_equal_jax():
    ds_t, ds_j = T.build_dataset(n_eval=30, seed=2), J.build_dataset(n_eval=30, seed=2)
    scores = np.random.default_rng(0).random((30, len(ds_t.chunk_texts))).astype(np.float32)
    scores[:, ds_t.gold_rows(ds_t.gold_fact[0])] += 0.5
    assert T.retrieval_metrics(scores, ds_t) == J.retrieval_metrics(scores, ds_j)
    assert T.retrieval_metrics(scores, ds_t, k=3) == J.retrieval_metrics(scores, ds_j, k=3)


def test_eval_bm25_equals_jax():
    ds_t, ds_j = T.build_dataset(seed=0), J.build_dataset(seed=0)
    got, want = T.eval_bm25(ds_t, device="cpu"), J.eval_bm25(ds_j)
    assert got == want and got["hit@10"] >= 0.8


def test_eval_dense_equals_jax():
    ds_t, ds_j = T.build_dataset(seed=4), J.build_dataset(seed=4)
    embed = crc_embed()
    assert T.eval_dense(embed, ds_t) == J.eval_dense(embed, ds_j)


@pytest.mark.parametrize("fuse", [dict(), dict(fuse_mode="max", dense_weight=1.0)],
                         ids=["sum", "max"])
def test_eval_hybrid_equals_jax(fuse):
    """200 stacked single-query requests through ``QueryEngine.search_many``
    (on a card: kernel K3 for the dense arm, K2 for BM25).  Some chunks of
    this corpus have mathematically equal BM25 scores: the port's f64
    per-row totals keep them tied (and order them by row), the JAX
    package's f32 running sums split them by rounding, so single rankings
    may differ in the order of such pairs; the metrics over these 200
    queries agree exactly."""
    ds_t, ds_j = T.build_dataset(seed=0), J.build_dataset(seed=0)
    embed = crc_embed()
    got = T.eval_hybrid(embed, ds_t, device="cpu", **fuse)
    assert got == J.eval_hybrid(embed, ds_j, **fuse)
    assert got["hit@10"] > 0.5                    # BM25 carries it


def per_call_embed(dim=64):
    """Like :func:`crc_embed`, but a text's vector also depends on the
    index of the call that embeds it.  The e2e fixture repeats paragraphs
    between a company's two annual reports, and each report is embedded
    in its own call, so repeated paragraphs no longer tie: the JAX
    package's fusion orders tied candidates by an unstable sort
    (``jax.lax.sort``), the port's by a stable one."""
    calls = []

    def embed(texts):
        calls.append(len(texts))
        out = np.stack([np.random.default_rng([zlib.crc32(t.encode()), len(calls)])
                        .normal(size=dim) for t in texts]).astype(np.float32)
        return out / np.linalg.norm(out, axis=1, keepdims=True)
    return embed


@pytest.mark.parametrize("use_bm25", [True, False])
def test_eval_hybrid_e2e_equals_jax(use_bm25):
    got = T.eval_hybrid_e2e(per_call_embed(), use_bm25=use_bm25, device="cpu")
    assert got == J.eval_hybrid_e2e(per_call_embed(), use_bm25=use_bm25)


def test_tiny_run_quality_eval():
    """Every arm on the CPU at a narrow width and a few steps: the keys of
    the JAX package's result, the BM25 arm equal to ``eval_bm25``, each
    metric a fraction; the ablation arms may run fewer steps than the
    default recipe."""
    from rag_challenge_2_tpu_torch.models.encoder import EncoderConfig

    lines = []
    res = T.run_quality_eval(
        ict_steps=3, supervised_steps=2, batch_size=8, seed=0,
        enc_cfg=EncoderConfig(vocab_bits=10, d_model=32, n_layers=1, n_heads=2,
                              d_ff=64, max_len=32, out_dim=16),
        log=lines.append, device="cpu", ablation_steps=2)
    assert set(res) == {
        "bm25", "encoder_random_init", "hybrid_random_init", "encoder_ict",
        "encoder_unsupervised", "encoder_bm25_distill", "encoder_alias_distill",
        "hybrid_alias_distill", "encoder_bm25_listwise", "encoder_ict_supervised"}
    assert res["bm25"] == T.eval_bm25(T.build_dataset(seed=0), device="cpu")
    for arm, m in res.items():
        assert set(m) == {"hit@10", "mrr"} and 0.0 <= m["hit@10"] <= 1.0, arm
    assert any("removal-only ICT 2 steps" in ln for ln in lines)
    assert any("(the default) 3 steps" in ln for ln in lines)
