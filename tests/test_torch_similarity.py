"""``eval/similarity.py`` against the JAX package's: the chunk-to-chunk
matrix within 1e-5 on f32 and bf16 stores and 1e-4 on an int8 store; the
statistics and the written artifacts equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from rag_challenge_2_tpu.eval import similarity as jsim
from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import quantize_index as jax_quantize_index
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu_torch.eval import similarity as tsim
from rag_challenge_2_tpu_torch.index import load_index
from tests.conftest import make_reports


def both(tmp_path, store):
    reports, embs = make_reports(np.random.default_rng(0))
    idx, meta = jax_build(reports, embs, vocab_bits=16,
                          **({"dtype": jnp.bfloat16} if store == "bfloat16" else {}))
    if store == "int8":
        idx = jax_quantize_index(idx)
    jax_save(tmp_path / "idx.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "idx.npz", device="cpu")
    return (idx, meta), (tidx, tmeta)


@pytest.mark.parametrize("doc", [0, 2])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8"])
def test_similarity_matrix_matches_jax(tmp_path, store, doc):
    (idx, meta), (tidx, tmeta) = both(tmp_path, store)
    tol = 1e-4 if store == "int8" else 1e-5
    M = tsim.similarity_matrix(tidx, doc)
    want = jsim.similarity_matrix(idx, doc)
    assert M.shape == want.shape == (meta.docs[doc].n_chunks,) * 2 and M.dtype == np.float32
    np.testing.assert_allclose(M, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(np.diag(M), 1.0, atol=2e-2 if store != "float32" else 1e-4)
    assert tsim.matrix_stats(M) == pytest.approx(jsim.matrix_stats(want), abs=2e-4)
    with pytest.raises(ValueError, match="no chunks"):
        tsim.similarity_matrix(tidx, 99)


def test_analyze_document_writes_the_same_artifacts(tmp_path):
    (idx, meta), (tidx, tmeta) = both(tmp_path, "float32")
    ts = tsim.analyze_document(tidx, tmeta, 0, output_dir=tmp_path / "t")
    js = jsim.analyze_document(idx, meta, 0, output_dir=tmp_path / "j")
    sha = meta.docs[0].sha1
    assert ts["sha1"] == js["sha1"] == sha and ts["n_chunks"] == js["n_chunks"]
    for k in ("mean_similarity", "max_similarity", "min_similarity", "p90_similarity"):
        assert ts[k] == pytest.approx(js[k], abs=2e-4)
    a = np.load(tmp_path / "t" / f"similarity_{sha}.npz")["matrix"]
    b = np.load(tmp_path / "j" / f"similarity_{sha}.npz")["matrix"]
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    html = tmp_path / "t" / f"similarity_{sha}.html"
    assert ts["heatmap"] == str(html)
    body = html.read_text(encoding="utf-8")
    assert "<canvas" in body or "plotly" in body.lower()
    assert (tmp_path / "t" / f"similarity_{sha}.stats.json").exists()
    assert "heatmap" not in tsim.analyze_document(tidx, tmeta, 1)


def test_canvas_heatmap_downsamples_large_matrices(tmp_path):
    rng = np.random.default_rng(0)
    M = rng.uniform(-1, 1, size=(700, 700)).astype(np.float32)
    tsim._write_canvas_heatmap(M, tmp_path / "t.html", "t", max_cells=256)
    jsim._write_canvas_heatmap(M, tmp_path / "j.html", "t", max_cells=256)
    body = (tmp_path / "t.html").read_text(encoding="utf-8")
    assert body == (tmp_path / "j.html").read_text(encoding="utf-8")
    assert "N=256" in body.replace(" ", "") and len(body) < 400_000


def test_similarity_is_the_graph_the_traversal_walks(tmp_path):
    """An SSG hop from chunk c goes to the largest off-path entry of row c
    of the document's similarity matrix."""
    import torch

    from rag_challenge_2_tpu_torch.retrieval.traversal import traverse

    _, (tidx, _) = both(tmp_path, "float32")
    M = tsim.similarity_matrix(tidx, 0)
    n = M.shape[0]
    res = traverse(tidx.emb[:n], torch.arange(n), tidx.emb[:n].clone(), None,
                   max_hops=1, neighbor_k=5, mode="ssg")
    off = M - 2 * np.eye(n, dtype=np.float32)
    np.testing.assert_array_equal(res.path[:, 1].numpy(), off.argmax(1))
