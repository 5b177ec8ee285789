"""Index build and persistence: the port against the JAX package.

Every array of the port's build equals the JAX build exactly (same numpy
code up to the final tensors), and an index saved by either package
loads in the other with identical arrays and metadata."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import load_index as jax_load
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu_torch.index import build_corpus_index, load_index, save_index
from tests.conftest import make_reports

DENSE = ("doc_id", "page", "year", "company_id", "kind", "page_seg",
         "chunk_in_doc", "valid")
SPARSE = ("indptr", "chunk_ids", "tf", "df", "chunk_len", "avgdl", "dl")
STATIC = ("n_chunks", "n_pages", "n_docs", "dim")

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _emb_np(emb):
    """Row store as comparable bits: f32 values, bf16 raw uint16."""
    if isinstance(emb, torch.Tensor):
        if emb.dtype == torch.bfloat16:
            return emb.view(torch.int16).numpy().view(np.uint16)
        return emb.numpy()
    a = np.asarray(emb)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def assert_same_index(jidx, tidx):
    np.testing.assert_array_equal(_emb_np(jidx.emb), _emb_np(tidx.emb))
    for name in DENSE:
        np.testing.assert_array_equal(
            np.asarray(getattr(jidx, name)), getattr(tidx, name).numpy(),
            err_msg=name)
    for name in STATIC:
        assert getattr(jidx, name) == getattr(tidx, name), name
    js, ts = jidx.sparse, tidx.sparse
    for name in SPARSE:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("vocab_bits", "max_postings", "dma_pad"):
        assert getattr(js, name) == getattr(ts, name), name


def assert_same_meta(jm, tm):
    assert [dataclasses.asdict(d) for d in jm.docs] == \
        [dataclasses.asdict(d) for d in tm.docs]
    assert jm.companies == tm.companies
    assert jm.chunk_texts == tm.chunk_texts
    assert jm.page_texts == tm.page_texts
    assert [tuple(p) for p in jm.page_seg_info] == \
        [tuple(p) for p in tm.page_seg_info]


@pytest.mark.parametrize("cap", [None, 4096, 3])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_build_matches_jax(rng, dtypes, cap):
    """CSR (with the posting cap), dma_pad, dl, columns and meta equal the
    JAX build; cap=3 truncates the common terms' lists."""
    reports, embs = make_reports(rng)
    jidx, jmeta = jax_build(reports, embs, vocab_bits=16, dtype=dtypes[0],
                            max_postings_per_term=cap)
    tidx, tmeta = build_corpus_index(reports, embs, vocab_bits=16,
                                     dtype=dtypes[1],
                                     max_postings_per_term=cap, device="cpu")
    assert_same_index(jidx, tidx)
    assert_same_meta(jmeta, tmeta)
    if cap == 3:
        assert tidx.sparse.max_postings == 3


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_jax_saved_index_loads_in_port(rng, tmp_path, dtypes):
    reports, embs = make_reports(rng)
    jidx, jmeta = jax_build(reports, embs, vocab_bits=16, dtype=dtypes[0])
    jax_save(tmp_path / "idx.npz", jidx, jmeta)
    tidx, tmeta = load_index(tmp_path / "idx.npz", device="cpu")
    assert tidx.emb.dtype == dtypes[1]
    assert_same_index(jidx, tidx)
    assert_same_meta(jmeta, tmeta)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_port_saved_index_loads_in_jax(rng, tmp_path, dtypes):
    reports, embs = make_reports(rng)
    tidx, tmeta = build_corpus_index(reports, embs, vocab_bits=16,
                                     dtype=dtypes[1], device="cpu")
    save_index(tmp_path / "idx.npz", tidx, tmeta)
    jidx, jmeta = jax_load(tmp_path / "idx.npz")
    assert jidx.emb.dtype == dtypes[0]
    assert_same_index(jidx, tidx)
    assert_same_meta(jmeta, tmeta)
    # and back into the port unchanged
    tidx2, tmeta2 = load_index(tmp_path / "idx.npz", device="cpu")
    assert_same_index(jidx, tidx2)
    assert_same_meta(tmeta, tmeta2)


def test_to_device_moves_every_tensor(rng):
    reports, embs = make_reports(rng)
    tidx, _ = build_corpus_index(reports, embs, vocab_bits=16, device="cpu")
    moved = tidx.to("cpu")
    assert moved is not tidx and moved.sparse is not tidx.sparse
    assert moved.n_pad == tidx.n_pad and moved.device.type == "cpu"
    assert torch.equal(moved.sparse.dl, tidx.sparse.dl)
