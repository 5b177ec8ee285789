"""The command line's options on the CPU: ``query --use-ivf`` writes the
``<index>.ivf.npz`` sidecar, reuses it while the index file is unchanged,
and rebuilds it when the index file's fingerprint changes;
``--quantize-int8`` serves from the int8 variant of the index and
``--scan-rt`` is accepted; ``--method`` runs the traversal methods and
prints ``materialize_details`` as one more JSON line."""

import json
import os

import numpy as np
import pytest
import torch

from rag_challenge_2_tpu_torch import cli
from rag_challenge_2_tpu_torch.index import build_corpus_index, save_index
from rag_challenge_2_tpu_torch.index.store import index_fingerprint, load_ivf
from rag_challenge_2_tpu_torch.retrieval.engine import QueryEngine
from tests.conftest import make_reports


@pytest.fixture
def saved_index(tmp_path):
    # the CLI's encoder is full width: 1024-wide rows
    reports, embs = make_reports(np.random.default_rng(0), dim=1024)
    idx, meta = build_corpus_index(reports, embs, vocab_bits=16, device="cpu")
    path = tmp_path / "idx.npz"
    save_index(path, idx, meta)
    return path


def _query(path, *extra):
    return cli.main(["query", "--index", str(path), "--company", "金盘科技",
                     "--question", "2024年营业收入是多少", "--device", "cpu",
                     "--top-n", "3", *extra])


def test_query_use_ivf_writes_reuses_and_rebuilds_the_sidecar(
        saved_index, monkeypatch, capsys):
    builds = []
    real_build = QueryEngine.build_ivf

    def counting_build(self, *a, **kw):
        builds.append(1)
        return real_build(self, *a, **kw)

    monkeypatch.setattr(QueryEngine, "build_ivf", counting_build)
    sidecar = saved_index.parent / "idx.npz.ivf.npz"
    _query(saved_index, "--use-ivf", "--ivf-nprobe", "4")
    first = capsys.readouterr().out.splitlines()
    assert sidecar.exists() and len(builds) == 1 and len(first) == 3
    fp = index_fingerprint(saved_index)
    assert load_ivf(sidecar, expect_fingerprint=fp, device="cpu") is not None

    _query(saved_index, "--use-ivf", "--ivf-nprobe", "4")    # reused
    assert len(builds) == 1
    assert capsys.readouterr().out.splitlines() == first

    _query(saved_index, "--use-ivf", "--cluster-order")      # reused, reordered
    assert len(builds) == 1 and len(capsys.readouterr().out.splitlines()) == 3

    st = saved_index.stat()                                   # the index changes
    os.utime(saved_index, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    _query(saved_index, "--use-ivf")
    assert len(builds) == 2
    assert load_ivf(sidecar, expect_fingerprint=index_fingerprint(saved_index),
                    device="cpu") is not None
    assert load_ivf(sidecar, expect_fingerprint=fp, device="cpu") is None


def test_query_quantize_int8_and_scan_rt(saved_index, monkeypatch, capsys):
    from rag_challenge_2_tpu_torch.index import store

    seen = []
    real = store.quantize_index

    def spying(idx):
        out = real(idx)
        seen.append(out.emb.dtype)
        return out

    monkeypatch.setattr(store, "quantize_index", spying)
    _query(saved_index, "--use-bm25")
    f32 = capsys.readouterr().out.splitlines()
    _query(saved_index, "--use-bm25", "--quantize-int8", "--scan-rt", "0.95")
    i8 = capsys.readouterr().out.splitlines()
    assert seen == [torch.int8] and len(i8) == len(f32) == 3
    # int8 scores sit within the quantization error of the f32 ones
    for a, b in zip(f32, i8):
        assert abs(float(a[1:7]) - float(b[1:7])) < 0.02
    _query(saved_index, "--quantize-int8", "--use-ivf")   # the IVF dequantizes for k-means
    assert len(capsys.readouterr().out.splitlines()) == 3


@pytest.mark.parametrize("method", ["ssg", "triangulation", "hybrid_expansion"])
def test_query_method_prints_hits_and_details(saved_index, capsys, method):
    _query(saved_index, "--method", method, "--max-hops", "2", "--neighbor-k", "4",
           "--use-bm25")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(ln.startswith("[") for ln in lines[:3])
    details = json.loads(lines[3])
    rd = details["retrieval_details"]
    assert rd["method"] == method and rd["max_hops"] == 2 and rd["neighbor_k"] == 4
    infos = rd["traversal_info"]
    assert infos and all(len(t["hops"]) <= 2 and t["path"][0] == t["anchor"]["idx"]
                         for t in infos)
    assert all(len(h["candidates"]) <= 5 for t in infos for h in t["hops"])
    if method == "hybrid_expansion":
        ac = details["algorithm_contribution"]
        assert ac["basic_retrieval_count"] == 24       # the two routed docs' chunks
        assert ac["ssg_stats"]["total_expanded"] > 0
    else:
        assert details["algorithm_contribution"] is None


def test_query_method_on_the_int8_index_and_unknown_method(saved_index, capsys):
    _query(saved_index, "--method", "hybrid_expansion", "--quantize-int8",
           "--max-hops", "2", "--neighbor-k", "4")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and json.loads(lines[3])["retrieval_details"]["traversal_info"]
    _query(saved_index)                                # basic: hits only
    assert len(capsys.readouterr().out.splitlines()) == 3
    with pytest.raises(SystemExit):
        _query(saved_index, "--method", "random_walk")
