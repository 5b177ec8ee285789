"""The command line's IVF option on the CPU: ``query --use-ivf`` writes the
``<index>.ivf.npz`` sidecar, reuses it while the index file is unchanged,
and rebuilds it when the index file's fingerprint changes."""

import os

import numpy as np
import pytest

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
