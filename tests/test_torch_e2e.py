"""The port's end-to-end eval (``eval/e2e.py``) held against the JAX
package's, on the CPU: the PDF writer and the fixture byte for byte, the
golden questions and the extractive answerer equal, and the whole slice
(parse → merge → chunk → encode + BM25 → index → routed hybrid query →
two-stage answer → scorer) answering every golden question as the JAX
package does, with each package's narrow encoder on the same weights: per
question the same answer, score and page hit."""

import json

import pytest

import rag_challenge_2_tpu.eval.e2e as J
import rag_challenge_2_tpu.ingestion.splitter as jax_splitter
import rag_challenge_2_tpu_torch.eval.e2e as T
import rag_challenge_2_tpu_torch.ingestion.splitter as port_splitter
from tests.test_torch_ingestion import assert_same_dirs, twin_encoders


@pytest.fixture(autouse=True)
def heuristic_tokens(monkeypatch):
    for mod in (jax_splitter, port_splitter):
        monkeypatch.setattr(mod, "_encoding", lambda: None)


def test_fixture_matches_jax(tmp_path):
    assert T.fixture_docs() == J.fixture_docs()
    assert T.GOLDEN_QA == J.GOLDEN_QA and len(T.GOLDEN_QA) == 17
    for doc in T.fixture_docs():
        assert T.write_pdf(doc["pages"]) == J.write_pdf(doc["pages"])
    T.build_fixture(tmp_path / "port")
    J.build_fixture(tmp_path / "jax")
    assert_same_dirs(tmp_path / "port" / "pdf_reports", tmp_path / "jax" / "pdf_reports")
    for f in ("subset.csv", "questions.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


CTX = ('上下文:\n"""\nText retrieved from page 3: \n"""\n{}\n"""\n"""\n\n---\n\n'
       '问题:\n"{}"\n')


@pytest.mark.parametrize("system,block,question", [
    ("本题要求返回一个数值。", "与营收无关的治理信息。", "某公司2023年营业收入是多少亿元？"),
    ("本题要求返回一个数值。", "2024年公司实现营业收入151.02亿元。", "某公司2024年营业收入是多少亿元？"),
    ("判断题", "公司2023年度不进行现金分红。", "某公司2023年是否进行现金分红？"),
    ("名称列表", "公司主要产品包括干式变压器、箱式变电站等，形成了体系。", "某公司的主要产品有哪些？"),
    ("", "候选页面 2024年营业收入", "问题: 某公司2024年营业收入是多少？"),
])
def test_extractive_stub_matches_jax(system, block, question):
    human = CTX.format(block, question)
    if system == "":
        human = block + "\n" + question
    got = T.ExtractiveStubProvider()._complete("m", system, human, 0)
    assert got == J.ExtractiveStubProvider()._complete("m", system, human, 0)
    json.loads(got)


def test_run_e2e_matches_jax(tmp_path):
    """The whole slice in both packages: a narrow encoder (d_model 64, 2
    layers, out_dim 128) on the same flax-initialised weights, BM25 fused.
    Every golden question gets the same answer, score and page hit."""
    jm, tm = twin_encoders()
    got = T.run_e2e(tmp_path / "port", embedder=tm.embed, device="cpu")
    want = J.run_e2e(tmp_path / "jax", embedder=jm.embed)
    assert got["n"] == want["n"] == 17
    assert got["per_question"] == want["per_question"]
    assert (got["value_accuracy"], got["page_hit"]) == \
        (want["value_accuracy"], want["page_hit"]) == (1.0, 1.0)


@pytest.mark.slow
def test_run_e2e_full_pipeline(tmp_path):
    """The port's own default: the full-width encoder (max_len 128) with
    seeded random weights, on the CPU; the golden set answered essentially
    perfectly, as the JAX package's ``test_run_e2e_full_pipeline`` asks."""
    res = T.run_e2e(tmp_path, device="cpu")
    assert res["n"] == len(T.GOLDEN_QA)
    assert res["page_hit"] >= 0.9, res["per_question"]
    assert res["value_accuracy"] >= 0.9, [
        q for q in res["per_question"] if q["score"] < 1.0]
