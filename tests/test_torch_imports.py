"""The PyTorch port stands alone: it never reaches jax, flax or the JAX
package, nor pandas, click or tiktoken, which the card's machine may lack
(a search, a question answered through the QA layer and a report taken
through the pipeline's stages with those blocked), and its host copies
(tokenizer, SearchConfig) equal the originals."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# every module of the port, plus a tiny CPU search, one answered question
# and one report through the pipeline's stages, through the public API
_NO_JAX_PROGRAM = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "rag_challenge_2_tpu", "pandas", "click",
           "tiktoken")
for name in BLOCKED:
    sys.modules[name] = None          # any import of these now fails
import pkgutil, importlib
import numpy as np
import rag_challenge_2_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
from rag_challenge_2_tpu_torch.index import build_corpus_index
from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
rng = np.random.default_rng(0)
reports = []
embs = []
for d, year in enumerate((2023, 2024)):
    chunks = [{"page": 1, "text": f"doc{d} 营业收入 chunk{i}", "id": i,
               "type": "content"} for i in range(6)]
    reports.append({"metainfo": {"sha1_name": f"J{year}_doc{d}",
                                 "company_name": "金盘科技", "year": year},
                    "content": {"pages": [{"page": 1, "text": "p"}],
                                "chunks": chunks}})
    e = rng.normal(size=(6, 16)).astype(np.float32)
    embs.append(e / np.linalg.norm(e, axis=1, keepdims=True))
idx, meta = build_corpus_index(reports, embs, vocab_bits=12, device="cpu")
eng = QueryEngine(idx, meta)
cfg = SearchConfig(top_k=3, top_n=5, use_bm25=True)
res = eng.materialize(eng.search(embs[1][2:3], "金盘科技", "营业收入",
                                 selected_years=[2024], cfg=cfg,
                                 query_texts=["chunk2"]), cfg)
assert res[0]["rep_row"] == 8, res
# the QA layer on the same engine: a stub LLM answers one question
import json
from rag_challenge_2_tpu_torch.llm import LLMFacade, LLMReranker, RateLimiter, StubProvider
from rag_challenge_2_tpu_torch.qa import QAConfig, QuestionsProcessor
stub = StubProvider({"上下文": json.dumps({
    "step_by_step_analysis": "s", "reasoning_summary": "r",
    "relevant_pages": [1], "final_answer": 68.9})})
rr = LLMReranker(stub)
rr.rate_limiter = RateLimiter(0)
proc = QuestionsProcessor(eng, lambda texts: np.repeat(embs[1][2:3], len(texts), 0),
                          LLMFacade(stub), rr,
                          QAConfig(use_bm25=True, llm_reranking=True))
ans = proc.process_question("金盘科技2024年营业收入是多少", "number")
assert ans["final_answer"] == 68.9 and ans["references"], ans
assert json.loads(json.dumps(ans))["final_answer"] == 68.9
# the pipeline's stages on one text report (subset.csv read without pandas)
import tempfile
from pathlib import Path
from rag_challenge_2_tpu_torch.pipeline import Pipeline, configs
root = Path(tempfile.mkdtemp())
(root / "pdf_reports").mkdir()
(root / "pdf_reports" / "J2024_jp.txt").write_text(
    "金盘科技2024年年报\n\n营业收入为68.9亿元\f第二页：研发费用3.2亿元", encoding="utf-8")
(root / "subset.csv").write_text("sha1,company_name,year\nJ2024_jp,金盘科技,2024\n",
                                 encoding="utf-8")
pipe = Pipeline(root, configs["offline"], device="cpu",
                embedder=lambda texts: np.repeat(embs[0][:1], len(texts), 0))
pipe.parse_pdf_reports()
pipe.process_parsed_reports()
from rag_challenge_2_tpu_torch.index import load_index
pidx, pmeta = load_index(pipe.paths.index_path, device="cpu")
assert pmeta.docs[0].company == "金盘科技" and pmeta.docs[0].year == 2024
assert pidx.n_chunks >= 2, pidx.n_chunks
bad = [m for m in sys.modules
       if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_PROGRAM], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_port_sources_name_no_jax():
    """No module of the port imports jax, flax or the JAX package."""
    offenders = []
    for path in (ROOT / "rag_challenge_2_tpu_torch").rglob("*.py"):
        for line in path.read_text(encoding="utf-8").splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")) and any(
                f" {name}" in s.replace(".", " ")
                for name in ("jax", "flax", "rag_challenge_2_tpu")
            ) and "rag_challenge_2_tpu_torch" not in s:
                offenders.append(f"{path.name}: {s}")
    assert not offenders, offenders


def test_search_config_matches_reference():
    from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
    from rag_challenge_2_tpu_torch.retrieval.engine import SearchConfig

    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(SearchConfig) == spec(JaxCfg)


TEXTS = [
    "金盘科技2023年营业收入为66.68亿元",
    "ＡＢＣ Revenue grew 12.5% YoY; 净利润 5.03 亿",
    "宁德时代 CATL 2024年 研发投入",
    "",
    "   mixed 中文English混排 v2.0 ﹣ 〇 㐀 豈",
    "第三季度 Q3 EBITDA margin 0.25",
]


@pytest.mark.parametrize("vocab_bits", [10, 16, 20])
def test_tokenizer_ids_match_reference(vocab_bits):
    from rag_challenge_2_tpu.utils import tokenize as jt
    from rag_challenge_2_tpu_torch.utils import tokenize as tt

    assert tt.TOKENIZER_VERSION == jt.TOKENIZER_VERSION == "fnv1a64-cjk12-v1"
    for text in TEXTS:
        assert tt.tokenize(text) == jt.tokenize(text)
        assert tt.token_ids(text, vocab_bits) == jt.token_ids(text, vocab_bits)


def test_native_query_ids_match_python_path():
    """The port's build of the C++ tokenizer gives the pure-Python ids."""
    from rag_challenge_2_tpu_torch.utils import native, tokenize as tt

    out = native.tokenize_queries_native(TEXTS, 16, 64)
    if out is None:
        pytest.skip("no C++ toolchain: the pure-Python path is the only one")
    for i, text in enumerate(TEXTS):
        ids = tt.token_ids(text, 16)[:64]
        assert out[i, : len(ids)].tolist() == ids
        assert (out[i, len(ids):] == -1).all()
