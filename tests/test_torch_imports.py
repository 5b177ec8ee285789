"""The PyTorch port stands alone: it never reaches jax, flax or the JAX
package, nor pandas, click or tiktoken, which the card's machine may lack
(a search, a question answered through the QA layer, a report taken
through the pipeline's stages, an encoder pretrained and saved, the
quality eval's BM25 arm, and a two-rank world of the sharded search,
with those blocked in every process), and its host copies
(tokenizer, SearchConfig, the timing and profiling helpers) equal the
originals."""

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
# training: a narrow encoder pretrained two steps, saved and loaded; the
# quality eval's BM25 arm; the timing and profiling helpers
from rag_challenge_2_tpu_torch.eval.encoder_quality import build_dataset, eval_bm25
from rag_challenge_2_tpu_torch.models import (
    EncoderConfig, PretrainConfig, load_params, pretrain_encoder, save_params)
from rag_challenge_2_tpu_torch.utils.profiling import annotate, device_trace
from rag_challenge_2_tpu_torch.utils.timing import StageTimer, timed
timer = StageTimer()
with device_trace(root / "trace", "pretrain"), timer.stage("pretrain"):
    model, info = pretrain_encoder(
        [t for t in meta.chunk_texts if len(t) >= 8] * 4,
        enc_cfg=EncoderConfig(vocab_bits=10, d_model=32, n_layers=1, n_heads=2,
                              d_ff=64, max_len=32, out_dim=16),
        pre_cfg=PretrainConfig(steps=2, batch_size=4, min_span=4), device="cpu")
assert len(info["history"]) == 2 and timer.as_dict()["pretrain"] > 0
assert (root / "trace" / "pretrain.json").exists()
save_params(model, root / "enc.npz")
assert load_params(model, root / "enc.npz").embed(["营业收入"]).shape == (1, 16)
assert eval_bm25(build_dataset(n_eval=10), device="cpu")["hit@10"] > 0
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


_BLOCKER = """import sys
for name in ("jax", "jaxlib", "flax", "rag_challenge_2_tpu"):
    sys.modules[name] = None          # any import of these now fails
"""

_NO_JAX_WORLD = r"""
import sys
assert sys.modules["jax"] is None     # sitecustomize ran
from rag_challenge_2_tpu_torch.parallel import launch
from tests import torch_ranks, torch_train_ranks
if __name__ == "__main__":
    every = launch.run_ranks(torch_ranks.no_jax, 2, "gloo", "cpu")
    for mods, rows, blocked in every:
        assert mods == [] and blocked == ["flax", "jax", "jaxlib",
                                          "rag_challenge_2_tpu"], (mods, blocked)
    assert every[0][1] == every[1][1]
    # the parallel train step's rank programs: a MoE step on data 2
    cfg = dict(vocab_bits=8, d_model=16, n_layers=2, n_heads=2, d_ff=32, max_len=16,
               out_dim=8, moe_experts=2)
    r = launch.run_ranks(torch_train_ranks.init_world, 2, "gloo", "cpu",
                         (cfg, dict(sequence_parallel=True), {"data": 2}, 0))
    assert r["every"][0] == r["every"][1]
    assert torch_ranks.jax_modules() == []
    print("OK")
"""


def test_rank_programs_never_import_jax(tmp_path):
    """A two-rank gloo world of the parallel package with jax, flax and the
    JAX package blocked in the parent AND in each rank: every interpreter
    of the run starts with the blocker (a ``sitecustomize`` on its path),
    imports the whole port and runs a sharded search, then a world of the
    parallel train step's rank programs (a MoE step)."""
    (tmp_path / "sitecustomize.py").write_text(_BLOCKER)
    (tmp_path / "world.py").write_text(_NO_JAX_WORLD)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, str(tmp_path / "world.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_parallel_names_match_reference():
    """The JAX package's ``parallel`` names, those of the parallel train
    step (``pipeline_forward``, ``encoder_param_spec``, ``shard_params``)
    included, exist in the port."""
    import rag_challenge_2_tpu.parallel as jp
    import rag_challenge_2_tpu_torch.parallel as tp

    names = {n for n in vars(jp) if not n.startswith("_")}
    names -= {m for m in names if type(getattr(jp, m)).__name__ == "module"}
    assert {"pipeline_forward", "encoder_param_spec", "shard_params"} <= names
    assert names <= set(vars(tp)), names - set(vars(tp))


def test_models_names_match_reference():
    """The JAX package's ``models`` names, ``MoEFFN`` included, exist in the
    port."""
    import rag_challenge_2_tpu.models as jm
    import rag_challenge_2_tpu_torch.models as tm

    names = {n for n in vars(jm) if not n.startswith("_")}
    names -= {m for m in names if type(getattr(jm, m)).__name__ == "module"}
    assert "MoEFFN" in names
    assert names <= set(vars(tm)), names - set(vars(tm))


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


def test_timing_and_profiling_names_match_reference(tmp_path):
    """The JAX package's ``utils/timing`` and ``utils/profiling`` names
    exist in the port with the same signatures; ``block_on`` waits for a
    tensor's device (nothing to wait for on the CPU) and ``device_trace``
    writes a Chrome trace holding the named regions."""
    import inspect
    import json

    import torch

    from rag_challenge_2_tpu.utils import profiling as jp, timing as jt
    from rag_challenge_2_tpu_torch.utils import profiling as tp, timing as tt

    for jmod, tmod, names in ((jt, tt, ("StageTimer", "timed")),
                              (jp, tp, ("device_trace", "annotate"))):
        for name in names:
            a, b = getattr(tmod, name), getattr(jmod, name)
            if inspect.isclass(b):
                assert [m for m in vars(b) if not m.startswith("__")] == \
                    [m for m in vars(a) if not m.startswith("__")], name
                for m in ("stage", "record", "as_dict"):
                    assert inspect.signature(getattr(a, m)) == \
                        inspect.signature(getattr(b, m)), (name, m)
            else:
                assert inspect.signature(a) == inspect.signature(b), name

    timer = tt.StageTimer()
    x = torch.ones(4)
    for _ in range(2):
        with timer.stage("a", block_on=[x, {"y": x}]):
            x = x * 2
    timer.record("b", 0.5)
    assert set(timer.as_dict()) == {"a", "b"} and timer.as_dict()["b"] == 0.5
    out = {}
    with tt.timed(out, "t", block_on=x):
        pass
    with tt.timed(None, "ignored"):
        pass
    assert list(out) == ["t"] and out["t"] >= 0.0

    with tp.device_trace(tmp_path, "outer"):
        with tp.annotate("inner"):
            torch.ones(8).sum()
    names = {e.get("name") for e in json.loads(
        (tmp_path / "outer.json").read_text())["traceEvents"]}
    assert {"outer", "inner"} <= names
