"""The QA layer as a whole: the JAX package's ``QuestionsProcessor`` over
its engine and the port's over its CPU engine, on one corpus built and
saved by the JAX package and loaded by the port, with the same embedder
and the same scripted stub LLM.  Their outputs must be equal, ``timing``
excepted: scores within 1e-5 (f32 sums in other orders), everything else
exact, every prompt the stub received included.

The corpus is built so that no retrieval score ties: each chunk has its
own length (distinct BM25 document lengths) and a random embedding, and
the embedder maps a text to a chunk's direction plus noise seeded by
``zlib.crc32`` of the text.  Prompts hold pages and texts in retrieval
order, so equal prompts need equal order, not only equal sets."""

import dataclasses
import json
import zlib

import numpy as np
import pytest

import rag_challenge_2_tpu.llm as jllm
import rag_challenge_2_tpu_torch.llm as tllm
from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.qa import QAConfig as JaxQAConfig
from rag_challenge_2_tpu.qa import QuestionsProcessor as JaxProcessor
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu_torch.index import load_index
from rag_challenge_2_tpu_torch.qa import QAConfig, QuestionsProcessor
from rag_challenge_2_tpu_torch.retrieval import QueryEngine

TOL = 1e-5
DIM = 64
DOCS = (("金盘科技", 2023), ("金盘科技", 2024), ("宁德时代", 2023))
METRICS = ("营业收入", "净利润", "毛利率", "研发投入", "海外收入", "现金分红")


def make_corpus(seed=0, pages=4, per_page=3):
    """Reports in the chunked-report contract; chunk c of the corpus
    carries c filler words, so no two chunks share a BM25 length."""
    rng = np.random.default_rng(seed)
    reports, embs, c = [], [], 0
    for d, (company, year) in enumerate(DOCS):
        chunks = []
        for p in range(pages):
            for i in range(per_page):
                words = [METRICS[int(j)] for j in rng.integers(0, len(METRICS), 3)]
                filler = " ".join(f"w{c}x{j}" for j in range(c))
                chunks.append({"page": p + 1, "id": p * per_page + i, "type": "content",
                               "text": f"{company}{year}年 页面{p + 1} {''.join(words)} {filler}"})
                c += 1
        page_objs = [{"page": p + 1, "text": f"{company}{year} 第{p + 1}页 全文"}
                     for p in range(pages)]
        reports.append({
            "metainfo": {"sha1_name": f"S{year}_doc{d}", "company_name": company,
                         "year": year},
            "content": {"pages": page_objs, "chunks": chunks},
        })
        e = rng.normal(size=(len(chunks), DIM)).astype(np.float32)
        embs.append(e / np.linalg.norm(e, axis=1, keepdims=True))
    return reports, embs


def make_embedder(embs):
    flat = np.concatenate(embs)

    def embedder(texts):
        out = np.zeros((len(texts), DIM), np.float32)
        for i, t in enumerate(texts):
            h = zlib.crc32(t.encode("utf-8"))
            noise = np.random.default_rng(h).normal(size=DIM).astype(np.float32)
            v = flat[h % flat.shape[0]] + 0.3 * noise / np.linalg.norm(noise)
            out[i] = v / np.linalg.norm(v)
        return out

    return embedder


def answer_json(final=68.9, pages=(3,)):
    return json.dumps({
        "step_by_step_analysis": "一二三四五步骤" * 10,
        "reasoning_summary": "总结",
        "relevant_pages": list(pages),
        "final_answer": final,
    }, ensure_ascii=False)


SCRIPT = {
    "候选页面": json.dumps({"selected_pages": [1, 2], "reasoning": "相关"},
                         ensure_ascii=False),
    "上下文": answer_json(),
    # reranking: 4 blocks a batch, distinct relevance by position
    "文本块集合": json.dumps({"block_rankings": [
        {"reasoning": f"r{i}", "relevance_score": s}
        for i, s in enumerate((0.9, 0.35, 0.6, 0.75))]}, ensure_ascii=False),
    "文本块:": json.dumps({"reasoning": "r", "relevance_score": 0.8}, ensure_ascii=False),
    "原始问题": json.dumps({"sub_questions": [
        {"question": "金盘科技2023年营业收入是多少", "reasoning": "r"},
        {"question": "宁德时代2023年营业收入是多少", "reasoning": "r"},
    ]}, ensure_ascii=False),
    # expansion
    "虚构": "| 指标 | 数值 |\n|营业收入|68.9亿元|",
    "同义指标名": "<金盘科技营业收入 名词解释：营收>\n<金盘科技主营业务收入>",
    "子问题": "<金盘科技2023年净利润>",
    "标准答案": json.dumps({"score": 1.0, "reasoning": "一致", "is_correct": True},
                       ensure_ascii=False),
}


@pytest.fixture(scope="module")
def qa_corpus(tmp_path_factory):
    reports, embs = make_corpus()
    idx, meta = jax_build(reports, embs, vocab_bits=16)
    path = tmp_path_factory.mktemp("qa") / "idx.npz"
    jax_save(path, idx, meta)
    tidx, tmeta = load_index(path, device="cpu")
    return (idx, meta), (tidx, tmeta), make_embedder(embs)


def build_pair(qa_corpus, jcfg=None, script=SCRIPT, reranker=True):
    """(JAX processor, its stub), (port processor, its stub) on the same
    corpus, embedder and script; ``jcfg`` is a dict of QAConfig fields."""
    (idx, meta), (tidx, tmeta), embedder = qa_corpus
    out = []
    for llm, Proc, Cfg, eng in ((jllm, JaxProcessor, JaxQAConfig, JaxEngine(idx, meta)),
                                (tllm, QuestionsProcessor, QAConfig,
                                 QueryEngine(tidx, tmeta))):
        stub = llm.StubProvider(dict(script))
        rr = None
        if reranker:
            rr = llm.LLMReranker(stub)
            rr.rate_limiter = llm.RateLimiter(0)
        out.append((Proc(eng, embedder, llm.LLMFacade(stub), rr, Cfg(**(jcfg or {}))),
                    stub))
    return out


# ----------------------------------------------------------------- compare

def plain_types(x, path="$"):
    """The port's payloads hold only JSON's Python types (no numpy, no
    torch): ``json.dumps(default=str)`` would turn anything else into a
    string without an error."""
    if isinstance(x, dict):
        for k, v in x.items():
            assert isinstance(k, (str, int)), (path, type(k))
            plain_types(v, f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            plain_types(v, f"{path}[{i}]")
    else:
        assert x is None or type(x) in (str, int, float, bool), (path, type(x))


def same(a, b, path="$", skip=("timing", "avg_llm_latency")):
    """Port value ``a`` against the JAX package's ``b``: the same types,
    keys and strings; floats within TOL."""
    if isinstance(b, float) and isinstance(a, float):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (path, a, b)
        return
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(b, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in b:
            if k in skip:
                continue
            if k == "error_traceback":    # file paths and line numbers differ
                assert a[k].strip().splitlines()[-1] == b[k].strip().splitlines()[-1]
                continue
            same(a[k], b[k], f"{path}.{k}", skip)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]", skip)
    else:
        assert a == b, (path, a, b)


def same_calls(tstub, jstub, ordered=True):
    tc = [(c["system"], c["user"], c["model"]) for c in tstub.calls]
    jc = [(c["system"], c["user"], c["model"]) for c in jstub.calls]
    assert tstub.calls and (tc == jc if ordered else sorted(tc) == sorted(jc))


def ask_both(pair, *args, ordered=True, **kw):
    (jp, js), (tp, ts) = pair
    jo = jp.get_answer_for_company(*args, **kw)
    to = tp.get_answer_for_company(*args, **kw)
    plain_types(to)
    same(to, jo)
    same_calls(ts, js, ordered)
    return to


# ------------------------------------------------------------------ tests

QUESTION = "金盘科技2023年营业收入是多少"

METHODS = {
    "basic": {},
    "basic_bm25_max": dict(use_bm25=True, fuse_mode="max", dense_weight=1.0),
    "basic_bm25_sum": dict(use_bm25=True),
    "chunks_bm25_sum": dict(use_bm25=True, return_parent_pages=False,
                            top_n_retrieval=12),
    "ssg": dict(retrieval_method="ssg", max_hops=2, neighbor_k=4),
    "triangulation_bm25": dict(retrieval_method="triangulation", max_hops=2,
                               neighbor_k=4, use_bm25=True),
    "hybrid_expansion_bm25": dict(retrieval_method="hybrid_expansion", max_hops=2,
                                  neighbor_k=4, use_bm25=True),
    "hybrid_expansion": dict(retrieval_method="hybrid_expansion",
                             return_parent_pages=False),
}


@pytest.mark.parametrize("name", list(METHODS))
def test_methods_match(qa_corpus, name):
    pair = build_pair(qa_corpus, METHODS[name])
    out = ask_both(pair, "金盘科技", QUESTION, "number")
    assert out["final_answer"] == 68.9 and out["references"]
    method = METHODS[name].get("retrieval_method", "basic")
    if method != "basic":
        assert out["retrieval_details"]["method"] == method
    for q in ("金盘科技2024年毛利率如何", "金盘科技研发投入"):
        ask_both(pair, "金盘科技", q, "number", selected_years=[2024])


@pytest.mark.parametrize("cfg", [
    dict(llm_reranking=True, llm_reranking_sample_size=8),
    dict(llm_reranking=True, llm_reranking_sample_size=8, use_bm25=True,
         expand_upstream=True, expand_top_k=2, expand_context_size=1),
    dict(llm_reranking=True, retrieval_method="hybrid_expansion", max_hops=2,
         neighbor_k=4, use_bm25=True),
], ids=["rerank", "rerank_upstream_bm25", "rerank_hybrid"])
def test_llm_reranking_matches(qa_corpus, cfg):
    pair = build_pair(qa_corpus, cfg)
    # the reranker scores its batches on a thread pool: compare the calls
    # as a multiset
    out = ask_both(pair, "金盘科技", QUESTION, "number", ordered=False)
    assert "reranker_stats" in out
    if cfg.get("expand_upstream"):
        assert out["selected_groups"] and all("group_id" in r for r in out["references"])


def test_full_context_matches(qa_corpus):
    pair = build_pair(qa_corpus, dict(full_context=True))
    out = ask_both(pair, "金盘科技", "问题", "number")
    assert {c["page"] for c in out["all_retrieved_chunks"]} == {1, 2, 3, 4}


def test_expansion_and_year_routing_match(qa_corpus):
    pair = build_pair(qa_corpus, dict(
        use_hyde=True, use_multi_query=True, use_bm25=True, use_year_routing=True))
    out = ask_both(pair, "金盘科技", QUESTION, "jingpan")
    assert out["expansion_texts"]["hyde_text"]
    assert len(out["expansion_texts"]["multi_query_texts"]) == 3


def test_history_and_progress_match(qa_corpus):
    pair = build_pair(qa_corpus)
    stages = []
    out = ask_both(pair, "金盘科技", "它的净利润呢", "number",
                   conversation_history=[{"question": "2024年营收是多少",
                                          "answer": "68.9亿"}],
                   progress_callback=lambda text, pct: stages.append((text, pct)))
    assert "历史对话上下文" in out["prompt_info"]["question"]
    assert stages[: len(stages) // 2] == stages[len(stages) // 2:]


def test_comparative_question_matches(qa_corpus):
    (jp, js), (tp, ts) = build_pair(qa_corpus, dict(use_bm25=True))
    q = "金盘科技和宁德时代2023年谁的营收高"
    jo, to = jp.process_question(q, "comparative"), tp.process_question(q, "comparative")
    plain_types(to)
    same(to, jo)
    same_calls(ts, js)
    assert set(to["sub_answers"]) == {"金盘科技", "宁德时代"}
    with pytest.raises(ValueError, match="No company name"):
        tp.process_question("今天的天气如何", "number")


QUESTIONS = [
    {"question": "金盘科技2023年营业收入是多少", "schema": "number"},
    {"question": "金盘科技2024年毛利率是多少", "schema": "number"},
    {"question": "没有公司名的问题", "schema": "number"},
    {"question": "金盘科技研发投入情况如何", "schema": "name"},
    {"question": "   ", "schema": "number"},
]


@pytest.mark.parametrize("par", [1, 3])
def test_process_questions_list_and_submission(qa_corpus, tmp_path, par):
    (jp, js), (tp, ts) = build_pair(qa_corpus, dict(use_bm25=True, parallel_requests=par))
    outs = []
    for proc, sub in ((jp, "j"), (tp, "t")):
        path = tmp_path / sub / "answers.json"
        res = proc.process_questions_list(
            [dict(q) for q in QUESTIONS], str(path), submission_file=True,
            team_email="t@e", submission_name="s", pipeline_details="d")
        outs.append((res, json.loads(path.read_text()),
                     json.loads((tmp_path / sub / "answers_debug.json").read_text())))
    plain_types(outs[1][0])
    same(outs[1], outs[0])
    same_calls(ts, js, ordered=par == 1)
    res, submission, _ = outs[1]
    assert res["statistics"]["error_count"] == 2
    assert submission["answers"][0]["value"] == 68.9
    assert submission["answers"][2]["value"] == "N/A"


def test_micro_batch_matches_unbatched(qa_corpus):
    """``micro_batch`` routes concurrent retrievals through the port's
    MicroBatcher: the answers equal the port's unbatched processor and the
    JAX package's batched one."""
    questions = [q for q in QUESTIONS if q["question"].startswith("金盘科技")]
    cfg = dict(parallel_requests=3, use_bm25=True)
    (_, _), (base, _) = build_pair(qa_corpus, cfg)
    (jmb, _), (tmb, _) = build_pair(qa_corpus, dict(cfg, micro_batch=4))
    b = base.process_questions_list([dict(q) for q in questions])
    t = tmb.process_questions_list([dict(q) for q in questions])
    j = jmb.process_questions_list([dict(q) for q in questions])
    assert tmb.batcher is not None and tmb.batcher.stats["requests"] == 3
    same(t, b)
    same(t, j)


def test_many_doc_route_and_max_docs(tmp_path):
    """Ten routed reports: the doc-slot bucket grows to 16 so the oldest
    report is searched; an explicit ``max_docs`` keeps the newest, with
    the engine's warning, as in the JAX package."""
    import warnings

    rng = np.random.default_rng(1)
    reports, embs = [], []
    for d in range(10):
        chunks = [{"page": 1, "text": f"年报{2015 + d} chunk{c}", "id": c,
                   "type": "content"} for c in range(4)]
        reports.append({"metainfo": {"sha1_name": f"J{2015 + d}_doc{d}",
                                     "company_name": "金盘科技", "year": 2015 + d},
                        "content": {"pages": [{"page": 1, "text": "p"}], "chunks": chunks}})
        e = rng.normal(size=(4, 32)).astype(np.float32)
        embs.append(e / np.linalg.norm(e, axis=1, keepdims=True))
    idx, meta = jax_build(reports, embs, vocab_bits=12)
    jax_save(tmp_path / "ten.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "ten.npz", device="cpu")
    target = embs[0][1][None, :]
    outs = []
    for llm, Proc, Cfg, eng in ((jllm, JaxProcessor, JaxQAConfig, JaxEngine(idx, meta)),
                                (tllm, QuestionsProcessor, QAConfig,
                                 QueryEngine(tidx, tmeta))):
        proc = Proc(eng, lambda texts: np.repeat(target, len(texts), 0),
                    llm.LLMFacade(llm.StubProvider(dict(SCRIPT))), None,
                    Cfg(return_parent_pages=False))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            full = proc.get_answer_for_company("金盘科技", "近十年营业收入趋势如何？", "number")
        proc.config = dataclasses.replace(proc.config, max_docs=4)
        with pytest.warns(UserWarning, match="max_docs"):
            capped = proc.get_answer_for_company("金盘科技", "近十年营业收入趋势如何？",
                                                 "number")
        outs.append((full, capped))
    same(outs[1], outs[0])
    top = outs[1][0]["initial_retrieval_results"][0]
    assert top["source_year"] == 2015 and top["rep_row"] == 1
    assert 2015 not in {r["source_year"] for r in outs[1][1]["initial_retrieval_results"]}


def test_val_online_matches(qa_corpus, tmp_path):
    from rag_challenge_2_tpu.qa import ValOnline as JaxValOnline
    from rag_challenge_2_tpu_torch.qa import ValOnline

    (jp, js), (tp, ts) = build_pair(qa_corpus)
    outs = []
    for V, proc, sub in ((JaxValOnline, jp, "j"), (ValOnline, tp, "t")):
        v = V(proc, history_path=tmp_path / sub / "hist.json")
        a1 = v.ask("2023年营业收入是多少")
        a2 = v.ask("那净利润呢")
        batch = v.run_batch([{"question": "毛利率", "standard_answer": "30%"},
                             {"question": " "}], tmp_path / sub / "batch.json")
        hist = [{k: h[k] for k in ("question", "answer")} for h in v.history]
        outs.append((a1, a2, batch, hist))
    same(outs[1], outs[0])
    same_calls(ts, js)
    assert outs[1][2]["errors"] == 1 and len(outs[1][3]) == 3
