"""The port's LLM layer (``rag_challenge_2_tpu_torch.llm`` and
``retrieval.expansion``) held against the JAX package's on the same
inputs: lenient JSON, every prompt string, every schema's JSON schema, the
stub provider's validation / default / repair round, the facade's
question-type routing, the reranker's batch and fallback, query
expansion and the glossary.  Pure host code: outputs must be equal."""

import inspect
import json

import pytest

import rag_challenge_2_tpu.llm as jllm
import rag_challenge_2_tpu_torch.llm as tllm
from rag_challenge_2_tpu.llm import prompts as jprompts
from rag_challenge_2_tpu.llm import providers as jproviders
from rag_challenge_2_tpu.llm import schemas as jschemas
from rag_challenge_2_tpu.retrieval.expansion import expand_query as jexpand
from rag_challenge_2_tpu_torch.llm import prompts as tprompts
from rag_challenge_2_tpu_torch.llm import providers as tproviders
from rag_challenge_2_tpu_torch.llm import schemas as tschemas
from rag_challenge_2_tpu_torch.retrieval import expand_query as texpand



def both(fn):
    """``fn(module)`` for the JAX package's llm and the port's; equal."""
    a, b = fn(jllm), fn(tllm)
    assert a == b
    return b


def exported(pkg):
    """The names a package's ``__init__`` imports (``dir`` would also list
    submodules that other tests happened to import)."""
    import ast

    tree = ast.parse(open(pkg.__file__, encoding="utf-8").read())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


def test_exports_match():
    assert exported(tllm) == exported(jllm)
    assert all(hasattr(tllm, n) for n in exported(tllm))


JSON_CASES = [
    '{"a": 1}',
    'Sure! Here is the JSON:\n```json\n{"score": 0.5, "ok": true}\n```\nHope it helps',
    '{"a": [1, 2,], }',
    '{"a": {"b": 1}',
    "no json here",
    "",
    '[{"a": 1}, {"a": 2}]',
    'Here you go:\n[{"relevance_score": 0.5, "reasoning": "r"}]',
    "{'score': 0.3, 'reasoning': 'ok'}",
    '{"final_answer": "N/A", "relevant_pages": [1, 2, 3',
]


@pytest.mark.parametrize("text", JSON_CASES)
def test_jsonfix_matches(text):
    out = both(lambda m: m.loads_lenient(text))
    if text.startswith('{"a": 1}'):
        assert out == {"a": 1}


def _public(mod):
    """Every public string and dict a prompts module defines, by dotted
    name (class attributes included)."""
    out = {}
    for name, val in vars(mod).items():
        if name.startswith("_"):
            continue
        if isinstance(val, (str, dict, list)):
            out[name] = val
        elif inspect.isclass(val) and val.__module__ == mod.__name__:
            for attr, v in vars(val).items():
                if not attr.startswith("_") and isinstance(v, (str, dict, list)):
                    out[f"{name}.{attr}"] = v
    return out


def test_prompts_equal():
    jp, tp = _public(jprompts), _public(tprompts)
    assert jp and jp.keys() == tp.keys()
    for k in jp:
        assert tp[k] == jp[k], k


def _schemas(mod):
    from pydantic import BaseModel

    return {n: v for n, v in vars(mod).items()
            if inspect.isclass(v) and issubclass(v, BaseModel) and v is not BaseModel}


def test_schemas_json_schema_equal():
    js, ts = _schemas(jschemas), _schemas(tschemas)
    assert js and js.keys() == ts.keys()
    for n in js:
        assert ts[n].model_json_schema() == js[n].model_json_schema(), n
    # the prompts' schemas too (the stub's system prompt embeds them)
    for cls in ("AnswerWithRAGContextNumberPrompt", "PageSelectionPrompt",
                "RerankingPrompt", "AnswerEvaluationPrompt"):
        jc, tc = getattr(jprompts, cls), getattr(tprompts, cls)
        for attr, v in vars(jc).items():
            if inspect.isclass(v):
                assert getattr(tc, attr).model_json_schema() == v.model_json_schema()


def _stub_round(m, schemas):
    p = m.StubProvider({
        "好问题": {"score": 0.9, "reasoning": "匹配", "is_correct": True},
        "评估": "{'score': 0.3, 'reasoning': ok...",
        "修复": json.dumps({"score": 0.3, "reasoning": "r", "is_correct": False}),
    })
    out = []
    for system, user in (("judge", "好问题"), ("judge", "???"), ("评估", "评估这个")):
        out.append(p.send_message(system_content=system, human_content=user,
                                  is_structured=True,
                                  response_format=schemas.EvaluationSchema))
    out.append(p.send_message(system_content="s", human_content="plain"))
    return out, p.calls


def test_stub_validation_default_and_repair():
    (jo, jc), (to, tc) = _stub_round(jllm, jschemas), _stub_round(tllm, tschemas)
    assert to == jo and tc == jc
    assert to[0]["is_correct"] is True and to[1]["is_correct"] is False
    assert to[2]["score"] == 0.3 and to[3] == "<SKIP>"


@pytest.mark.parametrize("name", sorted(_schemas(jschemas)))
def test_safe_default_matches(name):
    assert tproviders._safe_default(getattr(tschemas, name)) == \
        jproviders._safe_default(getattr(jschemas, name))


def test_get_provider_names():
    assert sorted(tproviders.PROVIDERS) == sorted(jproviders.PROVIDERS)
    assert isinstance(tproviders.get_provider("stub"), tproviders.StubProvider)
    with pytest.raises(ValueError, match="unknown provider"):
        tproviders.get_provider("nope")


@pytest.mark.parametrize("question,standard", [
    ("2024年营业收入是多少", "68.9亿元"),
    ("公司是否进行了分红", "是"),
    ("介绍一下公司的主营业务", "变压器"),
    ("收入构成如何", "以海外为主"),
    ("海外收入占比", "31%"),
])
def test_question_type_routing(question, standard):
    both(lambda m: m.LLMFacade.detect_question_type(question, standard))


def _facade_round(m):
    ans = {"step_by_step_analysis": "x" * 10, "reasoning_summary": "s",
           "relevant_pages": [1, 2], "final_answer": 68.9}
    subs = {"sub_questions": [
        {"question": "A公司2024年营收是多少？", "reasoning": "r"},
        {"question": "B公司2024年营收是多少？", "reasoning": "r"},
    ]}
    p = m.StubProvider({
        "营业收入": json.dumps(ans, ensure_ascii=False),
        "原始问题": json.dumps(subs, ensure_ascii=False),
        "标准答案": json.dumps({"score": 1.0, "reasoning": "匹配", "is_correct": True}),
    })
    f = m.LLMFacade(p)
    out = [f.get_answer_from_rag_context("营业收入是多少", "context...", schema)
           for schema in ("number", "name", "boolean", "names", "comparative", "jingpan")]
    out.append(f.get_rephrased_questions("A公司和B公司谁营收高",
                                         companies=["B公司", "A公司", "C公司"]))
    out.append(f.get_rephrased_questions("A公司和B公司谁营收高"))
    out.append(f.evaluate_answer("2024年净利润是多少", "5.1亿元", "净利润5.1亿元"))
    with pytest.raises(ValueError, match="Unsupported schema"):
        f.get_answer_from_rag_context("q", "c", "nope")
    return out, p.calls


def test_facade_matches():
    jo, jc = _facade_round(jllm)
    to, tc = _facade_round(tllm)
    assert to == jo and tc == jc
    assert to[0]["final_answer"] == 68.9 and to[6]["C公司"] == "A公司和B公司谁营收高"


def _rerank(m, scripted, batch, workers):
    rr = m.LLMReranker(m.StubProvider(scripted), max_concurrent_requests=workers)
    rr.rate_limiter = m.RateLimiter(0)
    docs = [{"text": f"块{i}", "distance": 0.9 - 0.05 * i, "source_sha1": f"s{i % 3}"}
            for i in range(7)]
    out = rr.rerank_documents("营业收入", docs, documents_batch_size=batch)
    stats = rr.get_stats()
    stats.pop("avg_llm_latency")
    return out, stats, sorted(c["user"] for c in rr.provider.calls)


RANK4 = {"block_rankings": [{"reasoning": f"r{i}", "relevance_score": s}
                            for i, s in enumerate((0.9, 0.1, 0.5, 0.7))]}
SINGLE = {"reasoning": "s", "relevance_score": 0.7}


@pytest.mark.parametrize("case", [
    # batches of 4 (the last batch of 3 mismatches and falls back to single)
    dict(scripted={"文本块集合": RANK4, "文本块:": SINGLE}, batch=4, workers=1),
    dict(scripted={"文本块集合": RANK4, "文本块:": SINGLE}, batch=4, workers=10),
    # one block a call
    dict(scripted={"文本块:": SINGLE}, batch=1, workers=1),
    # every batch mismatches (no batch reply) → single-block fallback
    dict(scripted={"文本块:": SINGLE}, batch=2, workers=3),
])
def test_reranker_matches(case):
    jo = _rerank(jllm, **case)
    to = _rerank(tllm, **case)
    assert to == jo
    assert [d["combined_score"] for d in to[0]] == sorted(
        (d["combined_score"] for d in to[0]), reverse=True)


@pytest.mark.parametrize("hyde,multi,cfg", [
    (False, False, None),
    (True, False, None),
    (False, True, {"synonym": True, "subquestion": True, "variant": True}),
    (True, True, {"synonym": True, "subquestion": True, "variant": False}),
    (True, True, {"synonym": False, "subquestion": False, "variant": False}),
])
def test_expand_query_matches(hyde, multi, cfg):
    scripted = {
        "虚构": "| 指标 | 数值 |\n|营业收入|68.9亿元|",
        "同义指标名": "<金盘科技2024年营业收入 名词解释：营收>\n"
                      "<金盘科技2024年营业收入 名词解释：营收>",
        "子问题": "<金盘科技2024年营业收入>\n<SKIP>",
    }

    def run(m, expand):
        p = m.StubProvider(dict(scripted))
        res = expand(p, "金盘科技2024年营业收入是多少", use_hyde=hyde,
                     use_multi_query=multi, multi_query_config=cfg)
        d = dict(vars(res))
        d.pop("timing")
        return d, sorted(res.timing), p.calls

    jo, to = run(jllm, jexpand), run(tllm, texpand)
    assert to == jo
    assert to[0]["queries"][0] == "金盘科技2024年营业收入是多少"


@pytest.mark.parametrize("text,top_n", [
    ("公司的ROE和毛利率怎么样", 3),
    ("今天天气", 2),
    ("经营活动产生的现金流量净额与净利润的比值", 5),
    ("", 4),
])
def test_glossary_matches(text, top_n):
    hits = both(lambda m: m.find_financial_concepts(text, top_n=top_n))
    both(lambda m: m.format_glossary_context(hits))
    assert tllm.FINANCIAL_GLOSSARY == jllm.FINANCIAL_GLOSSARY


def test_batch_module_matches():
    """llm.batch: same public names; aiohttp stays a lazy import."""
    from rag_challenge_2_tpu.llm import batch as jb
    from rag_challenge_2_tpu_torch.llm import batch as tb

    def names(m):
        return sorted(n for n, v in vars(m).items()
                      if not n.startswith("_") and getattr(v, "__module__", "") == m.__name__)

    assert names(tb) == names(jb) and names(tb)
    assert "aiohttp" not in vars(tb)
