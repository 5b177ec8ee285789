"""Prompt library.

Re-implements the contracts of the reference prompt library
(reference src/prompts.py, 1140 LoC) with our own wording: per-schema
answer prompts, reranking rubrics, the Jinpan financial-QA doctrine
(per-year source tags, precise-data-first, unit conversion), LLM-judge
rubrics with the 3%-tolerance number rule, query-expansion templates with
the ``<...>`` / ``<SKIP>`` extraction protocol, and page selection.

Every class follows the reference's shape: ``system_prompt``,
``user_prompt`` (a ``str.format`` template), and a pydantic schema from
llm/schemas.py.

Port of ``rag_challenge_2_tpu/llm/prompts.py`` (pure host code, unchanged).
"""

from __future__ import annotations

from . import schemas


def build_system_prompt(instruction: str = "", example: str = "") -> str:
    """Compose instruction + optional example into one system prompt
    (reference src/prompts.py:15)."""
    parts = [p for p in (instruction, example) if p]
    return "\n\n---\n\n".join(parts)


# ---------------------------------------------------------------- answering

_SHARED_RAG_RULES = """\
你是金盘科技年报问答助手。依据提供的上下文回答问题，遵守：
1. 只使用上下文中的信息，不编造；上下文不含答案时明确说明。
2. 上下文带有来源标注（页码、年份）。注意"XX年年报"披露的是该年度数据，
   通常发布于次年；问"2024年数据"应优先看2024年年报。
3. 数字题优先取精确数据；按问题要求的单位换算（万元/亿元/%），
   括号中的数值表示负数；千分位逗号需去除。
4. relevant_pages 只列出直接支撑答案的页码。"""

_USER_QA = "上下文:\n\"\"\"\n{context}\n\"\"\"\n\n---\n\n问题:\n\"{question}\"\n"


class AnswerWithRAGContextNamePrompt:
    instruction = _SHARED_RAG_RULES + "\n本题要求返回一个名称（人名/机构名/产品名等）。"
    system_prompt = build_system_prompt(instruction)
    user_prompt = _USER_QA
    AnswerSchema = schemas.NameAnswer


class AnswerWithRAGContextNumberPrompt:
    instruction = _SHARED_RAG_RULES + """
本题要求返回一个数值。严格匹配指标口径：问"营业收入"不能用"营业总收入"替代；
问合并口径不能用母公司口径。final_answer 只含数字本身（换算后），找不到则 'N/A'。"""
    system_prompt = build_system_prompt(instruction)
    user_prompt = _USER_QA
    AnswerSchema = schemas.NumberAnswer


class AnswerWithRAGContextBooleanPrompt:
    instruction = _SHARED_RAG_RULES + "\n本题是判断题：依据上下文返回 true/false。"
    system_prompt = build_system_prompt(instruction)
    user_prompt = _USER_QA
    AnswerSchema = schemas.BooleanAnswer


class AnswerWithRAGContextNamesPrompt:
    instruction = _SHARED_RAG_RULES + "\n本题要求返回名称列表；逐项核对是否确属所问类别。"
    system_prompt = build_system_prompt(instruction)
    user_prompt = _USER_QA
    AnswerSchema = schemas.NamesAnswer


class ComparativeAnswerPrompt:
    instruction = _SHARED_RAG_RULES + """
本题是多公司比较题。上下文包含各公司的子问题答案；比较后给出结论
（通常是公司名）。无法比较时 final_answer 为 '不适用'。"""
    system_prompt = build_system_prompt(instruction)
    user_prompt = _USER_QA
    AnswerSchema = schemas.ComparativeAnswer


class AnswerWithRAGContextJingpanPrompt:
    instruction = _SHARED_RAG_RULES + """
综合题型（金盘科技场景）：final_answer 按问题类型返回数值/布尔/文本。
回答时先给出精确数据与出处年份，再作必要说明；涉及多年对比时逐年列数据。"""
    system_prompt = build_system_prompt(instruction)
    user_prompt = _USER_QA
    AnswerSchema = schemas.JingpanAnswer


class RephrasedQuestionsPrompt:
    """Decompose a comparative question into per-company sub-questions
    (reference src/prompts.py:18-50)."""

    system_prompt = build_system_prompt(
        """把比较类问题拆解为可独立回答的子问题，每个子问题只涉及一家公司，
保留原问题的指标与时间范围。""",
        """示例：问题 "A公司和B公司2024年谁的营收更高？" →
sub_questions: [{question: "A公司2024年营业收入是多少？", reasoning: "..."},
                {question: "B公司2024年营业收入是多少？", reasoning: "..."}]""",
    )
    user_prompt = '原始问题:\n"{question}"'
    DecomposedQuestions = schemas.DecomposedQuestions


class AnswerSchemaFixPrompt:
    """One-shot JSON repair round (reference src/prompts.py:471-491)."""

    system_prompt = "你收到一段应为 JSON 的模型输出。修复其格式问题并只输出合法 JSON，不加任何解释。"
    user_prompt = "目标 schema:\n{schema}\n\n待修复输出:\n{response}"


# ---------------------------------------------------------------- reranking

class RerankingPrompt:
    """0–1 relevance rubric (reference src/prompts.py:493-595), single- and
    multi-block variants; context carries per-year source tags."""

    _rubric = """\
给定查询和检索到的文本块，评估文本块对回答查询的帮助程度，输出 0~1 相关性分：
0 完全无关 / 0.3 弱相关（主题沾边但无可用信息）/ 0.5 部分相关 /
0.7 较相关（含大部分所需信息）/ 1.0 直接且完整地支撑答案。
注意来源标注的年份是否与查询所问年份一致；年份不符要降分。"""

    system_prompt_rerank_single_block = build_system_prompt(_rubric + "\n对单个文本块评分。")
    system_prompt_rerank_multiple_blocks = build_system_prompt(
        _rubric + "\n对编号的多个文本块逐一评分，输出与输入顺序一致的列表。"
    )
    user_prompt_single = '查询:\n"{query}"\n\n文本块:\n"""\n{document}\n"""'
    user_prompt_multiple = '查询:\n"{query}"\n\n文本块集合:\n"""\n{documents}\n"""'
    RetrievalRankingSingleBlock = schemas.RetrievalRankingSingleBlock
    RetrievalRankingMultipleBlocks = schemas.RetrievalRankingMultipleBlocks


# ---------------------------------------------------------------- expansion

class HyDEPrompt:
    """Hypothetical-document generation (reference src/retrieval.py:892-944
    asks qwen-turbo for a hypothetical markdown financial table)."""

    system_prompt = """\
针对用户的财报问题，凭常识虚构一段最可能出现在年报中的回答内容——
优先使用 markdown 表格形式（指标、数值、同比），不要声明这是虚构的。
输出控制在200字以内。"""
    user_prompt = "问题: {question}"


class MultiQueryPrompt:
    """Three rewrite methods (reference src/retrieval.py:946-1047).
    Protocol: the rewritten query is wrapped in ``<...>``; a method that
    does not apply outputs ``<SKIP>``."""

    system_synonym = """\
利用给出的金融术语解释，把问题改写为语义相同但用词更规范、补充了同义指标名的检索查询。
将改写结果放在尖括号中输出：<改写后的查询>。若无需改写输出 <SKIP>。"""
    system_subquestion = """\
若问题包含多个可独立检索的信息需求，拆出其中最关键的一个子问题；
放在尖括号中输出：<子问题>。若问题已足够单一输出 <SKIP>。"""
    system_scenario = """\
把问题改写为年报行文视角的陈述式查询（模拟答案所在段落的表述方式）；
放在尖括号中输出：<改写后的查询>。不适用时输出 <SKIP>。"""
    user_prompt = "问题: {question}\n{glossary_context}"


# ---------------------------------------------------------------- evaluation

class AnswerEvaluationPrompt:
    """LLM-judge rubrics (reference src/prompts.py:873-1096): generic,
    number (1.0 / 0.3 / 0.0 with 3% tolerance), boolean, open."""

    _common = """\
你是评估员：对比 RAG 答案与标准答案，给出 score、reasoning、is_correct。
只根据事实一致性评分，不因表述差异扣分。"""

    system_prompt = build_system_prompt(_common)
    system_prompt_number = build_system_prompt(_common + """
数字题评分档位：数值一致（允许 ±3% 误差与单位换算差异）→ 1.0；
数值接近但口径或年份略有出入 → 0.3；数值错误或未给出 → 0.0。""")
    system_prompt_boolean = build_system_prompt(_common + """
判断题：结论一致 → 1.0，结论相反或未给出 → 0.0。""")
    system_prompt_open = build_system_prompt(_common + """
开放题：覆盖标准答案全部要点 → 1.0；覆盖主要要点 → 0.7；
部分要点 → 0.4；基本未覆盖 → 0.0。""")

    _user = """问题: {question}
标准答案: {standard_answer}
RAG答案: {rag_answer}"""
    user_prompt = _user
    user_prompt_number = _user
    user_prompt_boolean = _user
    user_prompt_open = _user
    EvaluationSchema = schemas.EvaluationSchema


class PageSelectionPrompt:
    """Stage-1 of two-stage answering (reference src/prompts.py:1099-1140,
    used by src/questions_processing.py:771-819)."""

    system_prompt = build_system_prompt(
        """下面给出候选页面的摘要列表。选出回答问题最可能需要的页码
（宁缺毋滥，但证据链相关的页都要保留）。"""
    )
    user_prompt = "问题: {question}\n\n候选页面:\n{pages_summary}"
    PageSelectionSchema = schemas.PageSelectionSchema


class TableSerializationPrompt:
    """HTML table → context-free information blocks
    (reference src/tables_serialization.py:313-345)."""

    system_prompt = build_system_prompt(
        """把 HTML 表格改写为一组独立可读的信息块：每个信息块围绕一个行主体，
把表头、单位、数值组织成完整陈述句，脱离表格也能被检索和理解。
结合给出的上下文补全主体全称与报告期。"""
    )
    user_prompt = "上下文:\n{context}\n\n表格:\n{table}"
    TableBlocksCollection = schemas.TableBlocksCollection
