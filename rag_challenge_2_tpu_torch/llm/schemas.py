"""Structured-output schemas.

Field names/types mirror the reference's pydantic contracts
(reference src/prompts.py:43-60, :166-207, :213-306, :312-349, :355-408,
:437-469, :597-606, :689-871, :909-924, :1121-1140) so downstream
consumers (scorer, UI, debug files) stay compatible; descriptions are our
own.  Every answer schema carries the analysis → summary → pages → answer
chain the reference's two-stage answering relies on.

Port of ``rag_challenge_2_tpu/llm/schemas.py`` (pure host code, unchanged).
"""

from __future__ import annotations

from typing import List, Literal, Union

from pydantic import BaseModel, Field


class SubQuestion(BaseModel):
    question: str = Field(description="自包含、可独立检索回答的子问题")
    reasoning: str = Field(description="需要该子问题的原因（一两句）")


class DecomposedQuestions(BaseModel):
    sub_questions: List[SubQuestion] = Field(description="按逻辑顺序的子问题")


class AnswerBase(BaseModel):
    step_by_step_analysis: str = Field(
        description="逐步分析（≥5步、≥150字），注意问题措辞，警惕相似但不相同的指标"
    )
    reasoning_summary: str = Field(description="推理过程的简明总结（约50字）")
    relevant_pages: List[int] = Field(
        description="直接支撑答案的页码；只列真正包含依据的页"
    )


class NameAnswer(AnswerBase):
    final_answer: Union[str, Literal["N/A"]] = Field(
        description="目标名称；上下文无答案时为 'N/A'"
    )


class NumberAnswer(AnswerBase):
    final_answer: Union[float, int, Literal["N/A"]] = Field(
        description="纯数值（按问题要求的单位换算后），无答案时 'N/A'"
    )


class BooleanAnswer(AnswerBase):
    final_answer: bool = Field(description="是→true，否→false")


class NamesAnswer(AnswerBase):
    final_answer: Union[List[str], Literal["N/A"]] = Field(
        description="名称列表；无答案时 'N/A'"
    )


class ComparativeAnswer(AnswerBase):
    final_answer: Union[str, Literal["不适用"]] = Field(
        description="比较结论（如获胜公司名）；无法比较时 '不适用'"
    )


class JingpanAnswer(AnswerBase):
    final_answer: Union[float, int, bool, str] = Field(
        description="按问题类型返回数值/布尔/文本；优先精确数据，按要求换算单位"
    )


class RetrievalRankingSingleBlock(BaseModel):
    reasoning: str = Field(description="文本块与查询关系的简要分析")
    relevance_score: float = Field(description="相关性 0~1；0 完全无关，1 完全相关")


class RetrievalRankingMultipleBlocks(BaseModel):
    block_rankings: List[RetrievalRankingSingleBlock] = Field(
        description="逐块评分，与输入顺序一致"
    )


class EvaluationSchema(BaseModel):
    score: float = Field(description="匹配度 0~1（数字题允许 1.0/0.3/0.0 档位）")
    reasoning: str = Field(description="评分理由")
    is_correct: bool = Field(description="score ≥ 0.7 视为正确")


class PageSelectionSchema(BaseModel):
    selected_pages: List[int] = Field(description="回答该问题最可能需要的页码")
    reasoning: str = Field(description="选择理由")


class TableBlock(BaseModel):
    subject_core_entity: str = Field(description="该信息块的主语实体（表格行主体）")
    information_block: str = Field(
        description="脱离上下文也能理解的完整陈述句，包含主体、指标、数值与单位"
    )


class TableBlocksCollection(BaseModel):
    subject_core_entities_list: List[str] = Field(description="表中全部行主体")
    information_blocks: List[TableBlock] = Field(description="逐主体的信息块")


ANSWER_SCHEMAS = {
    "name": NameAnswer,
    "number": NumberAnswer,
    "boolean": BooleanAnswer,
    "names": NamesAnswer,
    "comparative": ComparativeAnswer,
    "jingpan": JingpanAnswer,
}
