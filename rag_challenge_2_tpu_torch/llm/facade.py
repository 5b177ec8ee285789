"""High-level LLM operations over any provider.

Equivalent of the reference's ``APIProcessor`` facade
(reference src/api_requests.py:616-826): schema-routed RAG answering,
LLM-as-judge evaluation with question-type detection, comparative-question
rephrasing.

Port of ``rag_challenge_2_tpu/llm/facade.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from . import prompts
from .providers import ChatProvider, get_provider

_ANSWER_PROMPTS = {
    "name": prompts.AnswerWithRAGContextNamePrompt,
    "number": prompts.AnswerWithRAGContextNumberPrompt,
    "boolean": prompts.AnswerWithRAGContextBooleanPrompt,
    "names": prompts.AnswerWithRAGContextNamesPrompt,
    "comparative": prompts.ComparativeAnswerPrompt,
    "jingpan": prompts.AnswerWithRAGContextJingpanPrompt,
}

_BOOLEAN_KEYWORDS = ["是否", "有没有", "会不会", "能否", "可不可以", "会否"]
_NUMBER_KEYWORDS = [
    "多少", "多大", "几个", "增长率", "占比", "比例", "金额", "收入", "利润",
    "资产", "负债", "成本", "费用", "元", "万元", "亿元", "%", "百分比",
]


class LLMFacade:
    def __init__(self, provider: ChatProvider | str = "qwen", **provider_kwargs):
        self.provider = (
            provider if isinstance(provider, ChatProvider)
            else get_provider(provider, **provider_kwargs)
        )

    def send_message(self, **kwargs):
        return self.provider.send_message(**kwargs)

    # -- RAG answering ---------------------------------------------------
    def get_answer_from_rag_context(
        self, question: str, rag_context: str, schema: str, model: Optional[str] = None
    ) -> Dict:
        """Schema-typed structured answer
        (reference src/api_requests.py:657-667, :752-788)."""
        try:
            p = _ANSWER_PROMPTS[schema]
        except KeyError:
            raise ValueError(f"Unsupported schema: {schema}")
        return self.provider.send_message(
            model=model,
            system_content=p.system_prompt,
            human_content=p.user_prompt.format(context=rag_context, question=question),
            is_structured=True,
            response_format=p.AnswerSchema,
        )

    # -- LLM-as-judge ----------------------------------------------------
    @staticmethod
    def detect_question_type(question: str, standard_answer: str) -> str:
        """boolean / number / open keyword heuristic
        (reference src/api_requests.py:669-695)."""
        if any(k in question for k in _BOOLEAN_KEYWORDS):
            return "boolean"
        if any(k in question for k in _NUMBER_KEYWORDS):
            if re.search(r"\d+[\.\d]*", standard_answer or ""):
                return "number"
        return "open"

    def evaluate_answer(
        self,
        question: str,
        standard_answer: str,
        rag_answer: str,
        model: Optional[str] = None,
    ) -> Dict:
        """Typed-rubric judging (reference src/api_requests.py:697-750)."""
        ep = prompts.AnswerEvaluationPrompt
        qtype = self.detect_question_type(question, standard_answer)
        system = {
            "number": ep.system_prompt_number,
            "boolean": ep.system_prompt_boolean,
            "open": ep.system_prompt_open,
        }[qtype]
        result = self.provider.send_message(
            model=model,
            system_content=system,
            human_content=ep.user_prompt.format(
                question=question,
                standard_answer=standard_answer,
                rag_answer=rag_answer,
            ),
            is_structured=True,
            response_format=ep.EvaluationSchema,
        )
        result["question_type"] = qtype
        return result

    # -- comparative rephrasing ------------------------------------------
    def get_rephrased_questions(
        self, original_question: str, companies: Optional[List[str]] = None
    ) -> Dict[str, str]:
        """Decompose into sub-questions, optionally mapped to companies
        (reference src/api_requests.py:790-825)."""
        rp = prompts.RephrasedQuestionsPrompt
        answer = self.provider.send_message(
            system_content=rp.system_prompt,
            human_content=rp.user_prompt.format(question=original_question),
            is_structured=True,
            response_format=rp.DecomposedQuestions,
        )
        subs = answer.get("sub_questions", [])
        if companies:
            out: Dict[str, str] = {}
            for company in companies:
                matched = [s["question"] for s in subs if company in s.get("question", "")]
                if matched:
                    out[company] = matched[0]
                else:
                    # an unmatched company must NOT inherit another
                    # company's sub-question; the original (comparative)
                    # question still retrieves against this company's docs
                    out[company] = original_question
            return out
        return {f"sub_q_{i}": s["question"] for i, s in enumerate(subs)}
