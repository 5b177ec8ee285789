"""Query expansion: HyDE + multi-query.

Behavioural port of the reference's expansion stage
(reference src/retrieval.py:892-1076): HyDE generates one hypothetical
annual-report snippet; multi-query runs up to three rewrite methods
(``synonym`` glossary enrichment, ``subquestion`` split, ``variant``
scenario rewrite), each returning queries wrapped in ``<...>`` with a
``<SKIP>`` opt-out; results are deduplicated preserving order.

LLM calls go through any ChatProvider (the offline stub in tests); the
expansion output feeds the engine as extra batch rows — the device-side
fan-out itself lives in retrieval/engine.py.  Port of
``rag_challenge_2_tpu/retrieval/expansion.py`` (pure host code).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional

from ..llm import prompts
from ..llm.glossary import find_financial_concepts, format_glossary_context
from ..llm.providers import ChatProvider

_ANGLE = re.compile(r"<(.*?)>", re.DOTALL)

METHOD_DEFS = [
    (1, "synonym", prompts.MultiQueryPrompt.system_synonym),
    (2, "subquestion", prompts.MultiQueryPrompt.system_subquestion),
    (3, "variant", prompts.MultiQueryPrompt.system_scenario),
]


@dataclasses.dataclass
class ExpansionResult:
    """Payload-as-telemetry contract (reference ``expansion_texts`` dict,
    src/retrieval.py:820-827)."""

    queries: List[str]
    hyde_text: Optional[str] = None
    multi_query_texts: List[Dict] = dataclasses.field(default_factory=list)
    glossary_context: Optional[str] = None
    multi_query_methods: Dict[str, bool] = dataclasses.field(default_factory=dict)
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)


def expand_query(
    provider: ChatProvider,
    question: str,
    use_hyde: bool = False,
    use_multi_query: bool = False,
    multi_query_config: Optional[Dict[str, bool]] = None,
    model: Optional[str] = None,
) -> ExpansionResult:
    """Original question + expansions, deduped in order."""
    res = ExpansionResult(queries=[question])
    mq_config = multi_query_config or {}
    res.multi_query_methods = mq_config
    if use_multi_query and not any(mq_config.values()):
        use_multi_query = False

    if use_hyde:
        t0 = time.perf_counter()
        try:
            hyde = provider.send_message(
                model=model,
                system_content=prompts.HyDEPrompt.system_prompt,
                human_content=prompts.HyDEPrompt.user_prompt.format(question=question),
                is_structured=False,
            )
            if hyde and hyde.strip() and hyde.strip().upper() != "<SKIP>":
                res.hyde_text = hyde.strip()
                res.queries.append(hyde.strip())
        except Exception:
            pass
        res.timing["hyde_expansion"] = time.perf_counter() - t0

    if use_multi_query:
        t0 = time.perf_counter()
        concepts = find_financial_concepts(question, top_n=5)
        res.glossary_context = format_glossary_context(concepts)
        concept_terms = [c["term"] for c in concepts]
        for method_id, method_key, system in METHOD_DEFS:
            if not mq_config.get(method_key, False):
                continue
            try:
                response = provider.send_message(
                    model=model,
                    system_content=system,
                    human_content=prompts.MultiQueryPrompt.user_prompt.format(
                        question=question, glossary_context=res.glossary_context
                    ),
                    is_structured=False,
                )
            except Exception:
                continue
            for q in _ANGLE.findall(response or ""):
                q = q.strip()
                if not q or q.upper() == "SKIP":
                    continue
                res.queries.append(q)
                res.multi_query_texts.append(
                    {"method_id": method_id, "query": q, "concepts": concept_terms}
                )
        res.timing["multi_query_expansion"] = time.perf_counter() - t0

    # dedup preserving order (reference src/retrieval.py:1049-1076)
    seen = set()
    deduped = []
    for q in res.queries:
        q = q.strip()
        if q and q not in seen:
            deduped.append(q)
            seen.add(q)
    res.queries = deduped
    return res
