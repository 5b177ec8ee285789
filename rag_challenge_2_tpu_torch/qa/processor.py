"""Question-answering orchestration.

Re-implementation of the reference's ``QuestionsProcessor``
(reference src/questions_processing.py, 1399 LoC) around the port's
QueryEngine: company extraction, expansion → embedding → engine search →
LLM rerank → (upstream page-group | downstream adjacent) expansion →
two-stage answering (page-selection LLM, then schema-typed answer LLM) →
page-reference validation — with the reference's payload-as-telemetry
result dict (timing, prompt_info, expansion texts, all retrieved chunks).

All LLM traffic goes through a ChatProvider (offline stub in tests); all
retrieval math runs on the engine's device (kernels K1-K3 on the card,
their plain versions on the CPU).  Port of
``rag_challenge_2_tpu/qa/processor.py``: the same behaviour, prompts and
payloads over the PyTorch engine.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..llm import prompts
from ..llm.facade import LLMFacade
from ..llm.reranker import LLMReranker
from ..retrieval.engine import QueryEngine, SearchConfig
from ..retrieval.expansion import expand_query
from ..retrieval.routing import extract_years_from_question


@dataclasses.dataclass
class QAConfig:
    """Run flags, mirroring the reference ``RunConfig``
    (reference src/pipeline.py:45-62) plus the retrieval-method knobs."""

    schema: str = "jingpan"
    use_hyde: bool = False
    use_multi_query: bool = False
    multi_query_methods: Dict[str, bool] = dataclasses.field(
        default_factory=lambda: {"synonym": True, "subquestion": True, "variant": True}
    )
    llm_reranking: bool = False
    llm_reranking_sample_size: int = 30
    top_n_retrieval: int = 10
    return_parent_pages: bool = True
    retrieval_method: str = "basic"
    max_hops: int = 4
    neighbor_k: int = 30
    expand_upstream: bool = False
    expand_top_k: int = 5
    expand_context_size: int = 1
    full_context: bool = False
    use_bm25: bool = False          # hybrid dense+BM25 fusion in the engine
    # fusion rule for use_bm25 (SearchConfig.fuse_mode/dense_weight):
    # "sum" + 0.5 is the measured winner on the config-4 quality eval
    # (0.945 vs max-parity's 0.89 hit@10, BM25-alone 0.905 — DESIGN.md
    # "Sum-fusion"); set fuse_mode="max", dense_weight=1.0 for exact
    # reference scoring parity (src/retrieval.py:1639-1661)
    fuse_mode: str = "sum"
    dense_weight: float = 0.5
    use_ivf: bool = False           # clustered index for the basic method
    ivf_nprobe: int = 8
    scan_rt: Optional[float] = None  # fast 10M-scale scan: fused
                                     # PartialReduce at this recall target
                                     # (SearchConfig.scan_rt); None = exact
    parallel_requests: int = 1
    # coalesce concurrent same-route searches into one stacked device
    # dispatch (serving/batcher.MicroBatcher over engine.search_many):
    # the corpus scan is read from device memory once per micro-batch
    # instead of once per question.  0 = off; >0 = max requests per
    # dispatch.  Methods that return observability details (ssg/
    # triangulation/hybrid_expansion payloads) bypass the batcher —
    # details are per-request tensors the stacked search does not carry.
    micro_batch: int = 0
    answering_model: Optional[str] = None
    new_challenge_pipeline: bool = True
    use_year_routing: bool = False  # derive selected_years from the question
    # doc slots per search: None = size from the actual route (bucketed like
    # max_queries) so a company with many routed reports searches ALL of
    # them — the reference fans out every routed DB (src/retrieval.py:
    # 1475-1504); a fixed 8 silently dropped the oldest years on "近十年"
    # routes
    max_docs: Optional[int] = None


class QuestionsProcessor:
    def __init__(
        self,
        engine: QueryEngine,
        embedder: Callable[[List[str]], np.ndarray],
        llm: LLMFacade,
        reranker: Optional[LLMReranker] = None,
        config: Optional[QAConfig] = None,
    ):
        config = config or QAConfig()
        self.engine = engine
        self.embedder = embedder
        self.llm = llm
        self.reranker = reranker
        self.config = config
        self.batcher = None
        if config.micro_batch > 0:
            from ..serving.batcher import MicroBatcher

            self.batcher = MicroBatcher(engine, max_batch=config.micro_batch)
        self.answer_details: List = []
        self._lock = threading.Lock()
        # (sha1, page) → page text, for adjacent/group page loading
        meta = engine.meta
        self._page_text: Dict[tuple, str] = {}
        for seg, (doc_id, page) in enumerate(meta.page_seg_info):
            self._page_text[(meta.docs[doc_id].sha1, page)] = meta.page_texts.get(seg, "")

    # ------------------------------------------------------------------ util
    def _extract_companies(self, question: str) -> List[str]:
        """Longest-first company matching against the corpus company list
        (reference src/questions_processing.py:1021-1040)."""
        found = []
        text = question
        for company in sorted(self.engine.meta.companies, key=len, reverse=True):
            if not company:
                continue
            if company.isascii():
                # ASCII names need a word boundary ("Apple" ≠ "Applebee")
                pattern = rf"(?:^|[^0-9A-Za-z]){re.escape(company)}(?:[^0-9A-Za-z]|$)"
            else:
                # CJK names: the reference's `\W` boundary never matches a
                # following han character (和/的/…), silently missing names
                # like "金盘科技和宁德时代" — plain substring is correct here
                pattern = re.escape(company)
            if re.search(pattern, text, re.IGNORECASE):
                found.append(company)
                text = re.sub(pattern, "", text, flags=re.IGNORECASE)
        return found

    @staticmethod
    def _format_retrieval_results(results: List[Dict]) -> str:
        """Results → RAG context string (reference :96-108)."""
        return "\n\n---\n\n".join(
            f'Text retrieved from page {r["page"]}: \n"""\n{r["text"]}\n"""'
            for r in results
        )

    @staticmethod
    def _build_contextual_question(
        question: str, history: Optional[List[Dict]] = None
    ) -> str:
        """Prefix multi-turn history (reference :988-1019)."""
        if not history:
            return question
        ctx = "\n\n".join(
            f"Q: {h.get('question', '')}\nA: {h.get('answer', 'N/A')}" for h in history
        )
        return (
            f"历史对话上下文：\n{ctx}\n\n当前问题：{question}\n\n"
            "请结合历史对话回答当前问题；如有指代词（它/该公司等）请按历史内容理解。"
        )

    @staticmethod
    def _validate_page_references(
        claimed: Optional[List[int]],
        retrieval_results: List[Dict],
        min_pages: int = 2,
        max_pages: int = 8,
    ) -> List[int]:
        """Drop hallucinated pages, pad to ≥min, cap at max
        (reference src/questions_processing.py:536-568)."""
        claimed = list(dict.fromkeys(claimed or []))  # dedup, keep order
        retrieved = [r["page"] for r in retrieval_results]
        validated = [p for p in claimed if p in retrieved]
        if len(validated) < min_pages:
            have = set(validated)
            for r in retrieval_results:
                if r["page"] not in have:
                    validated.append(r["page"])
                    have.add(r["page"])
                    if len(validated) >= min_pages:
                        break
        return validated[:max_pages]

    @staticmethod
    def _expand_adjacent_pages(core_pages: List[int], context_size: int = 2) -> Dict:
        """±context_size page window (reference :110-128)."""
        core = set(core_pages)
        expanded = set()
        for p in core_pages:
            for off in range(-context_size, context_size + 1):
                if p + off > 0:
                    expanded.add(p + off)
        return {
            "core_pages": sorted(core),
            "expanded_pages": sorted(expanded),
            "adjacent_pages": sorted(expanded - core),
        }

    def _page_text_for(self, sha1: str, page: int) -> str:
        return self._page_text.get((sha1, page), "")

    # --------------------------------------------- upstream group expansion
    def _build_page_groups(self, reranked: List[Dict], top_k: int, context_size: int):
        """Top-K cores ± context pages (reference :130-180)."""
        groups = []
        for gid, r in enumerate(reranked[:top_k]):
            core = r.get("page")
            if core is None:
                continue
            pages = [core + off for off in range(-context_size, context_size + 1) if core + off > 0]
            groups.append({
                "group_id": gid,
                "core_page": core,
                "core_score": (
                    r["combined_score"] if r.get("combined_score") is not None
                    else r.get("vector_similarity", r.get("distance", 0.0))
                ),
                "source_sha1": r.get("source_sha1", ""),
                "pages": pages,
                "core_index": pages.index(core) if core in pages else 0,
            })
        return groups

    def _load_group_chunks(self, groups: List[Dict], results: List[Dict]) -> List[Dict]:
        """Group pages → page chunks, dedup keeping best group score
        (reference :296-371)."""
        # page numbers repeat across a company's per-year documents, so
        # lookups prefer the result from the group's OWN document and fall
        # back to the best-ranked result for that page number
        by_page: Dict[int, List[Dict]] = {}
        for r in results:
            if r.get("page") is not None:
                by_page.setdefault(r["page"], []).append(r)

        def result_for(page, sha1):
            lst = by_page.get(page) or []
            for r in lst:
                if r.get("source_sha1", "") == sha1:
                    return r
            return lst[0] if lst else None

        chunks: Dict[tuple, Dict] = {}
        for g in groups:
            for page in g["pages"]:
                is_core = page == g["core_page"]
                hit = result_for(page, g["source_sha1"])
                if hit is not None:
                    text = hit.get("text", "")
                    vec = hit.get("vector_similarity", hit.get("distance", 0.0))
                else:
                    text = self._page_text_for(g["source_sha1"], page)
                    vec = g["core_score"]
                cand = {
                    "page": page,
                    "text": text,
                    "source_sha1": g["source_sha1"],
                    "is_core": is_core,
                    "group_score": g["core_score"],
                    "group_id": g["group_id"],
                    "core_page": g["core_page"],
                    "vector_similarity": vec,
                    "relevance_score": None,
                    "combined_score": g["core_score"] if is_core else None,
                }
                key = (g["source_sha1"], page)
                if key not in chunks or cand["group_score"] > chunks[key]["group_score"]:
                    chunks[key] = cand
        return list(chunks.values())

    @staticmethod
    def _identify_selected_groups(selected_pages: List[int], groups: List[Dict]):
        sel = set(selected_pages)
        return [g for g in groups if set(g["pages"]) & sel]

    # ------------------------------------------------------------ references
    def _extract_references(
        self, pages: List[int], results: List[Dict],
        expand_adjacent: bool = True, context_size: int = 2,
    ) -> List[Dict]:
        """Reference list with adjacent expansion flags (reference :373-445)."""
        # first (= best-ranked) result wins a contested page number —
        # page numbers repeat across a company's per-year documents
        page_to_sha1: Dict[int, str] = {}
        page_to_text: Dict[int, str] = {}
        for r in results:
            p = r.get("page")
            if p is None:
                continue
            page_to_sha1.setdefault(p, r.get("source_sha1", ""))
            page_to_text.setdefault(p, r.get("text", ""))
        if not expand_adjacent or not pages:
            return [
                {"pdf_sha1": page_to_sha1.get(p, ""), "page_index": p,
                 "chunk_text": page_to_text.get(p, ""), "is_expanded": False}
                for p in pages
            ]
        info = self._expand_adjacent_pages(pages, context_size)
        core = set(info["core_pages"])
        primary_sha1 = page_to_sha1.get(pages[0], "") if pages else ""
        refs = []
        for p in info["expanded_pages"]:
            sha1 = page_to_sha1.get(p, primary_sha1)
            text = page_to_text.get(p, "") if p in core else self._page_text_for(sha1, p)
            refs.append({
                "pdf_sha1": sha1, "page_index": p,
                "chunk_text": text, "is_expanded": p not in core,
            })
        return refs

    def _extract_references_from_groups(
        self, selected_pages: List[int], results: List[Dict], groups: List[Dict]
    ) -> List[Dict]:
        """Group-aware references (reference :243-294)."""
        # prefer the result from the group's own document (page numbers
        # repeat across a company's per-year docs); best-ranked fallback
        by_page: Dict[int, List[Dict]] = {}
        for r in results:
            if r.get("page") is not None:
                by_page.setdefault(r["page"], []).append(r)
        page_to_group: Dict[int, Dict] = {}
        for g in groups:
            for p in g["pages"]:
                page_to_group.setdefault(p, g)
        sel = set(selected_pages)
        refs = []
        for p in sorted(page_to_group):
            g = page_to_group[p]
            hit = next(
                (r for r in by_page.get(p, [])
                 if r.get("source_sha1", "") == g.get("source_sha1", "")),
                (by_page.get(p) or [None])[0],
            )
            if hit is not None:
                sha1 = hit.get("source_sha1", "")
                text = hit.get("text", "")
            else:
                sha1 = g.get("source_sha1", "")
                text = self._page_text_for(sha1, p)
            refs.append({
                "pdf_sha1": sha1, "page_index": p, "chunk_text": text,
                "is_expanded": p not in sel, "group_id": g.get("group_id"),
                "core_page": g.get("core_page"), "group_score": g.get("core_score"),
            })
        return refs

    @staticmethod
    def _format_all_retrieved_chunks(
        results: List[Dict], selected: List[int], expanded: Optional[List[int]] = None
    ) -> List[Dict]:
        sel, exp = set(selected), set(expanded or [])
        out = []
        for r in results:
            out.append({
                **{k: r.get(k) for k in (
                    "page", "text", "source_sha1", "distance", "vector_similarity",
                    "relevance_score", "combined_score", "hit_count", "method_count",
                )},
                "llm_selected": r.get("page") in sel,
                "is_expanded_page": r.get("page") in exp and r.get("page") not in sel,
            })
        return out

    # ------------------------------------------------------------- retrieval
    def _full_context_results(self, company: str) -> List[Dict]:
        """Every page of every company doc (reference src/retrieval.py:1821-1858)."""
        meta = self.engine.meta
        out = []
        for seg, (doc_id, page) in enumerate(meta.page_seg_info):
            doc = meta.docs[doc_id]
            if doc.company == company:
                out.append({
                    "page": page, "text": meta.page_texts.get(seg, ""),
                    "source_sha1": doc.sha1, "source_year": doc.year,
                    "distance": 0.5, "vector_similarity": 0.5,
                })
        if not out:
            raise ValueError(f"No report found with '{company}' company name.")
        return out

    def _retrieve(
        self, company: str, question: str,
        selected_years: Optional[Sequence[int]],
        timing: Dict[str, float],
        payload: Dict,
        progress_callback=None,
    ) -> List[Dict]:
        cfg = self.config
        if cfg.full_context:
            t0 = time.perf_counter()
            results = self._full_context_results(company)
            timing["retrieval"] = time.perf_counter() - t0
            return results

        # expansion (HyDE / multi-query) via the LLM provider
        exp = expand_query(
            self.llm.provider, question,
            use_hyde=cfg.use_hyde, use_multi_query=cfg.use_multi_query,
            multi_query_config=cfg.multi_query_methods,
        )
        timing.update(exp.timing)
        payload["expansion_texts"] = {
            "hyde_text": exp.hyde_text,
            "multi_query_texts": exp.multi_query_texts,
            "glossary_context": exp.glossary_context,
            "multi_query_methods": exp.multi_query_methods,
        }

        t0 = time.perf_counter()
        q_embs = self.embedder(exp.queries)
        timing["embedding_generation"] = time.perf_counter() - t0

        top_n = (
            cfg.llm_reranking_sample_size if cfg.llm_reranking else cfg.top_n_retrieval
        )
        # Size the padded query batch from the actual expansion fan-out,
        # bucketed to a few shapes (8 / 16 / 32, as the JAX package pads
        # them: the batch is K1's and the results must equal the JAX
        # engine's) instead of per question (HyDE + 3 multi-query methods
        # can exceed 8; the reference fans out every expanded query,
        # reference src/retrieval.py:1475-1504).
        n_q = max(1, len(exp.queries))
        max_q = next((b for b in (8, 16, 32) if n_q <= b), 32)
        if n_q > max_q:
            import warnings

            warnings.warn(
                f"query expansion produced {n_q} queries; only the first "
                f"{max_q} are searched",
                stacklevel=2,
            )
        # Size the doc-slot batch from the actual route the same way: every
        # routed document gets a slot (bucketed shapes, as above), so
        # multi-year routes never drop their oldest reports (reference src/retrieval.py:1475-1504 searches every
        # routed DB).
        if cfg.max_docs is not None:
            max_d = cfg.max_docs
        else:
            n_docs = len(
                self.engine.routed_docs(company, question, selected_years)
            )
            max_d = next((b for b in (8, 16, 32) if n_docs <= b), 32)
        scfg = SearchConfig(
            method=cfg.retrieval_method,
            top_k=min(top_n, 64),
            max_hops=cfg.max_hops,
            neighbor_k=cfg.neighbor_k,
            max_queries=max_q,
            max_docs=max_d,
            return_parent_pages=cfg.return_parent_pages,
            top_n=top_n,
            use_bm25=cfg.use_bm25,
            fuse_mode=cfg.fuse_mode if cfg.use_bm25 else "max",
            dense_weight=cfg.dense_weight if cfg.use_bm25 else 1.0,
            use_ivf=cfg.use_ivf,
            ivf_nprobe=cfg.ivf_nprobe,
            scan_rt=cfg.scan_rt,
        )
        t0 = time.perf_counter()
        wants_details = cfg.retrieval_method in (
            "ssg", "triangulation", "hybrid_expansion"
        )
        if self.batcher is not None and not wants_details:
            cands = self.batcher.search(
                q_embs, company, question, selected_years=selected_years,
                cfg=scfg, query_texts=exp.queries,
            )
        else:
            cands = self.engine.search(
                q_embs, company, question, selected_years=selected_years,
                cfg=scfg, query_texts=exp.queries, with_details=wants_details,
            )
        if wants_details:
            cands, dev_details = cands
            payload.update(self.engine.materialize_details(dev_details, scfg))
        results = self.engine.materialize(cands, scfg)
        timing["vector_search"] = time.perf_counter() - t0
        for r in results:
            r["vector_similarity"] = r["distance"]
        payload["initial_retrieval_results"] = [dict(r) for r in results]

        if cfg.llm_reranking and self.reranker is not None:
            t0 = time.perf_counter()
            results = self.reranker.rerank_documents(
                question, results, progress_callback=progress_callback
            )[: cfg.top_n_retrieval]
            timing["llm_reranking"] = time.perf_counter() - t0
            payload["reranker_stats"] = self.reranker.get_stats()
        return results

    # ------------------------------------------------------------- main flow
    def get_answer_for_company(
        self,
        company_name: str,
        question: str,
        schema: str,
        conversation_history: Optional[List[Dict]] = None,
        progress_callback=None,
        selected_years: Optional[List[int]] = None,
    ) -> Dict:
        cfg = self.config
        timing: Dict[str, float] = {}
        payload: Dict = {}
        total0 = time.perf_counter()

        if selected_years is None and cfg.use_year_routing:
            selected_years = extract_years_from_question(question) or None

        if progress_callback:
            progress_callback("📚 召回相关文档中...", 25)
        results = self._retrieve(
            company_name, question, selected_years, timing, payload, progress_callback
        )
        if not results:
            raise ValueError("No relevant context found")

        # upstream page-group expansion (reference :736-758)
        page_groups: List[Dict] = []
        if cfg.expand_upstream and cfg.llm_reranking:
            t0 = time.perf_counter()
            page_groups = self._build_page_groups(
                results, cfg.expand_top_k, cfg.expand_context_size
            )
            existing = {r["page"] for r in results}
            for chunk in self._load_group_chunks(page_groups, results):
                if chunk["page"] not in existing:
                    results.append(chunk)
            timing["upstream_expansion"] = time.perf_counter() - t0

        all_context = self._format_retrieval_results(results)
        question_ctx = self._build_contextual_question(question, conversation_history)

        if progress_callback:
            progress_callback("🎯 LLM选择相关页面中...", 75)
        # stage 1: page selection (reference :771-819)
        t0 = time.perf_counter()
        psp = prompts.PageSelectionPrompt
        selection = self.llm.send_message(
            system_content=psp.system_prompt,
            human_content=psp.user_prompt.format(
                question=question, pages_summary=all_context
            ),
            is_structured=True,
            response_format=psp.PageSelectionSchema,
        )
        selected_pages = selection.get("selected_pages", [])
        selection_reasoning = selection.get("reasoning", "")
        timing["page_selection"] = time.perf_counter() - t0

        retrieved_pages = {r["page"] for r in results}
        validated_selected = [p for p in selected_pages if p in retrieved_pages]
        if not validated_selected:
            validated_selected = [r["page"] for r in results[:5]]
        filtered = [r for r in results if r["page"] in set(validated_selected)]

        # stage 2: schema-typed answer (reference :821-840)
        if progress_callback:
            progress_callback("✍️ 生成最终答案中...", 80)
        rag_context = self._format_retrieval_results(filtered)
        t0 = time.perf_counter()
        answer = self.llm.get_answer_from_rag_context(
            question=question_ctx,
            rag_context=rag_context,
            schema=schema,
            model=cfg.answering_model,
        )
        timing["generate_answer"] = time.perf_counter() - t0
        timing["total_time"] = time.perf_counter() - total0

        # validated stage-1 selection first, the answer's claimed pages only
        # as fallback (reference src/questions_processing.py:907 prefers
        # validated_selected_pages; :536-568 then drops hallucinated ones)
        validated_pages = self._validate_page_references(
            validated_selected or answer.get("relevant_pages"), results
        )
        answer["relevant_pages"] = validated_pages
        if cfg.expand_upstream and page_groups:
            groups = self._identify_selected_groups(validated_pages, page_groups)
            answer["references"] = self._extract_references_from_groups(
                validated_pages, results, groups
            )
            answer["selected_groups"] = [
                {k: g[k] for k in ("group_id", "core_page", "core_score", "pages")}
                for g in groups
            ]
            expanded_pages = sorted({p for g in groups for p in g["pages"]})
        else:
            answer["references"] = self._extract_references(
                validated_pages, results, expand_adjacent=True, context_size=2
            )
            expanded_pages = self._expand_adjacent_pages(validated_pages, 2)["expanded_pages"]

        answer["all_retrieved_chunks"] = self._format_all_retrieved_chunks(
            results, validated_pages, expanded_pages
        )
        answer["timing"] = timing
        answer["prompt_info"] = {
            "rag_context": rag_context,
            "question": question_ctx,
            "schema": schema,
            "model": cfg.answering_model,
            "page_selection": {
                "selected_pages": validated_selected,
                "selection_reasoning": selection_reasoning,
            },
        }
        answer.update(payload)
        return answer

    # ------------------------------------------------------- question router
    def process_question(
        self, question: str, schema: str,
        conversation_history: Optional[List[Dict]] = None,
    ) -> Dict:
        companies = self._extract_companies(question)
        if not companies:
            raise ValueError("No company name found in the question.")
        if len(companies) == 1:
            return self.get_answer_for_company(
                companies[0], question, schema, conversation_history
            )
        return self.process_comparative_question(question, companies, schema)

    def process_comparative_question(
        self, question: str, companies: List[str], schema: str
    ) -> Dict:
        """Rephrase → per-company answers in parallel → aggregate
        (reference :1334-1399)."""
        sub_questions = self.llm.get_rephrased_questions(question, companies)

        def one(company: str) -> tuple:
            try:
                ans = self.get_answer_for_company(
                    company, sub_questions.get(company, question), "number"
                )
                return company, ans, None
            except Exception as e:
                return company, None, str(e)

        if self.config.parallel_requests > 1 and len(companies) > 1:
            with ThreadPoolExecutor(max_workers=len(companies)) as ex:
                answers = list(ex.map(one, companies))
        else:
            answers = [one(c) for c in companies]

        context_parts = []
        references: List[Dict] = []
        for company, ans, err in answers:
            if err or ans is None:
                context_parts.append(f"{company}: 获取失败 ({err})")
                continue
            context_parts.append(
                f"{company}: {ans.get('final_answer')}\n"
                f"依据: {ans.get('reasoning_summary', '')}"
            )
            references.extend(ans.get("references", []))

        final = self.llm.get_answer_from_rag_context(
            question=question,
            rag_context="\n\n".join(context_parts),
            schema="comparative",
            model=self.config.answering_model,
        )
        final["references"] = references
        final["sub_answers"] = {
            c: (a.get("final_answer") if a else None) for c, a, _ in answers
        }
        return final

    # ------------------------------------------------------------- batch API
    def process_questions_list(
        self,
        questions_list: List[Dict],
        output_path: Optional[str] = None,
        submission_file: bool = False,
        team_email: str = "",
        submission_name: str = "",
        pipeline_details: str = "",
    ) -> Dict:
        """Batched processing with incremental saves
        (reference :1104-1138; progress file rewritten after each batch)."""
        total = len(questions_list)
        questions = [{**q, "_question_index": i} for i, q in enumerate(questions_list)]
        self.answer_details = [None] * total
        processed: List[Dict] = []
        par = max(1, self.config.parallel_requests)

        def save():
            if output_path:
                self._save_progress(
                    processed, output_path, submission_file,
                    team_email, submission_name, pipeline_details,
                )

        if par <= 1:
            for q in questions:
                processed.append(self._process_single_question(q))
                save()
        else:
            for i in range(0, total, par):
                batch = questions[i : i + par]
                with ThreadPoolExecutor(max_workers=par) as ex:
                    processed.extend(ex.map(self._process_single_question, batch))
                save()

        stats = self._calculate_statistics(processed)
        return {
            "questions": processed,
            "answer_details": self.answer_details,
            "statistics": stats,
        }

    def _process_single_question(self, qdata: Dict) -> Dict:
        idx = qdata.get("_question_index", 0)
        text = qdata.get("question") or qdata.get("text")
        schema = qdata.get("schema") or qdata.get("kind")
        if not isinstance(text, str) or not text.strip():
            return {"error": "Invalid question text", "question": text, "schema": schema}
        try:
            answer = self.process_question(text, schema)
            ref = f"#/answer_details/{idx}"
            with self._lock:
                self.answer_details[idx] = {
                    "step_by_step_analysis": answer.get("step_by_step_analysis"),
                    "reasoning_summary": answer.get("reasoning_summary"),
                    "relevant_pages": answer.get("relevant_pages"),
                    "self": ref,
                }
            return {
                "question_text": text,
                "kind": schema,
                "value": answer.get("final_answer"),
                "references": answer.get("references", []),
                "answer_details": {"$ref": ref},
            }
        except Exception as err:
            ref = f"#/answer_details/{idx}"
            with self._lock:
                self.answer_details[idx] = {
                    "error_traceback": traceback.format_exc(),
                    "self": ref,
                }
            return {
                "question_text": text,
                "kind": schema,
                "value": None,
                "references": [],
                "error": f"{type(err).__name__}: {err}",
                "answer_details": {"$ref": ref},
            }

    @staticmethod
    def _calculate_statistics(processed: List[Dict]) -> Dict:
        total = len(processed)
        errors = sum(1 for q in processed if "error" in q)
        na = sum(1 for q in processed if q.get("value") == "N/A")
        return {
            "total_questions": total,
            "error_count": errors,
            "na_count": na,
            "success_count": total - errors - na,
        }

    def _post_process_submission_answers(self, processed: List[Dict]) -> List[Dict]:
        """Submission format: 1-based → 0-based pages, value fallback
        (reference :1240-1294)."""
        out = []
        for q in processed:
            value = "N/A" if "error" in q else q.get("value")
            refs = [
                {
                    "pdf_sha1": r["pdf_sha1"],
                    "page_index": r["page_index"] - 1,
                    "chunk_text": r.get("chunk_text", ""),
                }
                for r in q.get("references", [])
            ]
            analysis = None
            ref_str = q.get("answer_details", {}).get("$ref", "")
            if ref_str.startswith("#/answer_details/"):
                try:
                    i = int(ref_str.rsplit("/", 1)[-1])
                    if 0 <= i < len(self.answer_details) and self.answer_details[i]:
                        analysis = self.answer_details[i].get("step_by_step_analysis")
                except ValueError:
                    pass
            out.append({
                "question_text": q.get("question_text") or q.get("question"),
                "kind": q.get("kind") or q.get("schema"),
                "value": value,
                "references": refs,
                "reasoning_process": analysis,
            })
        return out

    def _save_progress(
        self,
        processed: List[Dict],
        output_path: str,
        submission_file: bool = False,
        team_email: str = "",
        submission_name: str = "",
        pipeline_details: str = "",
    ) -> None:
        """Rewrite the debug file (and submission file) after every batch
        (reference :1295-1321)."""
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        debug = {
            "questions": processed,
            "answer_details": self.answer_details,
            "statistics": self._calculate_statistics(processed),
        }
        debug_path = output_path.with_name(output_path.stem + "_debug" + output_path.suffix)
        with open(debug_path, "w", encoding="utf-8") as f:
            json.dump(debug, f, ensure_ascii=False, indent=2)
        if submission_file:
            submission = {
                "team_email": team_email,
                "submission_name": submission_name,
                "pipeline_details": pipeline_details,
                "answers": self._post_process_submission_answers(processed),
            }
            with open(output_path, "w", encoding="utf-8") as f:
                json.dump(submission, f, ensure_ascii=False, indent=2)
        else:
            with open(output_path, "w", encoding="utf-8") as f:
                json.dump(debug, f, ensure_ascii=False, indent=2)
