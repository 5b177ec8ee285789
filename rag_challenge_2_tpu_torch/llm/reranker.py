"""LLM reranking of retrieval candidates.

Behavioural port of the reference reranker (reference src/reranking.py):
token-interval rate limiting (:12-30), env-driven knobs (:67-77), batch
scoring with per-batch fallback to single-doc on error/mismatch
(:335-368), combined score = ``relevance_score × vector_similarity``
(:320-323, :363-366), rolling stats (:92-133).  Provider-agnostic: any
ChatProvider (incl. the offline stub) plugs in.

Port of ``rag_challenge_2_tpu/llm/reranker.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from threading import Lock
from typing import Callable, Dict, List, Optional

from . import prompts
from .providers import ChatProvider, get_provider


class RateLimiter:
    """Thread-safe minimum-interval limiter (reference src/reranking.py:12-30)."""

    def __init__(self, qps: float):
        self.interval = 1.0 / qps if qps > 0 else 0.0
        self._lock = Lock()
        self._last = 0.0

    def acquire(self) -> None:
        if self.interval <= 0:
            return
        with self._lock:
            now = time.monotonic()
            wait = self._last + self.interval - now
            if wait > 0:
                time.sleep(wait)
                now = time.monotonic()
            self._last = now


class JinaReranker:
    """HTTP reranker client (reference src/reranking.py:33-55 — present in
    the reference but unused by its pipeline; kept for inventory parity).
    POSTs {model, query, documents, top_n} to a Jina-compatible /rerank
    endpoint and returns [{index, relevance_score}] ordered results."""

    def __init__(self, api_key: Optional[str] = None,
                 model: str = "jina-reranker-v2-base-multilingual",
                 base_url: str = "https://api.jina.ai/v1/rerank",
                 timeout: float = 60.0):
        self.api_key = api_key or os.environ.get("JINA_API_KEY", "")
        self.model = model
        self.base_url = base_url
        self.timeout = timeout

    def rerank(self, query: str, documents: List[str], top_n: Optional[int] = None):
        import requests

        r = requests.post(
            self.base_url,
            json={"model": self.model, "query": query,
                  "documents": documents, "top_n": top_n or len(documents)},
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=self.timeout,
        )
        r.raise_for_status()
        return r.json().get("results", [])


class LLMReranker:
    def __init__(
        self,
        provider: ChatProvider | str | None = None,
        model: Optional[str] = None,
        max_concurrent_requests: int = 10,
    ):
        provider = provider or os.environ.get("LLM_RERANK_PROVIDER", "qwen")
        self.provider = (
            provider if isinstance(provider, ChatProvider) else get_provider(provider)
        )
        self.model = model or os.environ.get("LLM_RERANK_MODEL") or None
        self.max_concurrent_requests = max_concurrent_requests
        self.rate_limit_qps = float(os.environ.get("LLM_RERANK_QPS", "5"))
        self.rate_limiter = RateLimiter(self.rate_limit_qps)
        self._stats_lock = Lock()
        self.reset_stats()

    # -- stats (contract of reference src/reranking.py:92-133) ----------
    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats: Dict = {
                "total_requests": 0,
                "successful_requests": 0,
                "failed_requests": 0,
                "batch_fallbacks": 0,
                "missing_rankings": 0,
                "avg_llm_latency": 0.0,
                "last_error": None,
            }
            self._latency_acc = 0.0

    def _record(self, ok: bool, duration: float = 0.0, error: Optional[str] = None):
        with self._stats_lock:
            self.stats["total_requests"] += 1
            if ok:
                self.stats["successful_requests"] += 1
                self._latency_acc += duration
                self.stats["avg_llm_latency"] = round(
                    self._latency_acc / self.stats["successful_requests"], 4
                )
            else:
                self.stats["failed_requests"] += 1
                if error:
                    self.stats["last_error"] = error

    def get_stats(self) -> Dict:
        with self._stats_lock:
            s = dict(self.stats)
        total = s["total_requests"]
        s["success_rate"] = round(s["successful_requests"] / total, 4) if total else 0.0
        s["request_rate_limit"] = self.rate_limit_qps
        s["max_concurrent_requests"] = self.max_concurrent_requests
        return s

    # -- scoring ---------------------------------------------------------
    def _send(self, system: str, user: str, schema) -> Dict:
        self.rate_limiter.acquire()
        t0 = time.perf_counter()
        try:
            out = self.provider.send_message(
                model=self.model,
                system_content=system,
                human_content=user,
                is_structured=True,
                response_format=schema,
                temperature=0.0,
            )
            self._record(True, time.perf_counter() - t0)
            return out
        except Exception as e:
            self._record(False, error=str(e))
            raise

    def get_rank_for_single_block(self, query: str, block: str) -> Dict:
        rp = prompts.RerankingPrompt
        return self._send(
            rp.system_prompt_rerank_single_block,
            rp.user_prompt_single.format(query=query, document=block),
            rp.RetrievalRankingSingleBlock,
        )

    def get_rank_for_multiple_blocks(self, query: str, blocks: List[str]) -> Dict:
        rp = prompts.RerankingPrompt
        numbered = "\n\n".join(f"【文本块 {i+1}】\n{b}" for i, b in enumerate(blocks))
        return self._send(
            rp.system_prompt_rerank_multiple_blocks,
            rp.user_prompt_multiple.format(query=query, documents=numbered),
            rp.RetrievalRankingMultipleBlocks,
        )

    # -- main entry (reference src/reranking.py:286-379) -----------------
    def rerank_documents(
        self,
        query: str,
        documents: List[Dict],
        documents_batch_size: int = 4,
        progress_callback: Optional[Callable] = None,
    ) -> List[Dict]:
        """Combined score is the plain product relevance × vector_similarity.

        The reference declares an ``llm_weight=0.7`` knob but never applies
        it (reference src/reranking.py:286,300 compute ``vector_weight`` and
        drop it; both scoring paths multiply directly :320-323,:363-366).
        We keep the *behavior* (product) and drop the dead parameter.
        """
        self.reset_stats()

        def tagged(doc: Dict) -> str:
            return f"[来源: {doc.get('source_sha1', 'Unknown')}]\n{doc.get('text', '')}"

        def vector_sim(doc: Dict) -> float:
            return float(doc.get("vector_similarity", doc.get("distance", 0.0)))

        def score_single(doc: Dict) -> Dict:
            out = dict(doc)
            try:
                ranking = self.get_rank_for_single_block(query, tagged(doc))
                out["relevance_score"] = float(ranking.get("relevance_score", 0.0))
                out["reasoning"] = ranking.get("reasoning", "")
            except Exception as e:
                out["relevance_score"] = 0.0
                out["reasoning"] = f"rerank failed: {e}"
            out["combined_score"] = round(out["relevance_score"] * vector_sim(doc), 4)
            return out

        def score_batch(batch: List[Dict]) -> List[Dict]:
            try:
                rankings = self.get_rank_for_multiple_blocks(query, [tagged(d) for d in batch])
                blocks = rankings.get("block_rankings", [])
            except Exception:
                with self._stats_lock:
                    self.stats["batch_fallbacks"] += 1
                return [score_single(d) for d in batch]
            if len(blocks) != len(batch):
                with self._stats_lock:
                    self.stats["missing_rankings"] += abs(len(batch) - len(blocks))
                    self.stats["batch_fallbacks"] += 1
                return [score_single(d) for d in batch]
            out = []
            for doc, rank in zip(batch, blocks):
                d = dict(doc)
                d["relevance_score"] = float(rank.get("relevance_score", 0.0))
                d["reasoning"] = rank.get("reasoning", "")
                d["combined_score"] = round(d["relevance_score"] * vector_sim(doc), 4)
                out.append(d)
            return out

        batches = [
            documents[i : i + documents_batch_size]
            for i in range(0, len(documents), max(1, documents_batch_size))
        ]
        results: List[Dict] = []
        if documents_batch_size <= 1:
            work, fn = documents, score_single
        else:
            work, fn = batches, score_batch
        if len(work) <= 1 or self.max_concurrent_requests <= 1:
            mapped = [fn(w) for w in work]
        else:
            with ThreadPoolExecutor(max_workers=self.max_concurrent_requests) as ex:
                mapped = list(ex.map(fn, work))
        for m in mapped:
            results.extend(m if isinstance(m, list) else [m])
        if progress_callback:
            progress_callback("🎯 重排序完成", 70)
        results.sort(key=lambda x: x["combined_score"], reverse=True)
        return results
