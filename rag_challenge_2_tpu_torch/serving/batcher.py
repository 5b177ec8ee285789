"""Cross-request micro-batching for the serving path.

Port of ``rag_challenge_2_tpu/serving/batcher.py``.  Concurrent requests
that share a route (the common case: the deployed corpus is one company,
and most questions carry no year filter) can ride one pass of
``QueryEngine.search_many``: the requests' queries are stacked per routed
document slot, so the store's rows are read once per micro-batch instead
of once per question (kernel K1 up to 64 stacked queries, K3 above).

``MicroBatcher`` is the host-side coalescer: calling threads enqueue their
request under a group key (route + search config); the first thread of a
group becomes the dispatcher, waits ``window_ms`` for followers, then runs
the batched search and hands each waiter its own ``FusedCandidates``.
Requests with distinct routes or configs never batch; a group is
dispatched eagerly once ``max_batch`` requests are waiting, and overflow
beyond ``max_batch`` is led by a promoted waiter, so no request is ever
dropped.

Semantics are identical to unbatched ``QueryEngine.search``
(tests/test_torch_batcher.py).  While the program's spans are collected
(``utils/profiling.py``) each caller records ``batcher.wait`` on its own
thread, from enqueueing its request to its group's dispatch starting,
and the leader opens ``batcher.dispatch`` around the batched search,
listing the requests it serves.  The JAX package turns batching off above a
corpus size it measured on its own hardware; the port has no such rule and
always coalesces.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..retrieval.engine import QueryEngine, SearchConfig
from ..utils import profiling


class _Pending:
    __slots__ = ("q_embs", "query_texts", "event", "result", "error", "rid",
                 "t_enqueued", "t_dispatched")

    def __init__(self, q_embs, query_texts):
        self.q_embs = q_embs
        self.query_texts = query_texts
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        # the request's id and its wait's ends (tracing on; else None / 0)
        self.rid = profiling.request_id()
        self.t_enqueued = profiling.now_ns()
        self.t_dispatched = 0

    def waited(self) -> None:
        """Record ``batcher.wait`` once the request's dispatch has started."""
        if self.t_enqueued and self.t_dispatched:
            profiling.record("batcher.wait", self.t_enqueued, self.t_dispatched,
                             request=self.rid)


class _Group:
    __slots__ = ("items", "leader_present")

    def __init__(self):
        self.items: List[_Pending] = []
        self.leader_present = False


class MicroBatcher:
    """Coalesces concurrent `search` calls into `search_many` dispatches.

    Thread-safe; one instance is shared by every user of a webapp /
    batch-QA run.  ``window_ms`` bounds the added latency for a lone
    request (a request that arrives while its group's dispatcher is
    already collecting rides along at zero extra wait).
    """

    def __init__(
        self,
        engine: QueryEngine,
        max_batch: int = 8,
        window_ms: float = 4.0,
    ):
        self.engine = engine
        self.max_batch = max(1, int(max_batch))
        self.window_ms = float(window_ms)
        self._lock = threading.Lock()
        self._groups: Dict[tuple, _Group] = {}
        # observability: dispatch count + request/batching totals
        self.stats = {"dispatches": 0, "requests": 0, "batched_requests": 0}

    # ---------------------------------------------------------------- keys
    def _group_key(
        self,
        company: Optional[str],
        question: str,
        selected_years: Optional[Sequence[int]],
        cfg: SearchConfig,
    ) -> tuple:
        # Key on the RESOLVED route (the routed doc ids), not the raw
        # (company, years) inputs: distinct year filters often resolve to
        # the same documents (a year with no report falls back to all
        # company docs — routing.route_core), and those requests can share
        # a dispatch.  Only members routing to the same documents may
        # batch; the leader's (company, years) then resolves identically
        # for everyone in the group.
        doc_ids = tuple(
            self.engine.routed_docs(company, question, selected_years)
        )
        if not doc_ids:
            # fail HERE, per-request, instead of poisoning a batch
            raise ValueError(
                f"No report found with '{company}' company name."
            )
        return (company, doc_ids, cfg)

    # -------------------------------------------------------------- public
    def search(
        self,
        query_embs: np.ndarray,
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
        cfg: SearchConfig = SearchConfig(),
        query_texts: Optional[Sequence[str]] = None,
    ):
        """Drop-in for ``QueryEngine.search(..., with_details=False)``."""
        key = self._group_key(company, question, selected_years, cfg)
        if not query_texts and cfg.use_bm25:
            # bind the per-request BM25 fallback HERE (None AND empty —
            # the engine treats both as falsy): inside a batch the
            # engine's [question] default would be the LEADER's question,
            # cross-request contamination for every follower
            query_texts = [question]
        item = _Pending(query_embs, query_texts)
        with self._lock:
            self.stats["requests"] += 1
            group = self._groups.get(key)
            if group is None:
                group = _Group()
                self._groups[key] = group
            group.items.append(item)
            leader = not group.leader_present
            group.leader_present = True

        while True:
            if not leader:
                item.event.wait()
                item.waited()
                if item.error is not None:
                    raise item.error
                if item.result is not None:
                    return item.result
                # promoted: the previous leader dispatched a full batch and
                # woke this waiter to lead the overflow (item still queued)
                item.event.clear()
                leader = True

            # ---- leader: collect followers, dispatch, promote overflow ----
            deadline = time.monotonic() + self.window_ms / 1000.0
            while time.monotonic() < deadline:
                with self._lock:
                    if len(group.items) >= self.max_batch:
                        break
                time.sleep(self.window_ms / 1000.0 / 8)
            with self._lock:
                taken = group.items[: self.max_batch]
                group.items = group.items[self.max_batch:]
                promoted = group.items[0] if group.items else None
                if promoted is None:
                    group.leader_present = False
                    if not group.items:
                        del self._groups[key]
            t_dispatched = profiling.now_ns()
            for p in taken:
                p.t_dispatched = t_dispatched
            item.waited()
            try:
                with profiling.span("batcher.dispatch", request=item.rid,
                                    count=len(taken)) as sp:
                    if sp is not None:
                        sp.attrs["requests"] = [p.rid for p in taken]
                    results = self.engine.search_many(
                        [p.q_embs for p in taken],
                        company,
                        question,
                        selected_years=selected_years,
                        cfg=cfg,
                        query_texts_list=[p.query_texts for p in taken],
                    )
                with self._lock:
                    self.stats["dispatches"] += 1
                    self.stats["batched_requests"] += len(taken)
                for p, r in zip(taken, results):
                    p.result = r
                    p.event.set()
            except BaseException as e:
                for p in taken:
                    p.error = e
                    p.event.set()
                raise
            finally:
                if promoted is not None:
                    promoted.event.set()   # becomes the overflow's leader
            return item.result
