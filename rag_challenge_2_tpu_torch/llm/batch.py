"""Async bulk LLM requests with token/request rate budgeting.

Re-implementation of the reference's parallel-request engine
(reference src/api_request_parallel_processor.py, the OpenAI-cookbook
design): an asyncio loop with dual capacity buckets (requests/min and
tokens/min) refilled continuously, a retry queue, jsonl-streamed results,
and a status tracker — speaking the OpenAI-compatible protocol via
aiohttp.  Plus the jsonl-driven structured-output wrapper that
``AsyncOpenaiProcessor`` layered on top (reference
src/api_requests.py:828-978).

Port of ``rag_challenge_2_tpu/llm/batch.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Type

from pydantic import BaseModel

from .jsonfix import loads_lenient


@dataclasses.dataclass
class StatusTracker:
    num_tasks_started: int = 0
    num_tasks_in_progress: int = 0
    num_tasks_succeeded: int = 0
    num_tasks_failed: int = 0
    num_rate_limit_errors: int = 0
    num_api_errors: int = 0
    num_other_errors: int = 0
    time_of_last_rate_limit_error: float = 0.0


def _estimate_tokens(payload: Dict) -> int:
    """Cheap request-size estimate for the token bucket (the reference uses
    tiktoken; offline we approximate chars/4 + completion budget)."""
    text = json.dumps(payload.get("messages", ""), ensure_ascii=False)
    return len(text) // 4 + int(payload.get("max_tokens", 256))


async def process_api_requests(
    requests: List[Dict],
    base_url: str,
    api_key: str,
    max_requests_per_minute: float = 1500,
    max_tokens_per_minute: float = 125_000,
    max_attempts: int = 5,
    results_path: Optional[Path] = None,
    status: Optional[StatusTracker] = None,
) -> List[Dict]:
    """Run every request dict (OpenAI chat-completions payload) under the
    rate budget; returns [{"request", "response"|"error"}] in input order;
    streams each finished record to ``results_path`` as jsonl if given."""
    import aiohttp

    status = status or StatusTracker()
    results: List[Optional[Dict]] = [None] * len(requests)
    queue: asyncio.Queue = asyncio.Queue()
    for i, r in enumerate(requests):
        queue.put_nowait((i, r, max_attempts))

    req_capacity = max_requests_per_minute
    tok_capacity = max_tokens_per_minute
    last_update = time.monotonic()
    lock = asyncio.Lock()
    out_f = open(results_path, "a", encoding="utf-8") if results_path else None

    async def acquire(tokens_needed: int):
        nonlocal req_capacity, tok_capacity, last_update
        while True:
            async with lock:
                now = time.monotonic()
                dt = now - last_update
                last_update = now
                req_capacity = min(req_capacity + max_requests_per_minute * dt / 60,
                                   max_requests_per_minute)
                tok_capacity = min(tok_capacity + max_tokens_per_minute * dt / 60,
                                   max_tokens_per_minute)
                if req_capacity >= 1 and tok_capacity >= tokens_needed:
                    req_capacity -= 1
                    tok_capacity -= tokens_needed
                    return
            await asyncio.sleep(0.05)

    # Tasks not yet finalized (success or permanent failure).  Workers must
    # not exit on an empty queue while retries may still be re-queued —
    # otherwise one surviving worker drains every retry sequentially.
    unfinished = len(requests)

    async def worker(session):
        nonlocal unfinished
        while unfinished > 0:
            try:
                i, payload, attempts = queue.get_nowait()
            except asyncio.QueueEmpty:
                await asyncio.sleep(0.05)
                continue
            # clamp: an estimate above the whole per-minute budget can
            # never be satisfied and would busy-wait forever
            await acquire(min(_estimate_tokens(payload), max_tokens_per_minute))
            status.num_tasks_started += 1
            status.num_tasks_in_progress += 1
            try:
                # the try covers ONLY the HTTP exchange: an exception in
                # the success bookkeeping below (e.g. a jsonl write error)
                # must never re-queue an already-finalized request — that
                # would decrement `unfinished` twice and make workers exit
                # while other requests still sit in the queue
                async with session.post(
                    f"{base_url.rstrip('/')}/chat/completions",
                    json=payload,
                    headers={"Authorization": f"Bearer {api_key}"},
                ) as resp:
                    body = await resp.json(content_type=None)
                    if resp.status == 429:
                        status.num_rate_limit_errors += 1
                        status.time_of_last_rate_limit_error = time.time()
                        raise RuntimeError("rate limited")
                    if resp.status >= 400 or "error" in body:
                        status.num_api_errors += 1
                        raise RuntimeError(str(body.get("error", resp.status)))
            except Exception as e:
                if attempts > 1:
                    # back off BEFORE re-queueing: with the item already in
                    # the queue an idle peer retries it instantly and a
                    # one-second 429 burst burns every attempt in ~150 ms
                    await asyncio.sleep(1.0)
                    queue.put_nowait((i, payload, attempts - 1))
                else:
                    status.num_tasks_failed += 1
                    record = {"request": payload, "error": str(e)}
                    results[i] = record
                    unfinished -= 1
                    if out_f:
                        try:
                            out_f.write(json.dumps(record, ensure_ascii=False) + "\n")
                            out_f.flush()
                        except OSError:
                            pass  # streaming is best-effort; results[] holds it
            else:
                record = {"request": payload, "response": body}
                results[i] = record
                unfinished -= 1
                status.num_tasks_succeeded += 1
                if out_f:
                    try:
                        out_f.write(json.dumps(record, ensure_ascii=False) + "\n")
                        out_f.flush()
                    except OSError:
                        pass  # streaming is best-effort; results[] holds it
            finally:
                status.num_tasks_in_progress -= 1
            queue.task_done()

    async with aiohttp.ClientSession() as session:
        workers = [asyncio.create_task(worker(session)) for _ in range(16)]
        await asyncio.gather(*workers)
    if out_f:
        try:
            out_f.close()
        except OSError:
            pass  # best-effort streaming; results[] is authoritative
    return [r for r in results if r is not None]


def process_structured_requests(
    texts_and_prompts: List[Dict],
    schema: Type[BaseModel],
    model: str,
    base_url: str,
    api_key: str,
    temperature: float = 0.0,
    **rate_kwargs,
) -> List[Optional[Dict[str, Any]]]:
    """Structured-output batch: builds chat payloads with the JSON-schema
    instruction, runs them under the budget, validates each response
    (contract of reference src/api_requests.py:841-978)."""
    schema_json = json.dumps(schema.model_json_schema(), ensure_ascii=False)
    requests = []
    for item in texts_and_prompts:
        requests.append({
            "model": model,
            "temperature": temperature,
            "messages": [
                {"role": "system", "content": (
                    f"{item.get('system', '')}\n\n只输出符合此 JSON Schema 的 "
                    f"JSON 对象:\n{schema_json}"
                )},
                {"role": "user", "content": item.get("user", "")},
            ],
        })
    records = asyncio.run(
        process_api_requests(requests, base_url, api_key, **rate_kwargs)
    )
    out: List[Optional[Dict]] = []
    for rec in records:
        if "error" in rec:
            out.append(None)
            continue
        try:
            content = rec["response"]["choices"][0]["message"]["content"]
            data = loads_lenient(content)
            out.append(schema.model_validate(data).model_dump() if data else None)
        except Exception:
            out.append(None)
    return out
