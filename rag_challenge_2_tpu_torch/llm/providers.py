"""Provider-agnostic chat clients.

Replaces the reference's four SDK-bound processor classes
(reference src/api_requests.py:55-613: Qwen/Dashscope, OpenAI, IBM WatsonX,
Gemini) with plain-HTTP clients speaking the two dominant protocols —
OpenAI-compatible ``/chat/completions`` (OpenAI, Dashscope compatible mode,
vLLM, IBM proxies) and Google ``generateContent`` — plus an offline stub
for tests (SURVEY.md §4: "no network, no LLM — stub the expansion and
rerank stages behind interfaces").

Configuration is strictly env/arg-driven.  The reference committed live
API keys to source (SURVEY.md security note); none appear here.

Structured output = prompt-for-JSON → lenient parse → pydantic validate →
one LLM repair round → safe default, the reference's fallback chain
(src/api_requests.py:210-249, :420-446) without SDK `parse` helpers.

Port of ``rag_challenge_2_tpu/llm/providers.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Type

import requests
from pydantic import BaseModel

from .jsonfix import loads_lenient
from . import prompts


class ProviderError(RuntimeError):
    pass


def _safe_default(schema: Type[BaseModel]) -> Dict[str, Any]:
    """Schema-shaped dict of neutral values (the reference's last resort,
    src/api_requests.py:243-249)."""
    out: Dict[str, Any] = {}
    for name, field in schema.model_fields.items():
        ann = str(field.annotation)
        if "List" in ann or "list" in ann:
            out[name] = []
        elif "str" in ann or "N/A" in ann:
            # any union admitting text or the explicit no-answer literal
            # (e.g. number's float|int|Literal['N/A']) defaults to "N/A" —
            # a failed parse must never fabricate a confident 0
            out[name] = "N/A"
        elif "bool" in ann:
            out[name] = False
        elif "float" in ann or "int" in ann:
            out[name] = 0
        else:
            out[name] = "N/A"
    return out


class ChatProvider:
    """Interface: ``send_message`` returns text, or a validated dict when
    ``response_format`` (a pydantic schema) is given."""

    default_model: str = ""

    def _complete(self, model, system_content, human_content, temperature, **kw) -> str:
        raise NotImplementedError

    # retry knobs (reference uses tenacity wait 50s × 3, 429-aware —
    # src/api_requests.py:136-140; configurable so tests run instantly)
    retries: int = 3
    retry_wait: float = 5.0

    def send_message(
        self,
        model: Optional[str] = None,
        temperature: float = 0.5,
        seed: Optional[int] = None,
        system_content: str = "You are a helpful assistant.",
        human_content: str = "Hello!",
        is_structured: bool = False,
        response_format: Optional[Type[BaseModel]] = None,
        **kwargs,
    ):
        model = model or self.default_model
        if is_structured and response_format is not None:
            schema_json = json.dumps(
                response_format.model_json_schema(), ensure_ascii=False
            )
            system_content = (
                f"{system_content}\n\n只输出一个符合此 JSON Schema 的 JSON 对象，"
                f"不要输出其他内容:\n{schema_json}"
            )
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                text = self._complete(
                    model, system_content, human_content, temperature, seed=seed, **kwargs
                )
                break
            except Exception as e:  # includes 429s; wait and retry
                last_err = e
                if attempt + 1 < self.retries:
                    time.sleep(self.retry_wait)
        else:
            raise ProviderError(f"provider failed after {self.retries} tries: {last_err}")

        if not (is_structured and response_format is not None):
            return text
        return self._validate(text, response_format, model)

    def _validate(self, text: str, schema: Type[BaseModel], model: str) -> Dict[str, Any]:
        data = loads_lenient(text)
        if data is not None:
            try:
                return schema.model_validate(data).model_dump()
            except Exception:
                pass
        # one repair round via the fix prompt (reference :420-446)
        try:
            fixed = self._complete(
                model,
                prompts.AnswerSchemaFixPrompt.system_prompt,
                prompts.AnswerSchemaFixPrompt.user_prompt.format(
                    schema=json.dumps(schema.model_json_schema(), ensure_ascii=False),
                    response=text,
                ),
                0.0,
            )
            data = loads_lenient(fixed)
            if data is not None:
                return schema.model_validate(data).model_dump()
        except Exception:
            pass
        return _safe_default(schema)


class OpenAICompatProvider(ChatProvider):
    """Any OpenAI-compatible endpoint: OpenAI, Dashscope compatible-mode
    (the reference's qwen path), vLLM, proxies."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        default_model: Optional[str] = None,
        timeout: float = 120.0,
    ):
        self.base_url = (base_url or os.environ.get(
            "RAGTPU_LLM_BASE_URL",
            "https://dashscope.aliyuncs.com/compatible-mode/v1",
        )).rstrip("/")
        self.api_key = api_key or os.environ.get("RAGTPU_LLM_API_KEY", "")
        self.default_model = default_model or os.environ.get(
            "RAGTPU_LLM_MODEL", "qwen-turbo"
        )
        self.timeout = timeout

    def _complete(self, model, system_content, human_content, temperature, seed=None, **kw):
        payload: Dict[str, Any] = {
            "model": model,
            "temperature": temperature,
            "messages": [
                {"role": "system", "content": system_content},
                {"role": "user", "content": human_content},
            ],
        }
        if seed is not None:
            payload["seed"] = seed
        r = requests.post(
            f"{self.base_url}/chat/completions",
            json=payload,
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=self.timeout,
        )
        if r.status_code == 429:
            raise ProviderError("rate limited (429)")
        r.raise_for_status()
        return r.json()["choices"][0]["message"]["content"]


class GeminiProvider(ChatProvider):
    """Google generateContent REST (reference src/api_requests.py:470-613)."""

    def __init__(self, api_key: Optional[str] = None, default_model: str = "gemini-2.0-flash", timeout: float = 120.0):
        self.api_key = api_key or os.environ.get("RAGTPU_GEMINI_API_KEY", "")
        self.default_model = default_model
        self.timeout = timeout

    def _complete(self, model, system_content, human_content, temperature, **kw):
        url = (
            "https://generativelanguage.googleapis.com/v1beta/models/"
            f"{model}:generateContent?key={self.api_key}"
        )
        payload = {
            "system_instruction": {"parts": [{"text": system_content}]},
            "contents": [{"role": "user", "parts": [{"text": human_content}]}],
            "generationConfig": {"temperature": temperature},
        }
        r = requests.post(url, json=payload, timeout=self.timeout)
        if r.status_code == 429:
            raise ProviderError("rate limited (429)")
        r.raise_for_status()
        return r.json()["candidates"][0]["content"]["parts"][0]["text"]


class StubProvider(ChatProvider):
    """Deterministic offline provider for tests and air-gapped runs.

    Responses can be scripted per substring-match on the user content;
    unmatched structured calls return a schema default, unmatched text
    calls echo a canned line.  Records every call for assertions.
    """

    default_model = "stub"
    retries = 1
    retry_wait = 0.0

    def __init__(self, scripted: Optional[Dict[str, Any]] = None):
        self.scripted = dict(scripted or {})
        self.calls = []

    def _complete(self, model, system_content, human_content, temperature, **kw):
        self.calls.append({
            "model": model,
            "system": system_content,
            "user": human_content,
            "temperature": temperature,
        })
        for needle, resp in self.scripted.items():
            if needle in human_content or needle in system_content:
                return resp if isinstance(resp, str) else json.dumps(resp, ensure_ascii=False)
        return "<SKIP>"


PROVIDERS = {
    "openai": OpenAICompatProvider,
    "qwen": OpenAICompatProvider,
    "dashscope": OpenAICompatProvider,
    "gemini": GeminiProvider,
    "stub": StubProvider,
}


def get_provider(name: str = "qwen", **kwargs) -> ChatProvider:
    try:
        return PROVIDERS[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown provider {name!r}; options: {sorted(PROVIDERS)}")
