"""Tolerant JSON extraction from LLM output.

Replaces the reference's dependency on ``json_repair``
(reference src/api_requests.py:210-249 runs json_repair → pydantic →
reparse-via-LLM → safe default).  Handles the common failure modes of
structured-output models: markdown code fences, leading prose, trailing
commas, single quotes, unbalanced braces from truncation.

Port of ``rag_challenge_2_tpu/llm/jsonfix.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

_FENCE = re.compile(r"```(?:json)?\s*(.*?)```", re.S)


def _strip_to_json(text: str) -> str:
    m = _FENCE.search(text)
    if m:
        text = m.group(1)
    # first balanced {...} or [...] — whichever bracket appears FIRST wins,
    # so a top-level array of objects is not truncated to its first object
    starts = [(text.find(o), o, c) for o, c in (("{", "}"), ("[", "]"))]
    starts = sorted((s, o, c) for s, o, c in starts if s >= 0)
    for start, opener, closer in starts:
        depth = 0
        in_str = False
        esc = False
        for i in range(start, len(text)):
            c = text[i]
            if in_str:
                if esc:
                    esc = False
                elif c == "\\":
                    esc = True
                elif c == '"':
                    in_str = False
                continue
            if c == '"':
                in_str = True
            elif c == opener:
                depth += 1
            elif c == closer:
                depth -= 1
                if depth == 0:
                    return text[start : i + 1]
        # truncated: close what's open
        return text[start:] + closer * depth
    return text


def loads_lenient(text: str) -> Optional[Any]:
    """Best-effort parse; None when nothing JSON-like is recoverable."""
    if not isinstance(text, str) or not text.strip():
        return None
    candidate = _strip_to_json(text.strip())
    for attempt in (
        candidate,
        re.sub(r",\s*([}\]])", r"\1", candidate),                  # trailing commas
        re.sub(r"(?<=[{,\s])'([^']*)'(?=\s*:)", r'"\1"', candidate # single-quoted keys
              ).replace(": '", ': "').replace("',", '",').replace("'}", '"}'),
    ):
        try:
            return json.loads(attempt)
        except Exception:
            continue
    return None
