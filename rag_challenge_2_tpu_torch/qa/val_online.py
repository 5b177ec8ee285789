"""Interactive QA REPL + batch validation runner.

Equivalent of the reference's ``ValOnline`` (reference src/val_online.py):
a terminal loop over the built index with company auto-prefixing, the
jingpan schema by default, conversation history threading, and a batch
mode over a question CSV/JSON with history persisted to disk.

Port of ``rag_challenge_2_tpu/qa/val_online.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

from .processor import QuestionsProcessor


class ValOnline:
    def __init__(
        self,
        processor: QuestionsProcessor,
        default_company: str = "金盘科技",
        schema: str = "jingpan",
        history_path: Optional[Path] = None,
        max_history: int = 5,
    ):
        self.processor = processor
        self.default_company = default_company
        self.schema = schema
        self.history_path = Path(history_path) if history_path else None
        self.max_history = max_history
        self.history: List[Dict] = []

    def _ensure_company(self, question: str) -> str:
        """Prefix the default company when the question names none
        (reference src/val_online.py company auto-prefix behavior)."""
        if self.processor._extract_companies(question):
            return question
        return f"{self.default_company}{question}"

    def ask(self, question: str, use_history: bool = True) -> Dict:
        q = self._ensure_company(question)
        companies = self.processor._extract_companies(q)
        if not companies:
            raise ValueError(
                f"default company {self.default_company!r} is not in the "
                f"corpus company list {self.processor.engine.meta.companies}"
            )
        company = companies[0]
        answer = self.processor.get_answer_for_company(
            company,
            q,
            self.schema,
            conversation_history=self.history[-self.max_history:] if use_history else None,
        )
        self.history.append({
            "question": question,
            "answer": str(answer.get("final_answer")),
            "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        })
        self._save_history()
        return answer

    def _save_history(self) -> None:
        if self.history_path:
            self.history_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.history_path, "w", encoding="utf-8") as f:
                json.dump(self.history, f, ensure_ascii=False, indent=2)

    def run_batch(self, questions: List[Dict], output_path: Optional[Path] = None) -> Dict:
        """Batch QA over [{"question", "standard_answer"?}] records."""
        records = []
        for qd in questions:
            q = qd.get("question", "")
            if not q.strip():
                records.append({"question": q, "error": "empty question"})
                continue
            try:
                ans = self.ask(q, use_history=False)
                records.append({
                    "question": q,
                    "rag_answer": str(ans.get("final_answer")),
                    "standard_answer": qd.get("standard_answer", ""),
                    "relevant_pages": ans.get("relevant_pages", []),
                })
            except Exception as e:
                records.append({"question": q, "error": str(e)})
            if output_path:
                Path(output_path).parent.mkdir(parents=True, exist_ok=True)
                with open(output_path, "w", encoding="utf-8") as f:
                    json.dump(records, f, ensure_ascii=False, indent=2)
        return {"records": records, "total": len(records),
                "errors": sum(1 for r in records if "error" in r)}

    def repl(self) -> None:  # pragma: no cover - interactive
        print(f"ValOnline REPL — default company {self.default_company}; 'exit' to quit")
        while True:
            try:
                q = input("问题> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not q or q.lower() in ("exit", "quit"):
                break
            try:
                ans = self.ask(q)
                print(f"答案: {ans.get('final_answer')}")
                print(f"依据页: {ans.get('relevant_pages')}")
            except Exception as e:
                print(f"错误: {e}")
