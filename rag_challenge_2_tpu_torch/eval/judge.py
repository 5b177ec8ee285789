"""LLM-as-judge evaluation harness.

The reference's val-set path: judge every (question, standard answer, RAG
answer) with type-specific rubrics (reference src/api_requests.py:697-750,
rubrics src/prompts.py:873-1096), persist results, and repair records whose
judgment failed (reference scripts/fix_evaluation_results.py:26-60 re-runs
the judge for empty/failed reasoning, backing up the file first).

Port of ``rag_challenge_2_tpu/eval/judge.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..llm.facade import LLMFacade


def _is_failed(record: Dict) -> bool:
    ev = record.get("evaluation") or {}
    reasoning = (ev.get("reasoning") or "").strip()
    return (
        not ev
        or not reasoning
        or reasoning.startswith("rerank failed")
        or "error" in record
        and not ev
    )


def summarize(records: List[Dict]) -> Dict:
    evs = [r.get("evaluation") or {} for r in records]
    scores = [e.get("score", 0.0) for e in evs]
    correct = sum(1 for e in evs if e.get("is_correct"))
    return {
        "total": len(records),
        "correct": correct,
        "accuracy": round(correct / len(records), 4) if records else 0.0,
        "avg_score": round(sum(scores) / len(scores), 4) if scores else 0.0,
        "failed_judgments": sum(1 for r in records if _is_failed(r)),
    }


class JudgeHarness:
    def __init__(self, llm: LLMFacade, model: Optional[str] = None):
        self.llm = llm
        self.model = model

    def judge_one(self, question: str, standard_answer: str, rag_answer: str) -> Dict:
        return self.llm.evaluate_answer(
            question, standard_answer, rag_answer, model=self.model
        )

    def judge_all(
        self,
        qa_records: List[Dict],
        output_path: Optional[Path] = None,
    ) -> Dict:
        """qa_records: [{"question", "standard_answer", "rag_answer"}, ...]
        → {"records": [... + evaluation], "statistics": {...}}."""
        out = []
        for rec in qa_records:
            record = dict(rec)
            try:
                record["evaluation"] = self.judge_one(
                    rec.get("question", ""),
                    str(rec.get("standard_answer", "")),
                    str(rec.get("rag_answer", "")),
                )
            except Exception as e:
                record["evaluation"] = {}
                record["error"] = str(e)
            out.append(record)
            if output_path:  # incremental, like the reference's batch saves
                self._write(out, output_path)
        result = {"records": out, "statistics": summarize(out)}
        if output_path:
            self._write(out, output_path)
        return result

    @staticmethod
    def _write(records: List[Dict], path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {"records": records, "statistics": summarize(records)},
                f, ensure_ascii=False, indent=2,
            )

    def fix_evaluation_results(self, results_path: Path) -> Dict:
        """Re-judge failed records in-place, with a timestamped backup
        (contract of reference scripts/fix_evaluation_results.py:26-60)."""
        results_path = Path(results_path)
        with open(results_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        records = data if isinstance(data, list) else data.get("records", [])
        backup = results_path.with_name(
            results_path.stem + f".bak-{int(time.time())}" + results_path.suffix
        )
        shutil.copy(results_path, backup)
        fixed = 0
        for rec in records:
            if not _is_failed(rec):
                continue
            try:
                rec["evaluation"] = self.judge_one(
                    rec.get("question", ""),
                    str(rec.get("standard_answer", "")),
                    str(rec.get("rag_answer", "")),
                )
                rec.pop("error", None)
                fixed += 1
            except Exception as e:
                rec["error"] = str(e)
        self._write(records, results_path)
        return {"fixed": fixed, "backup": str(backup), "statistics": summarize(records)}
