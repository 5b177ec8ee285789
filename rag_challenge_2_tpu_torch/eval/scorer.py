"""Competition scorer.

Deterministic re-implementation of the reference's ``rank.py``: per-schema
value comparison (number = 1% relative tolerance :92-96, boolean/name =
case-insensitive equality :99-110, names = Jaccard :112-124), reference
scoring (start 1.0, −0.1 per out-of-pool citation, −0.25 per missed proof
pool, floored at 0 — :166-189), total = value + ref/2 (:194), first-60
question slice (:143).

Port of ``rag_challenge_2_tpu/eval/scorer.py`` (pure host code, unchanged).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Literal, Optional, Union

from pydantic import BaseModel, Field, RootModel

Value = Union[float, int, str, bool, List[str], None]
Schema = Literal["number", "name", "boolean", "names"]


class SourceReference(BaseModel):
    pdf_sha1: str
    page_index: int  # zero-based


class Answer(BaseModel):
    question_text: Optional[str] = None
    kind: Optional[str] = None
    value: Value = None
    references: List[SourceReference] = []


class AnswerSubmission(BaseModel):
    answers: List[Answer]
    team_email: str = ""
    submission_name: str = ""
    signature: str = ""
    file_name: str = ""
    time: str = ""


class CanonicData(BaseModel):
    kind: Schema
    answers: List[str]
    reference_pools: List[List[str]] = Field(default_factory=list)


class CanonicFile(RootModel):
    root: Dict[str, CanonicData]


def compare(schema: str, actual: str, predicted: Value) -> float:
    """Value score for one (gold, predicted) pair (reference rank.py:78-127)."""
    if predicted == "N/A" and actual == "N/A":
        return 1.0
    if actual == "N/A" or predicted == "N/A" or predicted is None:
        return 0.0

    if schema == "number":
        try:
            a = float(actual)
            p = float(predicted)
        except (TypeError, ValueError):
            return 0.0
        # Deliberate deviation from reference rank.py:93, which compares
        # against an unsigned `0.01 * actual`: for negative gold values
        # (losses, negative growth) the reference tolerance is negative and
        # the answer always scores 0.  We use abs(actual) so negatives get
        # the same 1% relative band, and an absolute epsilon so an exact
        # match on actual == 0 scores 1.0.  Rankings on corpora containing
        # negative gold numbers can therefore differ from the official
        # contest scorer (which shares the reference's defect).
        return 1.0 if abs(p - a) < max(0.01 * abs(a), 1e-9) else 0.0

    if schema == "boolean":
        return 1.0 if str(actual).lower() == str(predicted).lower() else 0.0

    if schema == "name":
        return 1.0 if str(actual).strip().lower() == str(predicted).strip().lower() else 0.0

    if schema == "names":
        if isinstance(predicted, str):
            predicted = [p.strip() for p in predicted.split(",")]
        actual_names = {s.strip() for s in str(actual).strip().lower().split(",")}
        predicted_names = {str(p).strip().lower() for p in predicted}
        union = actual_names | predicted_names
        return len(actual_names & predicted_names) / len(union) if union else 0.0

    raise ValueError(f"Unknown schema {schema}")


def reference_score(
    predicted_refs: List[str], reference_pools: List[List[str]]
) -> float:
    """1.0 − 0.1·(out-of-pool refs) − 0.25·(missed pools), floored at 0
    (reference rank.py:166-189).  Refs are "sha1:page" strings."""
    if not reference_pools and not predicted_refs:
        return 1.0
    expected = {r for pool in reference_pools for r in pool}
    score = 1.0
    for p in predicted_refs:
        if p not in expected:
            score -= 0.1
    for pool in reference_pools:
        if not set(predicted_refs) & set(pool):
            score -= 0.25
    return max(0.0, score)


@dataclasses.dataclass
class SubmissionScore:
    submission_name: str
    file_name: str
    val_score: float
    ref_score: float
    score: float
    missing: int
    no_rank: int
    n_scored: int

    @property
    def val_accuracy(self) -> float:
        return 100.0 * self.val_score / max(1, self.n_scored)


def score_submission(
    submission: AnswerSubmission,
    canonic: Dict[str, CanonicData],
    max_questions: int = 60,
) -> SubmissionScore:
    index = {a.question_text: a for a in submission.answers}
    val = ref = 0.0
    missing = no_rank = scored = 0
    for q, data in list(canonic.items())[:max_questions]:
        predicted = index.get(q)
        if predicted is None:
            missing += 1
            continue
        if not data.answers:
            no_rank += 1
            continue
        scored += 1
        val += max(compare(data.kind, a, predicted.value) for a in data.answers)
        predicted_refs = [f"{r.pdf_sha1}:{r.page_index}" for r in predicted.references]
        ref += reference_score(predicted_refs, data.reference_pools)
    return SubmissionScore(
        submission_name=submission.submission_name,
        file_name=submission.file_name,
        val_score=val,
        ref_score=ref,
        score=val + ref / 2.0,
        missing=missing,
        no_rank=no_rank,
        n_scored=scored,
    )


def rank_submissions(
    submissions_dir: Path,
    answers_path: Path,
    max_questions: int = 60,
    csv_out: Optional[Path] = None,
) -> List[SubmissionScore]:
    """Score every submission file and print a ranking table
    (reference rank.py:215-255)."""
    canonic = CanonicFile.model_validate_json(
        Path(answers_path).read_text(encoding="utf-8")
    ).root
    scores = []
    for f in sorted(Path(submissions_dir).glob("*.json")):
        sub = AnswerSubmission.model_validate_json(f.read_text(encoding="utf-8"))
        sub.file_name = f.name
        scores.append(score_submission(sub, canonic, max_questions))
    scores.sort(key=lambda s: s.score, reverse=True)

    try:
        from rich.console import Console
        from rich.table import Table

        table = Table(title="Ranking", row_styles=["dim", ""])
        for col in ("Rank", "Submission", "R", "G", "Score", "Acc%"):
            table.add_column(col)
        for i, s in enumerate(scores):
            table.add_row(
                str(i + 1), s.submission_name, f"{s.ref_score:.1f}",
                f"{s.val_score:.1f}", f"{s.score:.1f}", f"{s.val_accuracy:.1f}",
            )
        Console(width=120).print(table)
    except ImportError:
        pass

    if csv_out:
        import pandas as pd

        pd.DataFrame([dataclasses.asdict(s) for s in scores]).to_csv(csv_out, index=False)
    return scores
