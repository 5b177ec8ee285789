"""Analysis and evaluation tools: the chunk-to-chunk similarity matrix,
the LLM judge and the submission scorer."""

from .judge import JudgeHarness, summarize
from .scorer import (
    Answer,
    AnswerSubmission,
    CanonicData,
    compare,
    rank_submissions,
    reference_score,
    score_submission,
)
