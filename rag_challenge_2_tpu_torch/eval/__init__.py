"""Analysis and evaluation tools: the chunk-to-chunk similarity matrix,
the LLM judge, the submission scorer and (``eval.e2e``) the end-to-end
eval over a PDF fixture."""

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
