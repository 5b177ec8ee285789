"""Question answering over the port's QueryEngine (port of
``rag_challenge_2_tpu/qa``)."""

from .processor import QAConfig, QuestionsProcessor
from .val_online import ValOnline
