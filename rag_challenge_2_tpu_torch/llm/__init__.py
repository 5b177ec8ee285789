"""The LLM layer: prompts, schemas, chat providers (with the offline
stub), the answering facade and the reranker.  Port of
``rag_challenge_2_tpu/llm``: pure host code, the same exports."""

from . import prompts, schemas
from .facade import LLMFacade
from .glossary import FINANCIAL_GLOSSARY, find_financial_concepts, format_glossary_context
from .jsonfix import loads_lenient
from .providers import (
    ChatProvider,
    GeminiProvider,
    OpenAICompatProvider,
    StubProvider,
    get_provider,
)
from .reranker import JinaReranker, LLMReranker, RateLimiter
