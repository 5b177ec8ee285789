"""Chinese-aware tokenisation for the sparse (BM25) path.

The reference tokenises with ``chunk.split()`` (reference src/ingestion.py:21,
src/retrieval.py:261-262) which is a no-op for Chinese text — SURVEY.md §7
flags this as a known weakness.  We tokenise properly:

  * text is NFKC-normalised and lower-cased,
  * CJK runs produce character unigrams AND bigrams (the standard
    segmentation-free recipe for Chinese retrieval),
  * latin / digit runs produce whole-word tokens,
  * tokens are hashed into a fixed power-of-two vocabulary so the device
    index has a static vocab dimension (feature hashing — no host-side
    vocab dictionary required, any corpus maps into the same space).

Everything here is host-side build/query-encode code; the resulting id
arrays feed the CSR BM25 path in ops/bm25.py.

A host copy of ``rag_challenge_2_tpu/utils/tokenize.py``: that package's
``utils/__init__`` imports jax, which the machine with the card does not
have.  tests/test_torch_imports.py holds the ids and TOKENIZER_VERSION
equal to the original.
"""

from __future__ import annotations


import re
import unicodedata
from typing import List

# CJK Unified Ideographs + extension A + compatibility; enough for financial text.
_CJK = (
    "㐀-䶿"
    "一-鿿"
    "豈-﫿"
)
_TOKEN_RE = re.compile(rf"([{_CJK}]+)|([a-z0-9]+(?:\.[0-9]+)?)")

DEFAULT_VOCAB_BITS = 20  # 1M-slot hashed vocabulary

# Bump whenever tokenization or hashing changes: indexes stamp this and the
# loader warns on mismatch — a stale index silently mismatches query-time
# term ids otherwise (hits vanish instead of erroring).
TOKENIZER_VERSION = "fnv1a64-cjk12-v1"


def normalize(text: str) -> str:
    """NFKC-fold (full-width → half-width, etc.) and lower-case."""
    return unicodedata.normalize("NFKC", text).lower()


def tokenize(text: str) -> List[str]:
    """Split into CJK char uni+bigrams and latin/number words."""
    out: List[str] = []
    for cjk, word in _TOKEN_RE.findall(normalize(text)):
        if word:
            out.append(word)
        elif cjk:
            out.extend(cjk)  # unigrams
            out.extend(cjk[i : i + 2] for i in range(len(cjk) - 1))  # bigrams
    return out


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def hash_token(token: str, vocab_bits: int = DEFAULT_VOCAB_BITS) -> int:
    """FNV-1a 64 folded into the vocab size.

    Stable across processes/machines (unlike Python's ``hash``) and trivially
    reproducible in the C++ CSR builder (native/csr_builder.cpp) — both
    sides MUST produce identical ids for the same token.
    """
    h = _FNV_OFFSET
    for b in token.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h & ((1 << vocab_bits) - 1)


def token_ids(text: str, vocab_bits: int = DEFAULT_VOCAB_BITS) -> List[int]:
    return [hash_token(t, vocab_bits) for t in tokenize(text)]
