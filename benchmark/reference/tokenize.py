"""Query text to hashed BM25 term ids.

NFKC-normalised, lower-cased text; each run of CJK characters gives its
character unigrams and then its bigrams, each run of latin letters or
digits (with one optional decimal part) one word; every token is hashed
with 64-bit FNV-1a over its UTF-8 bytes and folded into ``2**vocab_bits``
slots.  A query keeps its first ``max_terms`` ids, -1 padded.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Sequence

import numpy as np

_TOKEN = re.compile(r"([㐀-䶿一-鿿豈-﫿]+)|([a-z0-9]+(?:\.[0-9]+)?)")
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def tokens(text: str) -> List[str]:
    out: List[str] = []
    for cjk, word in _TOKEN.findall(unicodedata.normalize("NFKC", text).lower()):
        if word:
            out.append(word)
        else:
            out.extend(cjk)
            out.extend(cjk[i:i + 2] for i in range(len(cjk) - 1))
    return out


def term_id(token: str, vocab_bits: int) -> int:
    h = _FNV_OFFSET
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h & ((1 << vocab_bits) - 1)


def term_ids(texts: Sequence[str], vocab_bits: int, max_terms: int = 64) -> np.ndarray:
    """``[len(texts), max_terms]`` int64 ids, -1 padded."""
    out = np.full((len(texts), max_terms), -1, np.int64)
    for i, text in enumerate(texts):
        ids = [term_id(t, vocab_bits) for t in tokens(text)][:max_terms]
        out[i, :len(ids)] = ids
    return out
