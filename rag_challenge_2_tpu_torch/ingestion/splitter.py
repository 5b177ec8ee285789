"""Token-budgeted recursive text splitting.

Replaces the reference's langchain
``RecursiveCharacterTextSplitter.from_tiktoken_encoder(model_name="gpt-4o",
chunk_size=300, chunk_overlap=50)`` (reference src/text_splitter.py:70-85)
with a self-contained implementation of the same recursive-separator
algorithm, measured in tiktoken ``o200k_base`` tokens (the gpt-4o
encoding), with CJK-aware separators.  Serialized-table chunks are
appended after each page's content chunks with ``type:
"serialized_table"`` (reference :33-60).

Port of ``rag_challenge_2_tpu/ingestion/splitter.py`` (host code: a copy
whose tiktoken never downloads, see :func:`_encoding`).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

_SEPARATORS = ["\n\n", "\n", "。", "；", "！", "？", ". ", " ", ""]

_enc = None
_enc_failed = False

_CJK_RE = None


# tiktoken's o200k_base BPE file: where tiktoken fetches it from (its cache
# key is the SHA-1 of this URL) and the SHA-256 it must have
_BPE_URL = "https://openaipublic.blob.core.windows.net/encodings/o200k_base.tiktoken"
_BPE_SHA256 = "446a9538cb6c348e3516120d7c08b09f57c36495e2acfffe59a5bf8b0cfb1a2d"


def _bpe_cached() -> bool:
    """Whether the BPE file lies, intact, in the cache directory the
    environment names (``TIKTOKEN_CACHE_DIR`` or ``DATA_GYM_CACHE_DIR``)."""
    cache_dir = (os.environ.get("TIKTOKEN_CACHE_DIR")
                 or os.environ.get("DATA_GYM_CACHE_DIR"))
    if not cache_dir:
        return False
    path = Path(cache_dir) / hashlib.sha1(_BPE_URL.encode()).hexdigest()
    try:
        return hashlib.sha256(path.read_bytes()).hexdigest() == _BPE_SHA256
    except OSError:
        return False


def _encoding():
    """tiktoken o200k_base when its BPE file is in the named cache; None
    otherwise.  Unlike the JAX package's splitter this never lets tiktoken
    download the file: the port runs on machines without a network."""
    global _enc, _enc_failed
    if _enc is None and not _enc_failed:
        try:
            if not _bpe_cached():
                raise FileNotFoundError(_BPE_URL)
            import tiktoken

            _enc = tiktoken.get_encoding("o200k_base")
        except (ImportError, OSError, ValueError):
            _enc_failed = True
    return _enc


def _heuristic_tokens(text: str) -> int:
    """Offline estimate calibrated to o200k: ~1 token per CJK char,
    ~4 non-CJK chars per token."""
    global _CJK_RE
    if _CJK_RE is None:
        import re

        _CJK_RE = re.compile(r"[㐀-鿿豈-﫿]")
    cjk = len(_CJK_RE.findall(text))
    other = len(text) - cjk
    return cjk + (other + 3) // 4


def count_tokens(text: str) -> int:
    enc = _encoding()
    if enc is not None:
        return len(enc.encode(text))
    return _heuristic_tokens(text)


def _split_on(text: str, sep: str) -> List[str]:
    if sep == "":
        return list(text)
    parts = text.split(sep)
    # keep the separator attached to the preceding part
    return [p + sep for p in parts[:-1]] + ([parts[-1]] if parts[-1] else [])


def _recursive_split(text: str, chunk_size: int, separators: List[str]) -> List[str]:
    """Pieces each ≤ chunk_size tokens, splitting on the coarsest separator
    that works and recursing on oversized pieces."""
    if count_tokens(text) <= chunk_size:
        return [text]
    sep, rest = separators[0], separators[1:]
    pieces = _split_on(text, sep)
    if len(pieces) <= 1 and rest:
        return _recursive_split(text, chunk_size, rest)
    out: List[str] = []
    for p in pieces:
        if count_tokens(p) > chunk_size and rest:
            out.extend(_recursive_split(p, chunk_size, rest))
        else:
            out.append(p)
    return out


def split_text(text: str, chunk_size: int = 300, chunk_overlap: int = 50) -> List[str]:
    """Greedy merge of recursive pieces into ≤chunk_size-token chunks with
    ≤chunk_overlap tokens of trailing context carried over."""
    if not text.strip():
        return []
    pieces = _recursive_split(text, chunk_size, _SEPARATORS)
    chunks: List[str] = []
    cur: List[str] = []
    cur_tokens = 0
    for p in pieces:
        t = count_tokens(p)
        if cur and cur_tokens + t > chunk_size:
            chunks.append("".join(cur).strip())
            # build overlap from the tail of the current chunk
            tail: List[str] = []
            tail_tokens = 0
            for q in reversed(cur):
                qt = count_tokens(q)
                if tail_tokens + qt > chunk_overlap:
                    break
                tail.insert(0, q)
                tail_tokens += qt
            cur, cur_tokens = tail, tail_tokens
        cur.append(p)
        cur_tokens += t
    if cur and "".join(cur).strip():
        chunks.append("".join(cur).strip())
    return [c for c in chunks if c]


class TextSplitter:
    """Per-report chunking with optional serialized-table chunks
    (contract of reference src/text_splitter.py)."""

    def __init__(self, chunk_size: int = 300, chunk_overlap: int = 50):
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap

    def count_tokens(self, text: str) -> int:
        return count_tokens(text)

    def _serialized_tables_by_page(self, parsed_report: Dict) -> Dict[int, List[Dict]]:
        by_page: Dict[int, List[Dict]] = {}
        for table in parsed_report.get("tables", []):
            if "serialized" not in table:
                continue
            text = "\n".join(
                b.get("information_block", "")
                for b in table["serialized"].get("information_blocks", [])
            )
            by_page.setdefault(table["page"], []).append({
                "page": table["page"],
                "text": text,
                "table_id": table.get("table_id"),
                "length_tokens": count_tokens(text),
            })
        return by_page

    def split_report(
        self, report: Dict, serialized_report: Optional[Dict] = None
    ) -> Dict:
        """Adds ``content.chunks`` in place and returns the report."""
        tables_by_page = (
            self._serialized_tables_by_page(serialized_report)
            if serialized_report is not None
            else {}
        )
        chunks: List[Dict] = []
        cid = 0
        for page in report["content"]["pages"]:
            for text in split_text(page["text"], self.chunk_size, self.chunk_overlap):
                chunks.append({
                    "page": page["page"],
                    "length_tokens": count_tokens(text),
                    "text": text,
                    "id": cid,
                    "type": "content",
                })
                cid += 1
            for table in tables_by_page.get(page["page"], []):
                chunks.append({**table, "id": cid, "type": "serialized_table"})
                cid += 1
        report["content"]["chunks"] = chunks
        return report

    def split_all_reports(
        self,
        all_report_dir: Path,
        output_dir: Path,
        serialized_tables_dir: Optional[Path] = None,
    ) -> None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for path in sorted(Path(all_report_dir).glob("*.json")):
            with open(path, "r", encoding="utf-8") as f:
                report = json.load(f)
            serialized = None
            if serialized_tables_dir is not None:
                sp = Path(serialized_tables_dir) / path.name
                if sp.exists():
                    with open(sp, "r", encoding="utf-8") as f:
                        serialized = json.load(f)
            updated = self.split_report(report, serialized)
            with open(output_dir / path.name, "w", encoding="utf-8") as f:
                json.dump(updated, f, ensure_ascii=False, indent=2)
