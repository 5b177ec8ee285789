"""Parsed-report → per-page markdown merging.

Re-implements the reference's ``PageTextPreparation``
(reference src/parsed_reports_merging.py): drop page_footer/picture blocks
(:107-116), clean PDF-glyph artifacts (:118-179), apply header/paragraph/
table/list/footnote grouping rules (:189-327), optionally substitute
serialized tables (:382-412), and export markdown files (:414-436).

Input contract: parsed-report JSON with ``content`` = list of pages, each
``{"page": n, "content": [blocks]}``; a block is ``{"type", "text",
"table_id"?}``.  Output: ``content.pages = [{"page", "text"}]`` — the
format the splitter and index builder consume.

Port of ``rag_challenge_2_tpu/ingestion/merging.py`` (host code:
a copy with the imports pointed at the port).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

_IGNORED_TYPES = {"page_footer", "picture"}
_PLAIN_TYPES = {
    "text", "caption", "footnote", "checkbox_selected",
    "checkbox_unselected", "formula",
}
_COLON_TYPES = {"text", "caption", "section_header", "paragraph"}

# PDF glyph-command artifacts (docling output of embedded Type1 fonts)
_CMD_MAP = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "period": ".", "comma": ",", "colon": ":", "hyphen": "-",
    "percent": "%", "dollar": "$", "space": " ", "plus": "+",
    "minus": "-", "slash": "/", "asterisk": "*", "lparen": "(",
    "rparen": ")", "parenright": ")", "parenleft": "(", "wedge.1_E": "",
}
_CMD_RE = re.compile(
    rf"/({'|'.join(map(re.escape, _CMD_MAP))})"
    r"(\.pl\.tnum|\.tnum\.pl|\.pl|\.tnum|\.case|\.sups)"
)
_GLYPH_RE = re.compile(r"glyph<[^>]*>")
_CAP_RE = re.compile(r"/([A-Z])\.cap")


def clean_text(text: str) -> Tuple[str, int]:
    """Strip glyph artifacts; returns (clean text, #corrections)."""
    count = len(_CMD_RE.findall(text)) + len(_GLYPH_RE.findall(text)) + len(_CAP_RE.findall(text))
    text = _CMD_RE.sub(lambda m: _CMD_MAP[m.group(1)], text)
    text = _GLYPH_RE.sub("", text)
    text = _CAP_RE.sub(lambda m: m.group(1), text)
    return text, count


def _ends_with_colon(block: Dict) -> bool:
    return (
        block.get("type") in _COLON_TYPES
        and block.get("text", "").rstrip().endswith((":", "："))
    )


class PageTextPreparation:
    def __init__(
        self,
        use_serialized_tables: bool = False,
        serialized_tables_instead_of_markdown: bool = False,
    ):
        self.use_serialized_tables = use_serialized_tables
        self.serialized_instead = serialized_tables_instead_of_markdown

    # ---------------------------------------------------------------- API
    def process_reports(self, reports_dir: Path, output_dir: Path) -> None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for path in sorted(Path(reports_dir).glob("*.json")):
            with open(path, "r", encoding="utf-8") as f:
                report = json.load(f)
            merged = self.process_report(report)
            with open(output_dir / path.name, "w", encoding="utf-8") as f:
                json.dump(merged, f, ensure_ascii=False, indent=2)

    def process_report(self, report: Dict) -> Dict:
        """Parsed report → ``{"metainfo", "content": {"pages": [...]}}``."""
        self._tables = {t.get("table_id"): t for t in report.get("tables", [])}
        pages_out = []
        for page in report.get("content", []):
            text = self._prepare_page_text(page)
            pages_out.append({"page": page.get("page"), "text": text})
        return {
            "metainfo": report.get("metainfo", {}),
            "content": {"pages": pages_out},
        }

    def export_to_markdown(self, reports_dir: Path, output_dir: Path) -> None:
        """Merged reports → one .md per document (reference :414-436)."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for path in sorted(Path(reports_dir).glob("*.json")):
            with open(path, "r", encoding="utf-8") as f:
                report = json.load(f)
            pages = report.get("content", {}).get("pages", [])
            body = "\n\n---\n\n".join(p.get("text", "") for p in pages)
            sha1 = report.get("metainfo", {}).get("sha1_name", path.stem)
            (output_dir / f"{sha1}.md").write_text(body, encoding="utf-8")

    # ------------------------------------------------------------ internals
    def _prepare_page_text(self, page: Dict) -> str:
        blocks = [b for b in page.get("content", []) if b.get("type") not in _IGNORED_TYPES]
        final = self._apply_rules(blocks)
        if final:
            final[0] = final[0].lstrip()
            final[-1] = final[-1].rstrip()
        return "\n".join(final)

    def _table_text(self, table_id) -> str:
        table = self._tables.get(table_id)
        if table is None:
            return ""
        if self.use_serialized_tables and "serialized" in table:
            serialized = "\n".join(
                b.get("information_block", "")
                for b in table["serialized"].get("information_blocks", [])
            )
            if self.serialized_instead:
                return serialized
            return f"{table.get('markdown', '')}\n{serialized}".strip()
        return table.get("markdown", table.get("html", ""))

    def _apply_rules(self, blocks: List[Dict]) -> List[str]:
        """Header levels, table/list grouping with trailing footnotes —
        the rule set of reference :189-327."""
        page_header_early = any(b.get("type") == "page_header" for b in blocks[:3])
        section_header_seen = 0
        out: List[str] = []
        i, n = 0, len(blocks)

        def cleaned(b) -> str:
            return clean_text(b.get("text", "").strip())[0]

        while i < n:
            b = blocks[i]
            btype = b.get("type")
            text = cleaned(b)

            if btype == "page_header":
                out.append(("\n# " if i < 3 else "\n## ") + text + "\n")
                i += 1
            elif btype == "section_header":
                section_header_seen += 1
                top = section_header_seen == 1 and i < 3 and not page_header_early
                out.append(("\n# " if top else "\n## ") + text + "\n")
                i += 1
            elif btype == "paragraph" and not (
                _ends_with_colon(b) and i + 1 < n
                and blocks[i + 1].get("type") in ("table", "list_item")
            ):
                out.append(f"\n### {text}\n")
                i += 1
            elif btype == "table" or (
                _ends_with_colon(b) and i + 1 < n and blocks[i + 1].get("type") == "table"
            ):
                group = []
                if btype != "table":
                    group.append(f"\n### {text}\n")
                    i += 1
                table_block = blocks[i]
                group.append(self._table_text(table_block.get("table_id")) + "\n")
                i += 1
                i = self._absorb_footnotes(blocks, i, n, group, cleaned)
                out.append("".join(group))
            elif btype == "list_item" or (
                _ends_with_colon(b) and i + 1 < n and blocks[i + 1].get("type") == "list_item"
            ):
                group = []
                if btype != "list_item":
                    group.append(f"{text}\n")
                    i += 1
                while i < n and blocks[i].get("type") == "list_item":
                    group.append(f"- {cleaned(blocks[i])}\n")
                    i += 1
                i = self._absorb_footnotes(blocks, i, n, group, cleaned)
                out.append("".join(group))
            elif btype in _PLAIN_TYPES:
                if text:
                    out.append(f"{text}\n")
                i += 1
            else:
                # docling's label vocabulary is open (title, code,
                # document_index, reference, chart, …) — degrade unknown
                # labels to plain text instead of killing the merge stage
                if text:
                    out.append(f"{text}\n")
                i += 1
        return out

    @staticmethod
    def _absorb_footnotes(blocks, i, n, group, cleaned) -> int:
        """A text block immediately before footnotes, plus the footnote run,
        belongs to the preceding table/list group (reference :262-276)."""
        if (
            i < n and blocks[i].get("type") == "text"
            and i + 1 < n and blocks[i + 1].get("type") == "footnote"
        ):
            group.append(f"{cleaned(blocks[i])}\n")
            i += 1
        while i < n and blocks[i].get("type") == "footnote":
            group.append(f"{cleaned(blocks[i])}\n")
            i += 1
        return i
