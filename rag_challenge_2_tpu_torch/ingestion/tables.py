"""LLM table serialization.

Re-implements the reference ``TableSerializer``
(reference src/tables_serialization.py): each HTML/markdown table is
rewritten by an LLM into context-independent "information blocks"
(structured output, temperature 0 — :106-134); the prompt context is the
text between the neighbouring tables plus up to 3 blocks after (:50-104);
files process concurrently in a thread pool (:263-310).

The reference drives an aiohttp token-bucket engine for this
(src/api_request_parallel_processor.py); here concurrency is a thread pool
over the provider interface — the provider itself may batch/async
internally.

Port of ``rag_challenge_2_tpu/ingestion/tables.py`` (host code:
a copy with the imports pointed at the port).
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

from ..llm import prompts
from ..llm.providers import ChatProvider


class TableSerializer:
    def __init__(
        self,
        provider: ChatProvider,
        model: Optional[str] = None,
        max_workers: int = 4,
        context_blocks_after: int = 3,
    ):
        self.provider = provider
        self.model = model
        self.max_workers = max_workers
        self.context_blocks_after = context_blocks_after

    # ---------------------------------------------------------------- ctx
    def _context_for_table(self, report: Dict, table: Dict) -> str:
        """Text blocks between the previous table's page position and this
        table, plus ≤N blocks after (reference :50-104, simplified to page
        granularity of the parsed-report contract)."""
        page_no = table.get("page")
        parts: List[str] = []
        for page in report.get("content", []):
            if page.get("page") != page_no:
                continue
            blocks = page.get("content", [])
            # blocks before the table on the page
            before: List[str] = []
            after: List[str] = []
            seen_table = False
            for b in blocks:
                if b.get("type") == "table" and b.get("table_id") == table.get("table_id"):
                    seen_table = True
                    continue
                text = b.get("text", "").strip()
                if not text:
                    continue
                (after if seen_table else before).append(text)
            parts.extend(before[-3:])
            parts.extend(after[: self.context_blocks_after])
        return "\n".join(parts)

    # ------------------------------------------------------------- per-file
    def serialize_table(self, report: Dict, table: Dict) -> Dict:
        tp = prompts.TableSerializationPrompt
        content = table.get("html") or table.get("markdown", "")
        result = self.provider.send_message(
            model=self.model,
            temperature=0.0,
            system_content=tp.system_prompt,
            human_content=tp.user_prompt.format(
                context=self._context_for_table(report, table), table=content
            ),
            is_structured=True,
            response_format=tp.TableBlocksCollection,
        )
        return result

    def process_file(self, path: Path, output_dir: Path) -> None:
        with open(path, "r", encoding="utf-8") as f:
            report = json.load(f)
        for table in report.get("tables", []):
            try:
                report_serialized = self.serialize_table(report, table)
                table["serialized"] = report_serialized
            except Exception as e:
                table["serialization_error"] = str(e)
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(Path(output_dir) / Path(path).name, "w", encoding="utf-8") as f:
            json.dump(report, f, ensure_ascii=False, indent=2)

    def process_directory_parallel(self, reports_dir: Path, output_dir: Path) -> None:
        paths = sorted(Path(reports_dir).glob("*.json"))
        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            list(ex.map(lambda p: self.process_file(p, Path(output_dir)), paths))
